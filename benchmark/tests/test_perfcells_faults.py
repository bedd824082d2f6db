"""`correct` comes out false when it should, on the CPU at tiny sizes:
each cell's control (limits/<cell>.json) fails one of the cell's numbers,
and a run driven with the timed path broken underneath (the harness's
look for a card skipped) reports `correct` false, once for each fault the
cell can have: an answer altered where it is produced, half of the batch
left out, the hidden state returned unchanged (the polish loop), and the
exchange between cards left out (the runner over four devices).  Sound
float32 runs come out correct."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import control, run, spec

SNP_TINY = {"rows_per_device": 16, "pool": 2}
POLISH_TINY = {"rows_per_device": 2, "pool": 2}


def _run(capsys, cell, traffic, seed=5, devices=1):
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "0", "--trace", "0"], device=["cpu"] * devices,
                    traffic=traffic) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["snp.stream.bf16", "snp.stream.f32",
                                  "polish.consensus.f32"])
def test_the_control_is_not_correct(cell):
    loaded = spec.load_cell(cell)
    loaded.traffic.update(SNP_TINY if cell.startswith("snp")
                          else POLISH_TINY)
    numbers = control.reading(loaded, 31, [torch.device("cpu")] *
                              loaded.devices, loaded.limits["control"], 0)
    limits = loaded.limits["numbers"]
    assert any(numbers[name] > limits[name] for name in numbers
               if name in limits), numbers


@pytest.mark.parametrize("cell", ["snp.stream.f32", "polish.consensus.f32"])
def test_a_sound_run_is_correct(capsys, cell):
    traffic = SNP_TINY if cell.startswith("snp") else POLISH_TINY
    assert _run(capsys, cell, traffic)["correct"] is True


def _alter_an_answer(monkeypatch):
    from pepper_tpu_torch.infer.runner import InferenceRunner

    gather = InferenceRunner._gather

    def altered(blocks):
        probs = gather(blocks).copy()
        probs[0] = (1.0, 0.0, 0.0)
        return probs

    monkeypatch.setattr(InferenceRunner, "_gather", staticmethod(altered))


def _leave_half_out(monkeypatch):
    from pepper_tpu_torch.infer.runner import InferenceRunner

    forward = InferenceRunner._forward

    def half(self, padded, tree):
        probs = forward(self, padded[:len(padded) // 2], tree)
        return torch.cat([probs, probs])

    monkeypatch.setattr(InferenceRunner, "_forward", half)


def _leave_the_exchange_out(monkeypatch):
    from pepper_tpu_torch.infer.runner import InferenceRunner

    gather = InferenceRunner._gather

    def first_only(blocks):
        return gather([blocks[0]] * len(blocks))

    monkeypatch.setattr(InferenceRunner, "_gather", staticmethod(first_only))


@pytest.mark.parametrize("cell,devices,fault", [
    ("snp.stream.bf16", 1, _alter_an_answer),
    ("snp.stream.bf16", 1, _leave_half_out),
    ("snp.stream.bf16", 4, _alter_an_answer),
    ("snp.stream.bf16", 4, _leave_half_out),
    ("snp.stream.bf16", 4, _leave_the_exchange_out),
    ("snp.stream.f32", 1, _alter_an_answer),
    ("snp.stream.f32", 1, _leave_half_out),
])
def test_a_broken_snp_path_is_not_correct(capsys, monkeypatch, cell, devices,
                                          fault):
    """devices=4: the runner's fan-out over four devices (the CPU named
    four times), as a four-card cell of this traffic would run it."""
    fault(monkeypatch)
    traffic = dict(SNP_TINY,
                   rows_per_device=SNP_TINY["rows_per_device"] // devices)
    assert _run(capsys, cell, traffic, devices=devices)["correct"] is False


def _state_unchanged(monkeypatch):
    from pepper_tpu_torch.polish import consensus

    for name in ("polish_forward", "polish_forward_fused"):
        forward = getattr(consensus, name)

        def unchanged(params, x, hidden, *args, _forward=forward, **kw):
            logits, _ = _forward(params, x, hidden, *args, **kw)
            return logits, hidden

        monkeypatch.setattr(consensus, name, unchanged)


def _polish_half_out(monkeypatch):
    from pepper_tpu_torch.polish import consensus

    scan = consensus.consensus_scan

    def half(params, images, *args, **kw):
        out = scan(params, images[:len(images) // 2], *args, **kw)
        return tuple(torch.cat([t, t]) for t in out)

    monkeypatch.setattr(consensus, "consensus_scan", half)


def _polish_label_altered(monkeypatch):
    from pepper_tpu_torch.polish import consensus

    labels_and_phred = consensus._labels_and_phred

    def altered(votes):
        votes, labels, phred = labels_and_phred(votes)
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % votes.shape[2]
        return votes, labels, phred

    monkeypatch.setattr(consensus, "_labels_and_phred", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _polish_half_out,
                                   _polish_label_altered])
def test_a_broken_polish_path_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(capsys, "polish.consensus.f32", POLISH_TINY)
    assert result["correct"] is False
    assert np.isfinite(result["checks"]["vote_gap"]["value"])
