"""The transformer cell (tfm.stream.bf16) on the CPU at small sizes: its
fp8 control is not correct, a sound run is, a broken transformer path is
not, the work counts are the hand counts, the all-batch readings of
benchmark/calibrate.py (the transformer's and, over four CPU devices, the
runner's fan-out of cell 1), and no module of the cell loads JAX or the
JAX package."""

from __future__ import annotations

import ast
import json
from unittest import mock

import pytest
import torch

from benchmark import calibrate, control, run, spec

TFM_CONTROL = {"rows_per_device": 256, "pool": 2}
TFM_TINY = {"rows_per_device": 16, "pool": 2}


def _run(capsys, cell, traffic, devices=1, seed=2 ** 31 + 5):
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "0", "--trace", "0"], device=["cpu"] * devices,
                    traffic=traffic) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_fp8_control_is_not_correct():
    loaded = spec.load_cell("tfm.stream.bf16")
    loaded.traffic.update(TFM_CONTROL)
    assert loaded.limits["control"] == "fp8_reference"
    numbers = control.reading(loaded, 31, [torch.device("cpu")] *
                              loaded.devices, "fp8_reference", 0)
    limits = loaded.limits["numbers"]
    assert any(numbers[name] > limits[name] for name in numbers
               if name in limits), numbers


def test_a_sound_run_is_correct(capsys):
    result = _run(capsys, "tfm.stream.bf16", TFM_TINY)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"windows_per_s", "setup_s"}


def _heads_permuted():
    from pepper_tpu_torch.ops import attention_kernel

    twin = attention_kernel.window_attention_reference

    def permuted(qkv, heads):
        out = twin(qkv, heads)
        B, T, D = out.shape
        return out.view(B, T, heads, D // heads).flip(2).reshape(B, T, D)

    return mock.patch.object(attention_kernel, "attention", permuted)


def _a_layernorm_skipped():
    """The first encoder layer's first LayerNorm left out (its input passed
    on as it is), the fault a norm fused into the residual add could make.
    On the CPU at 1,024 windows this position read a prob_rms of 9.7e-3 or
    more on each of 14 seeds; a norm left out in a later layer reads less,
    down to 5.7e-3 (PERF.md, Open questions)."""
    from pepper_tpu_torch.models import alternates

    norm = alternates._layernorm
    calls = [0]

    def skipped(x, p, eps=1e-5):
        calls[0] += 1
        return x if calls[0] % 12 == 1 else norm(x, p, eps)

    return mock.patch.object(alternates, "_layernorm", skipped)


def _an_answer_altered():
    from pepper_tpu_torch.infer.runner import InferenceRunner

    gather = InferenceRunner._gather

    def altered(blocks):
        probs = gather(blocks).copy()
        probs[0] = (1.0, 0.0, 0.0)
        return probs

    return mock.patch.object(InferenceRunner, "_gather",
                             staticmethod(altered))


@pytest.mark.parametrize("fault", [_heads_permuted, _a_layernorm_skipped,
                                   _an_answer_altered])
def test_a_broken_transformer_path_is_not_correct(capsys, fault):
    with fault():
        result = _run(capsys, "tfm.stream.bf16",
                      {"rows_per_device": 64, "pool": 1})
    assert result["correct"] is False


def test_work_matches_the_hand_counts():
    config = spec.load_cell("tfm.stream.bf16").config
    work = spec.load_module("work", config["work"])
    assert work.flops_per_item(config) == 189_749_632
    assert work.param_count(config) == 3_284_055
    assert work.attention_flops(config) == 453_024
    assert work.attention_work(config, 4096, 2) == (4096 * 453_024,
                                                    112_459_776)
    reference = spec.load_module("reference", config["reference"])
    drawn = sum(torch.Size(shape).numel() for shape, _
                in reference.param_shapes(config).values())
    # the drawn leaves and the BatchNorm running statistics
    assert drawn + 4 * config["conv_channels"] == work.param_count(config)


@pytest.mark.parametrize("cell,devices", [("tfm.stream.bf16", 1),
                                          ("snp.stream.bf16", 4)])
def test_calibrate_reads_every_pool_batch(cell, devices):
    loaded = spec.load_cell(cell)
    loaded.chips = devices
    loaded.traffic.update(TFM_TINY)
    numbers = calibrate.reading(loaded, 9, [torch.device("cpu")] * devices)
    assert numbers["batches"] == TFM_TINY["pool"]
    assert numbers["failed"] == 0 and numbers["misplaced"] == 0
    assert numbers["prob_gap"] <= loaded.limits["numbers"]["prob_gap"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", [
    "entries/runner_family.py", "reference/pepper_tfm.py",
    "work/pepper_tfm.py", "calibrate.py", "metrics/attention_ms.py",
    "metrics/attention_roofline.py", "metrics/device_spans.py",
    "metrics/tfm_forward_ms.py"])
def test_the_cell_imports_no_jax(path):
    import pathlib

    modules = set(_imports(pathlib.Path(spec.HERE) / path))
    assert not {m.split(".")[0] for m in modules} & {
        "jax", "jaxlib", "flax", "pepper_tpu"}
    if path.startswith("reference"):
        assert not any(m.startswith("pepper_tpu_torch") for m in modules)
