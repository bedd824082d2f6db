"""The polisher's served path: `polish/consensus.py:consensus_predict`,
called back to back on batches of the traffic's rows (the polish CLI's
`--batch_size`), a closed loop.  Each call pads and uploads its chunks,
runs the sliding windows with the hidden state carried, and returns the
labels and phred in host memory.

`inputs` makes a pool of distinct uint8 chunk batches on the host from
the seed; set-up makes the float32 weights on the first device from the
seed and calls the entry twice so that every kernel is built and the
serving tree is made.

Inside the window every call's output shapes are checked at once; a
sample of the calls, drawn from the seed, is kept whole.  After the
window the reference recomputes the kept batches' pool entries, and
`compare` holds each kept column's vote fraction (read back from its
phred) and label to the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generate
from benchmark.entries.runner import KEEP_EVERY, Window
from benchmark.spec import load_module

REF_ROWS = 4096         # the reference's block of chunks
WARM_CALLS = 2


class Entry:
    SPANS = ("consensus",)

    def __init__(self, cell, seed: int, devices, variant: str | None = None):
        """variant: the entry has no program variant; its controls are
        references (`reference_produced`)."""
        if variant is not None:
            raise ValueError(f"no variant {variant!r} of consensus_predict")
        self.cell = cell
        self.config = cell.config
        self.seed = seed
        self.devices = devices
        self.rows = cell.traffic["rows_per_device"] * len(devices)
        self.reference = load_module("reference", self.config["reference"])
        self.label_tie = cell.limits["label_tie"]
        self.kept = []

    def _weights(self):
        return generate.make_weights(
            self.reference.param_shapes(self.config), self.seed,
            self.devices[0])

    def inputs(self):
        """The pool of chunk batches, (pool, rows, seq_length, features)."""
        cfg = self.config
        self.images = generate.make_pool(
            cfg, self.rows, self.cell.traffic["pool"],
            (cfg["seq_length"], cfg["image_features"]), self.seed)

    def setup(self):
        from pepper_tpu_torch.polish.consensus import consensus_predict

        self.flags = generate.sample_flags(self.seed, KEEP_EVERY)
        params = self._weights()
        multi = len(self.devices) > 1
        dtype = getattr(torch, self.cell.traffic["compute_dtype"])

        def predict(images):
            return consensus_predict(
                params, images, batch_size=self.rows, compute_dtype=dtype,
                device=self.devices[0],
                devices=list(self.devices) if multi else None)

        self.predict = predict
        self.run(float("inf"), {"consensus": []}, max_batches=WARM_CALLS)
        self.kept = []

    def _consume(self, k, labels, phred) -> int:
        p = k % len(self.images)
        if self.flags[k % len(self.flags)] or k == 0:
            self.kept.append((p, labels, phred))
        want = (self.rows, self.config["seq_length"])
        return 0 if labels.shape == want and phred.shape == want \
            else self.rows

    def run(self, seconds, spans, on_close=None, max_batches=None):
        clock = time.perf_counter
        out = Window()
        start = clock()
        end = start + seconds
        k = 0
        while True:
            t0 = clock()
            labels, phred = self.predict(self.images[k % len(self.images)])
            t1 = clock()
            spans["consensus"].append((t0, t1))
            out.dispatched += 1
            out.attempted += self.rows
            out.failed += self._consume(k, labels, phred)
            out.items += len(labels)
            out.batches += 1
            k += 1
            if t1 >= end or out.batches == max_batches:
                break
        out.window_s = clock() - start
        if on_close is not None:
            on_close()
        return out

    def release(self):
        del self.predict
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()

    def reference_outputs(self, pool_ids, precision=None) -> dict:
        """{pool id: (labels, fraction, margin)}, each (rows, seq_length),
        on the first device in blocks of REF_ROWS chunks."""
        params = self._weights()
        ids = sorted(set(pool_ids))
        per = max(1, REF_ROWS // self.rows)
        out = {}
        for i in range(0, len(ids), per):
            block = ids[i:i + per]
            x = torch.from_numpy(self.images[block]).to(self.devices[0])
            parts = self.reference.consensus(
                params, self.config, x.reshape(-1, *x.shape[2:]), precision)
            parts = [t.cpu().numpy().reshape(len(block), self.rows, -1)
                     for t in parts]
            for j, p in enumerate(block):
                out[p] = tuple(t[j] for t in parts)
        return out

    def produced(self):
        """The kept calls as (pool id, labels, vote fraction): the
        fraction read back from the phred the program returned."""
        return [(p, labels, 1.0 - 10.0 ** (-phred.astype(np.float64) / 10))
                for p, labels, phred in self.kept]

    def reference_produced(self, reference):
        """The reference's outputs of every pool batch in the form of
        `produced`: a control put in the program's place."""
        return [(p, labels, fraction)
                for p, (labels, fraction, _) in reference.items()]

    def compare(self, produced, reference) -> dict:
        gap, flips = 0.0, 0
        for p, labels, fraction in produced:
            ref_labels, ref_fraction, margin = reference[p]
            if labels.shape != ref_labels.shape:
                flips += ref_labels.size
                continue
            gap = max(gap, float(np.abs(fraction - ref_fraction).max()))
            flips += int(np.count_nonzero(
                (labels != ref_labels) & (margin > self.label_tie)))
        return {"vote_gap": gap, "label_flips": flips}

    def check(self) -> dict:
        produced = self.produced()
        return self.compare(produced, self.reference_outputs(
            [p for p, _, _ in produced]))
