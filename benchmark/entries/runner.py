"""The variant caller's served path: `InferenceRunner.dispatch`/`resolve`
in `call_variant`'s 1-deep pipeline (pipeline/call_variant.py, `drain`):
batch k+1 is uploaded and enqueued before batch k's predictions are
fetched, in full batches of the traffic's rows, a closed loop.

`inputs` makes a pool of distinct window batches on the host from the
seed, one `CandidateWindow` a row (its position the row's id); set-up
makes the weights on the first device from the seed, the runner as
`call_variant` builds it, and runs a few batches of the loop so that
every kernel is built and every shape allocated.

Inside the window every resolved batch is checked at once for its size
and its first and last window's ids; a sample of the batches, drawn from
the seed, is kept whole.  After the window the reference recomputes the
probabilities of the kept batches' pool entries, and `compare` holds
every kept prediction to its window's id, in order, and to the
reference's probabilities.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import generate
from benchmark.spec import load_module

KEEP_EVERY = 16         # about one batch in 16 is kept for the comparison
REF_ROWS = 8192         # the reference's block of windows
WARM_BATCHES = 4


@dataclass
class Window:
    items: int = 0          # windows resolved inside the window
    batches: int = 0        # batches resolved inside the window
    dispatched: int = 0     # batches dispatched, the in-flight one too
    attempted: int = 0      # windows dispatched
    failed: int = 0         # windows of batches that came back wrong
    window_s: float = 0.0


class Entry:
    SPANS = ("dispatch", "resolve")

    def __init__(self, cell, seed: int, devices, variant: str | None = None):
        """variant: None for the cell's program; "int8_<mode>" for the
        program's own int8 path in that quantize mode (a control)."""
        self.cell = cell
        self.config = cell.config
        self.seed = seed
        self.devices = devices
        self.variant = variant
        self.rows = cell.traffic["rows_per_device"] * len(devices)
        self.reference = load_module("reference", self.config["reference"])
        self.kept = []

    def _weights(self):
        return generate.make_weights(
            self.reference.param_shapes(self.config), self.seed,
            self.devices[0])

    def inputs(self):
        """The pool of window batches, (pool, rows, window, features), and
        the caller's `CandidateWindow` of each row."""
        from pepper_tpu_torch.ops.pileup_ref import CandidateWindow

        cfg = self.config
        self.images = generate.make_pool(
            cfg, self.rows, self.cell.traffic["pool"],
            (cfg["window"], cfg["image_features"]), self.seed)
        self.batches = [
            [CandidateWindow("bench", p * self.rows + i, 30, ["A"], [30],
                             self.images[p, i]) for i in range(self.rows)]
            for p in range(len(self.images))]

    def setup(self):
        from pepper_tpu_torch.infer.runner import InferenceRunner

        cfg, traffic = self.config, self.cell.traffic
        self.flags = generate.sample_flags(self.seed, KEEP_EVERY)
        multi = len(self.devices) > 1
        weights = self._weights()
        if self.variant is not None:
            # the int8 paths quantize a host tree, as a checkpoint gives
            weights = {group: {k: v.cpu().numpy() for k, v in leaves.items()}
                       for group, leaves in weights.items()}
        self.runner = InferenceRunner(
            weights, batch_size=self.rows,
            compute_dtype=traffic["compute_dtype"], window=cfg["window"],
            features=cfg["image_features"],
            quantized=self.variant is not None,
            quantize_mode=(self.variant or "int8_static")[len("int8_"):],
            device=self.devices[0],
            devices=list(self.devices) if multi else None)
        self.run(float("inf"), {n: [] for n in self.SPANS},
                 max_batches=WARM_BATCHES)
        self.kept = []

    def _consume(self, k, preds) -> int:
        """The in-window check of batch k; returns its failed windows.  A
        kept batch's predictions are read into arrays at once, so that the
        harness holds no more of the program's objects than a caller
        would."""
        p = k % len(self.batches)
        if self.flags[k % len(self.flags)] or k == 0:
            self.kept.append((p, np.array([w.position for w in preds]),
                              np.array([w.prediction_base for w in preds],
                                       np.float64)))
        first = p * self.rows
        if (len(preds) != self.rows or preds[0].position != first
                or preds[-1].position != first + self.rows - 1):
            return self.rows
        return 0

    def run(self, seconds, spans, on_close=None, max_batches=None):
        runner, batches = self.runner, self.batches
        clock = time.perf_counter
        out = Window()
        inflight = None
        k = 0
        start = clock()
        end = start + seconds
        while True:
            t0 = clock()
            handle = runner.dispatch(batches[k % len(batches)])
            t1 = clock()
            spans["dispatch"].append((t0, t1))
            out.dispatched += 1
            out.attempted += self.rows
            if inflight is not None:
                preds = runner.resolve(inflight)
                t2 = clock()
                spans["resolve"].append((t1, t2))
                out.failed += self._consume(k - 1, preds)
                out.items += len(preds)
                out.batches += 1
                if t2 >= end or out.batches == max_batches:
                    break
            inflight = handle
            k += 1
        out.window_s = clock() - start
        if on_close is not None:
            on_close()
        # the batch in flight at the close: checked, not counted
        out.failed += self._consume(k, runner.resolve(handle))
        return out

    def release(self):
        """Frees the program's state before the reference runs."""
        del self.runner
        gc.collect()
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()

    def reference_outputs(self, pool_ids, precision=None) -> dict:
        """{pool id: reference probabilities (rows, classes)}, computed on
        the first device in blocks of REF_ROWS windows."""
        params = self._weights()
        ids = sorted(set(pool_ids))
        per = max(1, REF_ROWS // self.rows)
        out = {}
        for i in range(0, len(ids), per):
            block = ids[i:i + per]
            x = torch.from_numpy(self.images[block]).to(self.devices[0])
            probs = self.reference.forward(
                params, self.config, x.reshape(-1, *x.shape[2:]), precision)
            probs = probs.cpu().numpy().reshape(len(block), self.rows, -1)
            out.update(zip(block, probs))
        return out

    def produced(self):
        """The kept batches as (pool id, window ids, probabilities)."""
        return self.kept

    def reference_produced(self, reference):
        """The reference's outputs of every pool batch in the form of
        `produced`: a control put in the program's place."""
        return [(p, p * self.rows + np.arange(self.rows),
                 probs.astype(np.float64)) for p, probs in reference.items()]

    def compare(self, produced, reference) -> dict:
        gap, misplaced = 0.0, 0
        for p, ids, probs in produced:
            expected = p * self.rows + np.arange(self.rows)
            n = min(len(ids), self.rows)
            misplaced += abs(len(ids) - self.rows) + int(
                np.count_nonzero(ids[:n] != expected[:n]))
            gap = max(gap, float(np.abs(probs[:n] - reference[p][:n]).max()))
        return {"prob_gap": gap, "misplaced": misplaced}

    def check(self) -> dict:
        produced = self.produced()
        return self.compare(produced, self.reference_outputs(
            [p for p, _, _ in produced]))
