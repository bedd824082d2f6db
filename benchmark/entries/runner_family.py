"""The variant caller's served path for a model family other than the
biLSTM transducer: entries/runner.py's loop (`InferenceRunner.dispatch`/
`resolve` in `call_variant`'s 1-deep pipeline, full batches, a closed
loop, the same in-window checks and kept batches), with the runner built
for the configuration's `model_type`, as `call_variant` builds it from a
checkpoint's metadata.

The weights are the generator's tree (benchmark/generate.py) with each
norm's gamma moved to 1 + U(-0.1, 0.1) and the BatchNorm running
statistics calibrated on the pool's first batch in float32 by the
reference module (`calibrate_batchnorm`); the program and the reference
are handed the same tree.  Beside the runner entry's numbers, `compare`
gives `prob_rms`, the root mean square of every kept probability's gap
from the reference's: a fault that moves all windows a little (a norm
left out, heads mixed up) shows in it under the widest gap's limit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate
from benchmark.spec import load_module

runner = load_module("entries", "runner")


class Entry(runner.Entry):

    def __init__(self, cell, seed: int, devices, variant: str | None = None):
        if variant is not None:
            raise ValueError(f"{cell.name}: the int8 paths serve the lstm "
                             f"family alone, not {variant}")
        super().__init__(cell, seed, devices)

    def _weights(self):
        tree = super()._weights()
        for path in self.reference.param_shapes(self.config):
            *groups, leaf = path.split(".")
            if leaf == "gamma":
                node = tree
                for group in groups:
                    node = node[group]
                node[leaf].add_(1.0)
        self.reference.calibrate_batchnorm(
            tree, self.config,
            torch.from_numpy(self.images[0]).to(self.devices[0]))
        return tree

    def setup(self):
        from pepper_tpu_torch.infer.runner import InferenceRunner

        cfg, traffic = self.config, self.cell.traffic
        self.flags = generate.sample_flags(self.seed, runner.KEEP_EVERY)
        multi = len(self.devices) > 1
        self.runner = InferenceRunner(
            self._weights(), batch_size=self.rows,
            compute_dtype=traffic["compute_dtype"], window=cfg["window"],
            features=cfg["image_features"], model_type=cfg["model_type"],
            device=self.devices[0],
            devices=list(self.devices) if multi else None)
        self.run(float("inf"), {n: [] for n in self.SPANS},
                 max_batches=runner.WARM_BATCHES)
        self.kept = []

    def compare(self, produced, reference) -> dict:
        numbers = super().compare(produced, reference)
        squares, count = 0.0, 0
        for p, _, probs in produced:
            gap = probs[:self.rows] - reference[p][:len(probs[:self.rows])]
            squares += float(np.square(gap).sum())
            count += gap.size
        numbers["prob_rms"] = (squares / count) ** 0.5 if count else 0.0
        return numbers
