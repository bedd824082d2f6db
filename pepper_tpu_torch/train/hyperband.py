"""Hyperband hyper-parameter search (successive halving), mirroring the
reference's models/hyperband.py:15-140 (itself derived from the public
zygmuntz/hyperband algorithm): brackets of random (lr, l2) configurations
trained for geometrically increasing epoch budgets, keeping the top
1/eta by accuracy each rung."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from datetime import datetime
from math import ceil, log

import numpy as np


def sample_config(rng: np.random.RandomState) -> dict:
    """Random (learning_rate, weight_decay) draw — log-uniform, the
    reference's lr/l2 search space."""
    return {
        "learning_rate": float(10 ** rng.uniform(-5, -2)),
        "weight_decay": float(10 ** rng.uniform(-7, -3)),
    }


@dataclass
class Hyperband:
    """try_params(n_iterations, config, checkpoint_path, resume) must return
    {'loss': float, 'accuracy': float, 'checkpoint': str}."""

    try_params: callable
    max_iter: int = 27
    eta: int = 3
    seed: int = 0
    get_params: callable = None
    results: list = field(default_factory=list)

    def __post_init__(self):
        self.logeta = lambda x: log(x) / log(self.eta)
        self.s_max = int(self.logeta(self.max_iter))
        self.B = (self.s_max + 1) * self.max_iter
        self._rng = np.random.RandomState(self.seed)
        if self.get_params is None:
            self.get_params = lambda: sample_config(self._rng)

    def _log(self, message):
        timestamp = datetime.now().strftime("%m-%d-%Y %H:%M:%S")
        sys.stderr.write(f"[{timestamp}] INFO: {message}\n")

    def run(self, skip_last: int = 0):
        best = None
        counter = 0
        for s in reversed(range(self.s_max + 1)):
            n = int(ceil(self.B / self.max_iter / (s + 1) * self.eta ** s))
            r = self.max_iter * self.eta ** (-s)
            configs = [dict(self.get_params(), _id=f"s{s}_c{i}",
                            _resume=False) for i in range(n)]
            for i in range((s + 1) - int(skip_last)):
                n_iterations = int(ceil(r * self.eta ** i))
                self._log(f"BRACKET s={s}: {len(configs)} configs x "
                          f"{n_iterations} iterations")
                rung = []
                for config in configs:
                    counter += 1
                    result = self.try_params(n_iterations, config)
                    record = {"config": config, "iterations": n_iterations,
                              **result}
                    self.results.append(record)
                    rung.append(record)
                    if best is None or result["accuracy"] > best["accuracy"]:
                        best = record
                        self._log(f"NEW BEST: acc={result['accuracy']:.3f} "
                                  f"config={config}")
                rung.sort(key=lambda record: -record["accuracy"])
                keep = max(1, int(len(configs) / self.eta))
                configs = [dict(record["config"], _resume=True)
                           for record in rung[:keep]]
        return best
