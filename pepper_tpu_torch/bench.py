"""Benchmark: window-classifier inference throughput on one GPU, the port
of the JAX package's bench.py.

    python -m pepper_tpu_torch.bench [--device cpu]

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

The metric is pileup windows/s per chip through the flagship variant-mode
model (bi-LSTM window classifier, 33x26 inputs -> 3-class probs), the same
quantity the reference reports from its inference stage logs
(predict_distributed_cpu.py:215-219: elapsed time over total windows).

Methodology (bench.py's): N distinct batches are enqueued back to back,
each input perturbed by its index so that every batch is a distinct
execution, and a checksum accumulated on the device is fetched once, the
only host barrier: the loop stays queued and what is timed is the
device's sustained rate.  Each length is warmed up once and the best of 3
taken; two lengths are timed and the marginal rate reported (the fixed
dispatch and fetch overhead subtracted).

The mode (PEPPER_BENCH_MODE): int8_static, the default as in the JAX
bench (lstm_direction_fused_static), bf16 (lstm_direction_fused) or
int8_dynamic (lstm_recurrence).

vs_baseline is 0: the reference has no published windows/s number
(BASELINE.md), and its model class is not part of this repository, so
there is nothing to compare against.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .device import pop_device_arg, resolve_device
from .models import quantize
from .models.transducer import (TransducerConfig, init_transducer_params,
                                map_params, params_from_jax,
                                transducer_apply)

METRIC = "pileup windows/s per chip (window-classifier inference)"
MODES = ("int8_static", "bf16", "int8_dynamic")
COMPUTE_DTYPE = torch.bfloat16      # every mode's, as in the JAX bench


def bench_forward(mode: str, device, config: TransducerConfig | None = None):
    """(forward, tree) of one bench mode: forward(tree, x) maps (B, T, F)
    windows in bfloat16 to (B, 3) float32 probabilities through the
    mode's kernel on cuda (its plain version on the CPU).  The params come
    from a torch.Generator seeded with 0, as the runner would take them
    (float32 numpy leaves)."""
    if mode not in MODES:
        raise ValueError(f"unknown PEPPER_BENCH_MODE {mode!r}; one of {MODES}")
    config = config or TransducerConfig()
    params = init_transducer_params(torch.Generator().manual_seed(0),
                                    config)
    host = map_params(lambda p: p.numpy(), params)
    if mode == "int8_static":
        tree = quantize.prepare_static(quantize.quantize_params_static(host),
                                       COMPUTE_DTYPE, device)

        def forward(tree, x):
            return quantize.transducer_infer_static(tree, x, COMPUTE_DTYPE)
    elif mode == "int8_dynamic":
        q, s = quantize.quantize_params(host)
        tree = (params_from_jax(q, device), params_from_jax(s, device))

        def forward(tree, x):
            return quantize.transducer_infer_quantized(*tree, x,
                                                       COMPUTE_DTYPE)
    else:
        tree = map_params(lambda p: p.to(COMPUTE_DTYPE),
                          params_from_jax(host, device))

        def forward(tree, x):
            return transducer_apply(tree, x)
    return forward, tree


def bench_inputs(batch: int, device,
                 config: TransducerConfig | None = None) -> torch.Tensor:
    """The bench's windows: RandomState(0) values in [-125, 125], in
    bfloat16."""
    config = config or TransducerConfig()
    rng = np.random.RandomState(0)
    values = rng.randint(-125, 126, size=(batch, config.window,
                                          config.image_features))
    return torch.as_tensor(values).to(device=device, dtype=COMPUTE_DTYPE)


def bench_torch(batch: int = 4096, n_short: int = 10, n_long: int = 50,
                mode: str | None = None, device=None,
                config: TransducerConfig | None = None) -> float:
    """Sustained windows/s of one mode on `device` (cuda unless given)."""
    device = resolve_device(device)
    if mode is None:
        mode = os.environ.get("PEPPER_BENCH_MODE", "int8_static")
    forward, tree = bench_forward(mode, device, config)
    x = bench_inputs(batch, device, config)

    @torch.inference_mode()
    def run(iters: int) -> float:
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(iters):
            # perturb the input so every iteration is a distinct execution
            probs = forward(tree, x + i)
            total += probs.float().sum()
        return float(total)  # the one host fetch: the timing barrier

    def timed(iters: int) -> float:
        run(iters)  # warmup
        best = float("inf")
        for _ in range(3):
            start = time.perf_counter()
            run(iters)
            best = min(best, time.perf_counter() - start)
        return best

    t_short = timed(n_short)
    t_long = timed(n_long)
    marginal = (t_long - t_short) / (n_long - n_short)
    if marginal <= 0:  # degenerate timing; fall back to raw long-run rate
        return batch * n_long / t_long
    return batch / marginal


def result_line(windows_per_s: float) -> dict:
    """The bench's one JSON object, bench.py's keys and metric string."""
    return {"metric": METRIC, "value": round(windows_per_s, 1),
            "unit": "windows/s", "vs_baseline": 0}


def main(argv=None, **sizes) -> dict:
    """Runs the bench on `--device` (cuda unless given) and prints its
    line.  sizes: bench_torch's batch, n_short, n_long and config (a
    smaller run than the default's)."""
    _, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    line = result_line(bench_torch(device=device, **sizes))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
