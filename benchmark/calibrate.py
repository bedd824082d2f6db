"""Sound readings of a cell's compared numbers over every batch of its pool,
on the card: the lower side that a limit of `correct` is set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--devices cuda:0,cuda:0,cuda:0,cuda:0] [--out results.jsonl]

In one process, for each seed: the cell's entry sets up as a run does
(weights and inputs from the seed, the program, its warm-up), keeps every
batch, and drives its timed path until each of the pool's batches has
been resolved once; the reference then recomputes them all, and the
comparison gives the numbers a run's check gives.  A run keeps about one
batch in 16, so its window sees fewer of the pool's batches: this reading
holds the widest of them all.  `--devices` names the devices the cell's
blocks run on (the cards the cell asks for by default; one card named
several times runs the same blocks, of the same size, through the same
kernels).  One JSON line a seed, and the largest of each number last.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import spec


def reading(cell, seed, devices):
    entry = spec.load_module("entries", cell.config["entry"]).Entry(
        cell, seed, devices)
    entry.inputs()
    entry.setup()
    entry.flags = np.ones(len(entry.flags), bool)
    entry.kept = []
    pool = len(entry.batches)
    window = entry.run(float("inf"), {name: [] for name in entry.SPANS},
                       max_batches=pool)
    entry.release()
    numbers = entry.check()
    numbers["failed"] = window.failed
    numbers["batches"] = len({p for p, _, _ in entry.produced()})
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--devices", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if args.devices:
        devices = [torch.device(d) for d in args.devices.split(",")]
    else:
        devices = [torch.device("cuda", i) for i in range(cell.devices)]
    if len(devices) != cell.devices:
        sys.stderr.write(f"{args.workload} runs on {cell.devices} "
                         f"device(s); given {args.devices or 'the cards'}\n")
        return 2
    torch.set_num_threads(1)
    largest = {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",") if s):
            t0 = time.perf_counter()
            numbers = reading(cell, seed, devices)
            line = {"workload": cell.name, "variant": "all_batches",
                    "seed": seed, "numbers": numbers,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            for name, value in numbers.items():
                largest[name] = max(largest.get(name, value), value)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": cell.name, "largest": largest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
