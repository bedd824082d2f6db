"""The readings that the limits of `correct` are set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \
        --controls int8_static,tf32_reference --control-seeds 7,8,9 \
        --seconds 3 [--out results.jsonl]

In one process, at the cell's own size and load: for each seed of
`--seeds`, the program's timed path over a short window, compared with the
reference as a run compares it (the lower readings); then for each
control and each of `--control-seeds` the same comparison of the control
(the upper readings).  A control is either `int8_<mode>`, the program's
own int8 path in that quantize mode, or `<precision>_reference`, the
reference computed in that precision (benchmark/precision.py) in the
program's place over every batch of the pool.  One JSON line a reading,
and the largest reading of each number a variant gave, last.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import spec


def reading(cell, seed, devices, variant, seconds):
    entry_cls = spec.load_module("entries", cell.config["entry"]).Entry
    if variant and variant.endswith("_reference"):
        entry = entry_cls(cell, seed, devices)
        entry.inputs()
        ids = range(len(entry.images))
        produced = entry.reference_produced(entry.reference_outputs(
            ids, variant[:-len("_reference")]))
        return entry.compare(produced, entry.reference_outputs(ids))
    entry = entry_cls(cell, seed, devices, variant=variant)
    entry.inputs()
    entry.setup()
    window = entry.run(seconds, {name: [] for name in entry.SPANS})
    entry.release()
    numbers = entry.check()
    numbers["failed"] = window.failed
    numbers["items"] = window.items
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.devices:
        sys.stderr.write(f"{args.workload} needs {cell.devices} CUDA "
                         "device(s)\n")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.devices)]
    torch.set_num_threads(1)
    runs = [(None, int(s)) for s in args.seeds.split(",") if s]
    runs += [(c, int(s)) for c in args.controls.split(",") if c
             for s in args.control_seeds.split(",") if s]
    largest = {}
    out = open(args.out, "a") if args.out else None
    try:
        for variant, seed in runs:
            t0 = time.perf_counter()
            numbers = reading(cell, seed, devices, variant, args.seconds)
            line = {"workload": cell.name, "variant": variant or "program",
                    "seed": seed, "numbers": numbers,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            top = largest.setdefault(line["variant"], {})
            for name, value in numbers.items():
                top[name] = max(top.get(name, value), value)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": cell.name, "largest": largest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
