"""Runs one cell of the port's benchmark once, and prints its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell (BENCHMARK.json's `workloads`) names a configuration and a
traffic mix; benchmark/spec.py finds their files.  The run:

1. sets up: the configuration's entry (benchmark/entries/) makes the
   weights and inputs from the seed, builds the program's served path and
   warms it up; `setup_s` is the time from this module's start to here;
2. measures for `--seconds`: the entry's closed loop, the harness's spans
   around each call into the program; with `--trace 1` inside one
   torch.profiler session of the CUDA activity alone (benchmark/
   tracing.py), which fails the run if it holds fewer of the port's kernel
   events than the port counted launches;
3. reads the device memory peak, frees the program's state, and lets the
   entry compare what the timed path produced with the plain reference
   (benchmark/reference/): each number against its limit in
   limits/<cell>.json decides `correct`;
4. prints, as the last line of standard output, one JSON object: with
   `--trace 0` the cell's end-to-end metrics, with `--trace 1` its
   per-layer metrics, `device` and `breakdown`; the compared numbers,
   each beside its limit, come last there under `checks`, and as the last
   lines of standard error.

It exits non-zero and prints no result without the cards the cell asks
for, or when JAX or the JAX package is loaded once the window has closed.

Run as a program, it first fixes what would differ from process to
process on the host path (`_steady`): the string hash seed and the cores
the process runs on.  The window's host record (the collector's passes,
context switches, the machine's steal time, batches each second) goes to
standard error.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.peaks import PEAKS  # noqa: E402

# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pepper_tpu")
CACHE = os.path.join(spec.ROOT, ".bench_cache")
HASH_SEED = "0"
CORES = 2


def _steady():
    """Fixes the string hash seed (dict and set layouts; the process runs
    itself again, once, with it) and the cores: the last CORES of those
    the process may use, so that the loop's one thread stays on a core
    whose caches hold its state."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.environ["PYTHONHASHSEED"] = HASH_SEED
        os.execv(sys.executable, [sys.executable, "-m", "benchmark.run",
                                  *sys.argv[1:]])
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-CORES:])


def _steal_s():
    """The machine's steal time so far, summed over its cores, in s."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


class HostWatch:
    """What the host did inside the window: the collector's passes by
    generation (count, seconds), the process's involuntary context
    switches, and the steal time the machine's hypervisor took."""

    def __init__(self):
        self.passes = [[0, 0.0] for _ in range(3)]
        self._start = None

    def _pass(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            tally = self.passes[info["generation"]]
            tally[0] += 1
            tally[1] += time.perf_counter() - self._start

    def __enter__(self):
        self._switches = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        self._steal = _steal_s()
        gc.callbacks.append(self._pass)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._pass)
        self.switches = (resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
                         - self._switches)
        self.steal_s = _steal_s() - self._steal

    def line(self) -> str:
        passes = " ".join(f"gen{g} {n} ({t:.3f} s)"
                          for g, (n, t) in enumerate(self.passes))
        return (f"host in the window: collector {passes}; involuntary "
                f"switches {self.switches}; steal {self.steal_s:.2f} s "
                f"over all cores")


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into pepper_tpu_torch/_build/ itself)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _say(message: str):
    sys.stderr.write(message + "\n")
    sys.stderr.flush()


def _card_line():
    """The cards' names and power limits, on standard error."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not available"
    _say("cards: " + " | ".join(out.splitlines()))
    return out


def _per_second(spans, last, window_s):
    """How many calls of the loop's last span ended in each whole second
    of the window: whether the rate held through it."""
    ends = [e for _, e in spans[last]]
    if not ends:
        return []
    start = min(iv[0][0] for iv in spans.values() if iv)
    counts = [0] * max(1, int(window_s))
    for end in ends:
        i = int(end - start)
        if i < len(counts):
            counts[i] += 1
    return counts


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device=None, traffic=None):
    """Returns the exit code.  device and traffic serve the tests alone: a
    torch device, or a list of them, to run every block on instead of the
    cards, and keys that replace the traffic file's (a size a test run can
    hold)."""
    args = parse(argv)
    _caches()
    cell = spec.load_cell(args.workload)
    cell.traffic.update(traffic or {})
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.devices):
            _say(f"{args.workload} needs {cell.devices} CUDA device(s); "
                 f"found {torch.cuda.device_count()}")
            return 2
        devices = [torch.device("cuda", i) for i in range(cell.devices)]
        _card_line()
    elif isinstance(device, list):
        devices = [torch.device(d) for d in device]
    else:
        devices = [torch.device(device)] * cell.devices
    cuda = devices[0].type == "cuda"
    torch.set_num_threads(1)
    entry = spec.load_module("entries", cell.config["entry"]).Entry(
        cell, args.seed, devices)
    entry.inputs()
    trace = None
    if args.trace and cuda:
        from benchmark import tracing

        tracing.prepare()
    # the caller's own heap (the input pool; torch and the harness) is
    # frozen out of the collector's passes before the port is imported;
    # the port's modules, its set-up and what the window makes stay in
    # them, as in any caller that holds only the batch in hand
    gc.collect()
    gc.freeze()
    from pepper_tpu_torch.utils.profiling import (kernel_launches,
                                                  port_kernel_events)

    entry.setup()
    setup_s = time.perf_counter() - START
    spans = {name: [] for name in entry.SPANS}
    launches = sum(kernel_launches().values())
    if args.trace and cuda:
        with tracing.Session(devices) as session, HostWatch() as host:
            window = entry.run(args.seconds, spans,
                               on_close=session.close_window)
        launches = sum(kernel_launches().values()) - launches
        trace = session.result(spans, port_kernel_events)
        if trace.port_events < launches:
            _say(f"the trace holds {trace.port_events} kernel events of the "
                 f"port for {launches} launches: the profiler lost some")
            return 4
    else:
        with HostWatch() as host:
            window = entry.run(args.seconds, spans)
        launches = sum(kernel_launches().values()) - launches
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if cuda else 0
    entry.release()
    gc.collect()
    numbers = entry.check()
    numbers["failed"] = window.failed
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        _say("loaded in the run's process: " + ", ".join(loaded))
        return 3

    limits = cell.limits["numbers"]
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    compute = cell.compute_dtype
    reading = SimpleNamespace(
        cell=cell.name, config=cell.config, traffic=cell.traffic,
        devices=len(devices), items=window.items, batches=window.batches,
        dispatched=window.dispatched, window_s=window.window_s,
        setup_s=setup_s, trace=trace, counters={"launches": launches},
        spans={name: [e - s for s, e in iv] for name, iv in spans.items()},
        work=spec.load_module("work", cell.config["work"]),
        peak_flops=PEAKS[cell.config["peaks"][compute]],
        itemsize=torch.empty(0, dtype=getattr(torch, compute)).itemsize)
    metrics = {}
    for metric in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(metric["name"]).read(reading)
        if value is not None:
            metrics[metric["name"]] = {"value": value,
                                       "unit": metric["unit"]}
    result = {
        "correct": correct, "attempted": window.attempted,
        "failed": window.failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else devices[0].type,
                   "kind": torch.cuda.get_device_name(devices[0])
                   if cuda else devices[0].type,
                   "count": len(devices), "memory_peak_bytes": peak}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s,
                                window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = checks
    per_second = _per_second(spans, entry.SPANS[-1], window.window_s)
    _say("batches in each second of the window: " + " ".join(
        map(str, per_second)))
    _say(host.line())
    for name, c in checks.items():
        _say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _steady()
    sys.exit(main())
