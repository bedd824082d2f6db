"""First-class stage metrics: per-stage wall clock + items/s counters in the
reference's `[MM-DD-YYYY hh:mm:ss] INFO:` log format (its only
observability, SetParameters.py:291-318 / predict_distributed_cpu.py:
215-219), plus torch.profiler trace capture for device timelines — the
port of the JAX package's utils/profiling.py.

StageTimer measures host wall time and never synchronizes the device: a
caller whose stage ends on device work ends the block with a host fetch
(`.cpu()`, `.item()`) or `torch.cuda.synchronize()`."""

from __future__ import annotations

import contextlib
import re
import sys
import time
import warnings
from datetime import datetime


def log_line(message: str) -> None:
    timestamp = datetime.now().strftime("%m-%d-%Y %H:%M:%S")
    sys.stderr.write(f"[{timestamp}] INFO: {message}\n")
    sys.stderr.flush()


class StageTimer:
    """Context manager: logs elapsed Min/Sec and optional items/s.

    >>> with StageTimer("INFERENCE", unit="windows") as timer:
    ...     timer.add(len(batch))
    """

    def __init__(self, stage: str, unit: str = "items", quiet: bool = False):
        self.stage = stage
        self.unit = unit
        self.quiet = quiet
        self.count = 0
        self.elapsed = 0.0

    def add(self, n: int) -> None:
        self.count += n

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if not self.quiet:
            mins = int(self.elapsed / 60)
            secs = int(self.elapsed) % 60
            message = (f"{self.stage} ELAPSED TIME: {mins} Min {secs} Sec")
            if self.count:
                message += (f" ({self.count} {self.unit}, "
                            f"{self.count / max(1e-9, self.elapsed):.1f} "
                            f"{self.unit}/s)")
            log_line(message)
        return False


# the __global__ functions of ops/csrc: each kernel wrapper's launch runs
# at least one of them
PORT_KERNELS = ("core_kernel", "core_smem_kernel", "core_stream_kernel",
                "f32_core_kernel", "pileup_histogram_kernel",
                "projection_f32_kernel", "projection_kernel",
                "projection_narrow_kernel")


def port_kernel_events(names) -> int:
    """How many of the device kernel names (as the profiler shows them,
    demangled) are of the port's kernels."""
    pattern = re.compile(r"::(?:%s)[<(]" % "|".join(PORT_KERNELS))
    return sum(1 for name in names if pattern.search(name))


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace capture into log_dir (a Chrome trace JSON per
    run, torch.profiler.tensorboard_trace_handler's layout): CPU activity
    always, CUDA activity where a card is present; no-op when log_dir is
    falsy.

    With CUDA activity it warns (RuntimeWarning) when the trace holds
    fewer of the port's kernel events than the kernel wrappers launched
    inside the block.  On the card machine a torch.profiler session run a
    minute or more after the process's first one loses kernel records,
    PyTorch's own too (all of them after two idle minutes; PERF.md
    section 7): trace in a fresh process, or soon after the first
    session."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = sum(kernel_launches().values())
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield
    launches = sum(kernel_launches().values()) - before
    if cuda and launches:
        from torch.autograd import DeviceType

        events = port_kernel_events(
            e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
        if events < launches:
            warnings.warn(f"trace({log_dir!r}) holds {events} kernel events "
                          f"of the port for {launches} launches: the "
                          "profiler dropped some", RuntimeWarning,
                          stacklevel=3)


def kernel_launches() -> dict:
    """Each CUDA kernel wrapper's launch count in this process, by
    wrapper name, the kernels never launched left out (each wrapper adds
    one where it launches its kernel; the CPU's plain versions count
    nothing)."""
    from ..ops import gru_kernel, lstm_kernel, pileup_kernel

    counts = {name: getattr(module, name).launches
              for module in (lstm_kernel, gru_kernel, pileup_kernel)
              for name in module.KERNELS}
    return {name: count for name, count in counts.items() if count}
