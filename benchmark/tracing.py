"""The traced run's device trace: one torch.profiler session with the CUDA
activity alone (no CPU activity, which would slow the host path it
measures), opened just before the measured window and closed after it.

The device's clock is tied to the host's by a marker: with every device
idle, the session's first device operation is one small fill on the first
device, launched at a known host time.  Device intervals are clipped to
the window, their union per device is its busy time, and the idle gaps
are labelled by the harness span (dispatch, resolve, consensus) the host
was in when each gap began.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

NAME_CHARS = 120


@dataclass
class DeviceTrace:
    window_s: float = 0.0
    busy_s: float = 0.0                 # mean over the devices
    kernel_busy_s: float = 0.0          # summed over the devices
    port_events: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union(intervals):
    """Sorted, merged intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _events(prof):
    """(device index, name, start ns, end ns) of every device event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.device_index(), e.name(), start, start + dur))
    return out


def prepare():
    """Imports what a torch.profiler session loads when it starts: its
    start asks `hasattr(torch, "_inductor")`, which imports inductor,
    dynamo and sympy (some 840 modules, 120,000 objects).  Called before
    the harness freezes its heap, so that the collector's full passes in
    the window do not walk them (16-17 s of a 51 s traced window when they
    did)."""
    import torch._inductor.config  # noqa: F401


class Session:
    """with Session(devices) as s: ...window...; s.close_window() at the
    window's end; s.result(spans) after the block."""

    def __init__(self, devices):
        self.devices = devices
        self.prof = None

    def __enter__(self):
        for d in self.devices:
            torch.cuda.synchronize(d)
        marker = torch.zeros(1, device=self.devices[0])
        torch.cuda.synchronize(self.devices[0])
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.host_start = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize(self.devices[0])
        self.host_end = None
        return self

    def close_window(self):
        self.host_end = time.perf_counter()

    def __exit__(self, *exc):
        if self.host_end is None:
            self.host_end = time.perf_counter()
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.prof.__exit__(*exc)
        return False

    def result(self, spans: dict, port_event_count) -> DeviceTrace:
        """spans: {name: [(host start, host end), ...]} in perf_counter
        seconds; port_event_count(names) counts the port's kernels among
        the session's kernel events (to hold against the launches the
        program counted inside the session)."""
        events = _events(self.prof)
        first = min(events, key=lambda e: e[2])
        offset = first[2] * 1e-9 - self.host_start   # device s - host s
        lo = (self.host_start + offset) * 1e9
        hi = (self.host_end + offset) * 1e9
        busy, kernels, by_name, names = {}, {}, {}, []
        for device, name, start, end in events:
            kernel = not name.startswith(("Memcpy", "Memset"))
            if kernel:
                names.append(name)      # the whole session's, unclipped
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            busy.setdefault(device, []).append((start, end))
            if kernel:
                kernels.setdefault(device, []).append((start, end))
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (end - start) * 1e-9
        trace = DeviceTrace(window_s=self.host_end - self.host_start)
        n_dev = len(self.devices)
        trace.busy_s = sum(e - s for iv in busy.values()
                           for s, e in _union(iv)) * 1e-9 / n_dev
        trace.kernel_busy_s = sum(e - s for iv in kernels.values()
                                  for s, e in _union(iv)) * 1e-9
        trace.port_events = port_event_count(names)
        trace.device_ops = sorted(([n, s] for n, s in by_name.items()),
                                  key=lambda x: -x[1])[:10]
        # idle gaps of the first device, by the host span at their start
        host = sorted((s, e, name) for name, iv in spans.items()
                      for s, e in iv)
        starts = [s for s, _, _ in host]
        merged = _union(busy.get(first[0], []))
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = sorted(((end - start, start) for start, end
                       in zip(edges[0::2], edges[1::2]) if end > start),
                      reverse=True)[:10]
        for length, start in gaps:
            at = start * 1e-9 - offset
            i = bisect.bisect_right(starts, at) - 1
            label = host[i][2] if i >= 0 and at < host[i][1] else "harness"
            trace.idle_gaps.append([label, length * 1e-9])
        return trace
