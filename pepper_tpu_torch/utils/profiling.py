"""First-class stage metrics: per-stage wall clock + items/s counters in the
reference's `[MM-DD-YYYY hh:mm:ss] INFO:` log format (its only
observability, SetParameters.py:291-318 / predict_distributed_cpu.py:
215-219), plus torch.profiler trace capture for device timelines — the
port of the JAX package's utils/profiling.py.

StageTimer measures host wall time and never synchronizes the device: a
caller whose stage ends on device work ends the block with a host fetch
(`.cpu()`, `.item()`) or `torch.cuda.synchronize()`.

Inside the served paths, `span` marks each phase of a call (the runner's
dispatch and resolve, consensus_predict's batches) while a torch.profiler
session is active, and nothing otherwise; `spans()` and `gc_spans()`
export what it recorded; `device_span` times a launch on the device
between two CUDA events in the same sessions, and `device_spans` exports
those times.  `count_rows` keeps the rows each bucketing layer padded, and
`count_resolve` the runner's resolves that found their batch done,
always."""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import re
import sys
import time
import warnings
from array import array
from datetime import datetime

from torch.autograd import profiler as _torch_profiler


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
                "projection_narrow_kernel", "window_attention_kernel")


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

    clear_spans()
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
    from ..ops import attention_kernel, gru_kernel, lstm_kernel, pileup_kernel

    counts = {name: getattr(module, name).launches
              for module in (lstm_kernel, gru_kernel, pileup_kernel,
                             attention_kernel)
              for name in module.KERNELS}
    return {name: count for name, count in counts.items() if count}


# ------------------------------------------------------------- spans
#
# A span is recorded as (name, start_ns, end_ns, parent, batch): the
# perf_counter_ns clock (benchmark/tracing.py ties that clock to the
# device's), the index in records() of the span open around it (None at
# the top), and the batch id its caller gave or, given none, the one of
# the span open around it (None outside a batch).  Nothing is recorded,
# and no clock read, unless a torch.profiler session is active.  One stack
# of open spans serves the process: spans nest as the served paths' one
# calling thread opens them.
#
# The records are kept as machine integers in one flat array, _FIELDS a
# span (the name by its id in _names, -1 for None, end 0 while the span
# is open), which the collector never walks: a list of tuples as long as
# a traced window's would lengthen every full collector pass it measures.

GC = "gc"
_FIELDS = 5
_names: list = []       # a name id's name
_name_ids: dict = {}
_store = array("q")
_open: list = []        # the recording spans, innermost last
_batch_ids = itertools.count()


def _name_id(name: str) -> int:
    i = _name_ids.get(name)
    if i is None:
        i = _name_ids[name] = len(_names)
        _names.append(name)
    return i


class _Span:
    __slots__ = ("name", "batch", "store", "index", "range", "gc_start")

    def __init__(self, name, batch):
        self.name = name
        self.batch = batch
        self.gc_start = None

    def __enter__(self):
        self.range = _torch_profiler.record_function(self.name)
        self.range.__enter__()
        outer = _open[-1] if _open else None
        if self.batch is None and outer is not None:
            self.batch = outer.batch
        parent = (outer.index if outer is not None
                  and outer.store is _store else -1)
        # a collector pass the tuple's allocation starts is recorded
        # before this span's slot, as the outer span's child
        _store.extend((_name_id(self.name), 0, 0, parent,
                       -1 if self.batch is None else self.batch))
        self.store = _store
        self.index = len(_store) // _FIELDS - 1
        if not _open:
            gc.callbacks.append(_collector_pass)
        _open.append(self)
        _store[self.index * _FIELDS + 1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        if not _open:
            gc.callbacks.remove(_collector_pass)
        self.store[self.index * _FIELDS + 2] = end
        self.range.__exit__(*exc)
        return False


def _collector_pass(phase, info):
    """gc.callbacks hook, installed while a span records: each collector
    pass becomes a child span `gc` of the innermost open span."""
    inner = _open[-1]
    if phase == "start":
        inner.gc_start = time.perf_counter_ns()
    elif inner.gc_start is not None:
        parent = inner.index if inner.store is _store else -1
        _store.extend((_name_id(GC), inner.gc_start, time.perf_counter_ns(),
                       parent, -1 if inner.batch is None else inner.batch))
        inner.gc_start = None


_OFF = contextlib.nullcontext()


def span(name: str, batch=None):
    """with span("runner.resolve.fetch"): ... records the block as a span,
    a child of the span open around it, and opens a
    torch.profiler.record_function range of the same name, while a
    profiler session is active; otherwise it costs one check.  batch: the
    caller's batch id (new_batch()); None takes the open span's."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, batch)


def new_batch():
    """A new batch id while spans record, else None."""
    if not _torch_profiler._is_profiler_enabled:
        return None
    return next(_batch_ids)


def clear_spans() -> None:
    """Forgets every recorded span, the device spans too (trace() does it
    when it starts)."""
    global _store
    _store = array("q")
    _device_pending.clear()
    _device_store.clear()


def records() -> list:
    """Every recorded span as (name, start_ns, end_ns, parent, batch), in
    the order they started (a collector pass where it ended; None in the
    slot of a span still open); parent indexes this list."""
    out = []
    for i in range(0, len(_store), _FIELDS):
        name, start, end, parent, batch = _store[i:i + _FIELDS]
        out.append((_names[name], start, end, None if parent < 0 else parent,
                    None if batch < 0 else batch) if end else None)
    return out


def spans() -> dict:
    """The leaf spans, those with no child but the collector's passes, as
    {name: [(start_s, end_s), ...]} in perf_counter seconds: the shape
    benchmark/tracing.py's Session.result takes for its host spans."""
    rows = records()
    parents = {r[3] for r in rows if r is not None and r[0] != GC}
    out = {}
    for i, r in enumerate(rows):
        if r is not None and r[0] != GC and i not in parents:
            out.setdefault(r[0], []).append((r[1] * 1e-9, r[2] * 1e-9))
    return out


def gc_spans() -> dict:
    """The collector's passes inside the spans, as {name of the innermost
    span open at the pass: [(start_s, end_s), ...]} in perf_counter
    seconds."""
    rows = records()
    out = {}
    for r in rows:
        if r is not None and r[0] == GC and r[3] is not None:
            out.setdefault(_names[_store[r[3] * _FIELDS]], []).append(
                (r[1] * 1e-9, r[2] * 1e-9))
    return out


# ------------------------------------------------------ device spans
#
# A device span is a pair of CUDA events recorded on the current stream
# around a launch, only while a torch.profiler session is active.  A pair
# waits in _device_pending, which holds only the pairs still in flight,
# until the next device span or device_spans() finds its end completed;
# its duration then goes into one flat array of seconds a name, which the
# collector does not walk, and its events back to _free_events for reuse.

_device_pending: collections.deque = collections.deque()
_device_store: dict = {}    # name id -> array("d") of seconds
_free_events: list = []


def _timing_event():
    if _free_events:
        return _free_events.pop()
    import torch

    return torch.cuda.Event(enable_timing=True)


def _resolve_device(block: bool) -> None:
    """Moves the pending pairs whose end has completed (all of them, waiting
    for each, with block) into _device_store, oldest first."""
    while _device_pending:
        name, start, end = _device_pending[0]
        if block:
            end.synchronize()
        elif not end.query():
            return
        _device_pending.popleft()
        _device_store.setdefault(name, array("d")).append(
            start.elapsed_time(end) * 1e-3)
        _free_events.extend((start, end))


class _DeviceSpan:
    __slots__ = ("name", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _resolve_device(block=False)
        self.start = _timing_event()
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = _timing_event()
        end.record()
        _device_pending.append((_name_id(self.name), self.start, end))
        return False


def device_span(name: str):
    """with device_span("transformer.attention"): launch(...) times the
    block's work on the current CUDA stream between two events, while a
    profiler session is active; otherwise it costs one check.  It records
    no host span."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _DeviceSpan(name)


def device_spans() -> dict:
    """Every device span's duration as {name: [seconds, ...]}, in the order
    they were recorded; waits for the ones still in flight."""
    _resolve_device(block=True)
    return {_names[name]: list(seconds)
            for name, seconds in _device_store.items()}


# ------------------------------------------------------ padded rows
#
# The rows each bucketing layer ran since the process started, always on:
# [real rows, padding rows] (InferenceRunner._bucket's, consensus_predict's
# bucket).

_ROWS = {"runner": [0, 0], "consensus": [0, 0]}


def count_rows(layer: str, real: int, bucket: int) -> None:
    rows = _ROWS[layer]
    rows[0] += real
    rows[1] += bucket - real


def padded_rows() -> dict:
    """{layer: (real rows, padding rows)} in this process."""
    return {layer: tuple(rows) for layer, rows in _ROWS.items()}


def padded_line(layer: str, since: tuple) -> str:
    """The layer's padding since the padded_rows()[layer] reading `since`,
    for a stage log line."""
    real, pad = (now - then for now, then
                 in zip(padded_rows()[layer], since))
    return (f"padded rows {pad} of {real + pad} "
            f"({100 * pad / max(1, real + pad):.1f}%)")


# --------------------------------------------------- ready resolves
#
# InferenceRunner._gather's calls since the process started, always on:
# [calls whose every block's device work, the copy to the host included,
# had completed when its wait began, calls].

_RESOLVES = [0, 0]


def count_resolve(ready: bool) -> None:
    _RESOLVES[0] += ready
    _RESOLVES[1] += 1


def resolve_ready() -> tuple:
    """(ready resolves, resolves) in this process."""
    return tuple(_RESOLVES)


def ready_line(since: tuple) -> str:
    """The resolves ready since the resolve_ready() reading `since`, for a
    stage log line."""
    ready, total = (now - then for now, then in zip(resolve_ready(), since))
    return (f"resolves ready {ready} of {total} "
            f"({100 * ready / max(1, total):.1f}%)")
