"""What the per-layer metrics of the program's phases read: the port's own
spans (`pepper_tpu_torch/utils/profiling.py`: `spans()`, the leaf spans,
and `gc_spans()`, the collector's passes inside them), which the program
records only while a torch.profiler session is active, in a run the traced
window's.  Without that session, or from a program that records no spans,
each reads None."""


def _profiling():
    from pepper_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "gc_spans") else None


def _seconds(intervals) -> float:
    return sum(end - start for start, end in intervals)


def self_ms(name: str):
    """Mean self time of the span's calls, in ms: each call's duration
    less the collector's passes inside it."""
    profiling = _profiling()
    calls = profiling.spans().get(name) if profiling else None
    if not calls:
        return None
    passes = profiling.gc_spans().get(name, [])
    return 1e3 * (_seconds(calls) - _seconds(passes)) / len(calls)


def gc_ms(batches: int):
    """The collector's passes inside any of the program's spans, in ms,
    over the batches."""
    profiling = _profiling()
    if profiling is None or not batches or not profiling.spans():
        return None
    return 1e3 * sum(map(_seconds, profiling.gc_spans().values())) / batches
