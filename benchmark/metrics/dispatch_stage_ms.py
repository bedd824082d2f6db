"""Host time of `InferenceRunner.dispatch`'s staging (the bucket, the
pinned buffer, the copy into it and the zero padding), in ms: the mean
self time of the port's `runner.dispatch.stage` span a call over the
traced window, the collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("runner.dispatch.stage")
