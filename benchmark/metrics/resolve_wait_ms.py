"""Host time of `InferenceRunner.resolve`'s wait on the batch's event
(`event.synchronize()`), in ms: the mean self time of the port's
`runner.resolve.wait` span a call over the traced window, the
collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("runner.resolve.wait")
