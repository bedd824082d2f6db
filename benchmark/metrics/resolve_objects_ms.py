"""Host time of `InferenceRunner.resolve`'s objects (the batch's
`CandidatePrediction` list), in ms: the mean self time of the port's
`runner.resolve.objects` span a call over the traced window, the
collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("runner.resolve.objects")
