"""Host time of `InferenceRunner.dispatch`'s stack (the image list and
`np.stack`), in ms: the mean self time of the port's
`runner.dispatch.stack` span a call over the traced window, the
collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("runner.dispatch.stack")
