"""Host time of the transformer family's forward enqueue (the weights'
dtype pass, the stem, six encoder layers' launches, the pyramid and the
softmax), in ms: the mean self time of the port's `transformer.forward`
span a call over the traced window, the collector's passes inside it taken
out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("transformer.forward")
