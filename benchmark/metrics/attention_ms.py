"""Device time of the transformer's attention a batch, in ms: the port's
`transformer.attention` device spans (one a layer's attention launch,
timed between CUDA events on its stream) over the traced window, summed,
over the batches dispatched in it."""

from benchmark.metrics.device_spans import seconds


def read(r):
    times = seconds("transformer.attention")
    if not times or not r.dispatched:
        return None
    return 1e3 * sum(times) / r.dispatched
