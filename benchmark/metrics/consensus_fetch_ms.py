"""Host time of `consensus_predict`'s fetch of a batch (labels' and
phred's `.cpu().numpy()`, which waits for the device), in ms: the mean
self time of the port's `consensus.fetch` span a call over the traced
window, the collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("consensus.fetch")
