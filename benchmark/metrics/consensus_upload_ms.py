"""Host time of `consensus_predict`'s upload of a batch (the pageable
`.to(device)`), in ms: the mean self time of the port's
`consensus.upload` span a call over the traced window, the collector's
passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("consensus.upload")
