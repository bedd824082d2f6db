"""Host time of `consensus_predict`'s padding of a batch (`np.zeros` and
the uint8 to float32 copy), in ms: the mean self time of the port's
`consensus.pad` span a call over the traced window, the collector's
passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("consensus.pad")
