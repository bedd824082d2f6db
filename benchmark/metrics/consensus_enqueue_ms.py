"""Host time of `consensus_predict`'s enqueue of a batch (`scan_fn`: the
19 windows' launches and the epilogue), in ms: the mean self time of the
port's `consensus.enqueue` span a call over the traced window, the
collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("consensus.enqueue")
