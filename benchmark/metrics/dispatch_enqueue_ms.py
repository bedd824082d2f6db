"""Host time of `InferenceRunner.dispatch`'s enqueue (the upload, the
forward's launches and the event record, every device's block), in ms:
the mean self time of the port's `runner.dispatch.enqueue` span a call
over the traced window, the collector's passes inside it taken out."""

from benchmark.metrics.program_spans import self_ms


def read(r):
    return self_ms("runner.dispatch.enqueue")
