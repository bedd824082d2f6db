"""The collector's passes inside the port's spans, in ms a batch: every
`gc` child span (`pepper_tpu_torch/utils/profiling.py:gc_spans()`) of the
traced window, summed, over the batches dispatched in it."""

from benchmark.metrics.program_spans import gc_ms


def read(r):
    return gc_ms(r.dispatched)
