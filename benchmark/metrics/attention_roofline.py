"""The attention kernel's share of its roofline, in %: the least time one
launch's work could take (benchmark/peaks.py's bound of the operations and
bytes that the configuration's work module counts in `attention_work`, a
full bucket of the traffic's rows) times the launches, over the launches'
device time (the port's `transformer.attention` device spans)."""

from benchmark.metrics.device_spans import seconds
from benchmark.peaks import bound_s


def read(r):
    times = seconds("transformer.attention")
    if not times or not hasattr(r.work, "attention_work"):
        return None
    flops, nbytes = r.work.attention_work(
        r.config, r.traffic["rows_per_device"], r.itemsize)
    return 100.0 * len(times) * bound_s(flops, nbytes, r.peak_flops) / \
        sum(times)
