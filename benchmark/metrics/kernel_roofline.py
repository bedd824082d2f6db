"""The forward's share of its roofline, in %: the least time its whole
work could take (benchmark/peaks.py's bound of the operations and bytes
that benchmark/work/ counts from the model's shapes, one bound a device
block) over the devices' kernel-busy time in the traced window."""

from benchmark.peaks import bound_s


def read(r):
    if not r.items or r.trace is None or not r.trace.kernel_busy_s:
        return None
    rows = r.traffic["rows_per_device"]
    flops, nbytes = r.work.block_work(r.config, rows, r.itemsize)
    blocks = r.items / rows
    return 100.0 * blocks * bound_s(flops, nbytes, r.peak_flops) / \
        r.trace.kernel_busy_s
