"""The whole step's share of the chip's peak, in %: the model's operations
(benchmark/work/) times the items completed in the window, over the
window's seconds, the devices and the peak of the cell's compute dtype."""


def read(r):
    if not r.items or r.trace is None:
        return None
    flops = r.work.flops_per_item(r.config) * r.items
    return 100.0 * flops / (r.window_s * r.devices * r.peak_flops)
