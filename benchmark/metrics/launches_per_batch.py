"""The port's kernel launches a batch: the change in
`utils/profiling.py:kernel_launches()` over the traced session, over the
batches dispatched in it."""


def read(r):
    if not r.dispatched:
        return None
    return r.counters["launches"] / r.dispatched
