"""Chunks labelled in the measured window over its seconds."""


def read(r):
    return r.items / r.window_s if r.items else None
