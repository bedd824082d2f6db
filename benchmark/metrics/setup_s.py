"""Seconds from the harness's start to the measured window: importing,
the CUDA context, loading or building the kernels, the weights and inputs
from the seed, the program's set-up and the warm-up."""


def read(r):
    return r.setup_s
