"""The yardstick's peaks and bound arithmetic, frozen.

Copied from chip_smoke.py (the PEAK_* constants at its lines 333-337 and
`bound_ms` at 472-473, as of the commit that added this benchmark), so
that a later change to chip_smoke.py cannot move what the benchmark's
roofline and mfu shares are measured against.  Published dense rates of
one NVIDIA H100 SXM at its full 700 W power limit; a run prints the
card's power limit beside its numbers.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # dense TF32 tensor-core peak
PEAK_INT8_OPS = 1979e12        # dense int8 tensor-core peak
PEAK_BYTES = 3.35e12           # HBM3

# the names a configuration file uses for the peak of a compute dtype
PEAKS = {
    "bf16_tensor": PEAK_BF16_FLOPS,
    "tf32_tensor": PEAK_TF32_FLOPS,
    "f32_fma": PEAK_F32_FLOPS,
    "int8_tensor": PEAK_INT8_OPS,
}


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak and the bytes over the memory bandwidth (chip_smoke.py's
    `bound_ms`, in seconds)."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
