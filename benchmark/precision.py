"""The reference's precision.  Products run in float32 with TF32 off; a
control of the comparison computes the same reference with every
product's operands first rounded to a lower precision:

  "tf32"  10 mantissa bits, round to nearest even (a TF32 tensor-core
          product's operands)
  "fp8"   float8 e4m3, each operand scaled by its largest magnitude to
          the format's 448 first (a per-tensor scaled fp8 product)
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest float8 e4m3 value of x scaled to 448, scaled
    back, as float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDING = {"tf32": round_tf32, "fp8": round_fp8}


def mm(a: torch.Tensor, b: torch.Tensor, precision: str | None = None):
    """a @ b in float32, the operands rounded to `precision` first."""
    if precision is not None:
        a, b = ROUNDING[precision](a), ROUNDING[precision](b)
    return a @ b


@contextlib.contextmanager
def exact_float32():
    """TF32 off for every float32 product inside."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
