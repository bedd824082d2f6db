"""Exact int8 x int8 -> int32 matrix products for int8 serving.

The JAX package computes its int8 products outside the kernels with
dot_general/einsum and preferred_element_type=int32; these are their
counterparts.  Every sum is exact: the widest one (linear_1, K = 33*512)
stays below 2**31, while float32 would round it above 2**24.

On the CPU the product is an int32 torch.matmul.  On the card, a small
product (at most _FLOAT_MAX_MACS multiply-adds, tens of microseconds) with
K up to _FLOAT_EXACT_K is a float32 torch.matmul: int8 values and their
products are exact in float32 (and in TF32), and every partial sum of at
most 1024 products of magnitude at most 128 * 128 stays within 2**24,
where float32 holds every integer, so the sum is exact in any order.
cuBLASLt's int8 kernels refuse some such shapes (33 x 32 @ 32 x 128, the
static kernels' narrowest width, has no algorithm).  Other products run
torch._int_mm (cuBLASLt int8 -> int32), whose shape rules (more than 16
rows, K and N multiples of 8) are met by zero padding, which leaves every
sum unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_ROWS = 17      # torch._int_mm takes more than 16 rows
_ALIGN = 8          # ... and K, N multiples of 8
_FLOAT_EXACT_K = 2 ** 24 // (128 * 128)   # 1024
_FLOAT_MAX_MACS = 2 ** 30


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    M, K = a.shape
    N = b.shape[1]
    if K <= _FLOAT_EXACT_K and M * K * N <= _FLOAT_MAX_MACS:
        return (a.float() @ b.float()).to(torch.int32)
    pad_m = max(0, _MIN_ROWS - M)
    pad_k = -K % _ALIGN
    pad_n = -N % _ALIGN
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :N] if pad_m or pad_n else out
