"""The transformer window classifier's self-attention: a hand-written CUDA
kernel for Hopper and its plain PyTorch twin.

One encoder layer's attention (models/alternates.py:_mha) from the packed
qkv (B, T, 3D), the in-projection's bias already added, to the heads'
concatenated output (B, T, D) before out_proj:

  window_attention            the kernel (csrc/window_attention.cu) at the
                              variant mode's shapes, T = 33 and 8 heads of
                              width 13; counts `launches`.  It replaces no
                              TPU kernel: the JAX package runs this
                              attention as plain XLA ops
  window_attention_reference  its twin: the eager math the transformer ran
                              before the kernel, unchanged (float32 softmax,
                              the products in the input dtype)
  attention                   the route: the kernel for a CUDA tensor of its
                              shapes that no gradient flows through, the
                              twin for anything else (the CPU, other window
                              shapes, the HP mode, training)

The kernel computes every score, the softmax and the weighted sum in
float32 and rounds the output to the input dtype once; the twin rounds the
scores and the weights to a bfloat16 input's dtype as it goes, so the two
agree to a few bfloat16 ulps there and to float32 rounding in float32.
Inside a profiler session each launch is a device-timed span,
`transformer.attention` (utils/profiling.py:device_span).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .cuda_build import (DTYPE_CODE, FLOATS, aligned, check_contiguous,
                         launch, ptr, require_cuda)

KERNELS = ("window_attention",)
# the wrapper's library (ops/cuda_build.py), csrc/window_attention.cu
LIBRARIES = {"window_attention": "window_attention"}
WINDOW = 33             # the kernel's positions a window
HEADS = 8               # and heads, of width WIDTH
WIDTH = 13
SPAN = "transformer.attention"


def window_attention_reference(qkv, num_heads):
    """qkv (B, T, 3D) -> (B, T, D): per head, softmax(q k^T / sqrt(D/heads))
    v, the softmax in float32 at least, everything else in qkv's dtype."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // num_heads
    q, k, v = qkv.split(D, dim=-1)

    def heads(a):
        return a.reshape(B, T, num_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    attn = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.sqrt(
        torch.tensor(hd, dtype=qkv.dtype))
    # the softmax in float32 at least (bfloat16 serving); float64 stays
    attn = torch.softmax(
        attn.to(torch.promote_types(attn.dtype, torch.float32)),
        dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    return out.transpose(1, 2).reshape(B, T, D)


def kernel_takes(qkv, num_heads) -> bool:
    """Whether window_attention takes this qkv: the kernel's shapes and a
    float dtype (on any device)."""
    return (qkv.dim() == 3 and qkv.shape[1] == WINDOW
            and qkv.shape[2] == 3 * HEADS * WIDTH and num_heads == HEADS
            and qkv.dtype in FLOATS)


def window_attention(qkv, num_heads=HEADS):
    """The kernel's attention: qkv (B, 33, 312) float32 or bfloat16 on a
    CUDA device -> (B, 33, 104) of its dtype; raises on shapes it does not
    take.  It has no backward."""
    require_cuda(qkv, "window_attention")
    if not kernel_takes(qkv, num_heads):
        raise ValueError(
            f"window_attention takes (B, {WINDOW}, {3 * HEADS * WIDTH}) "
            f"float32 or bfloat16 with {HEADS} heads, got "
            f"{tuple(qkv.shape)} {qkv.dtype} with {num_heads}")
    check_contiguous((qkv,), qkv.device, "window_attention")
    qkv = aligned(qkv)
    B = qkv.shape[0]
    out = torch.empty((B, WINDOW, HEADS * WIDTH), dtype=qkv.dtype,
                      device=qkv.device)
    if B == 0:
        return out
    with profiling.device_span(SPAN):
        launch(LIBRARIES["window_attention"], qkv.device,
               DTYPE_CODE[qkv.dtype], ptr(qkv), ptr(out), B)
    window_attention.launches += 1
    return out


window_attention.launches = 0


def attention(qkv, num_heads):
    """The route of every forward: the kernel for a CUDA qkv it takes that
    no gradient flows through, else the twin (which training
    differentiates)."""
    if (qkv.device.type == "cuda" and kernel_takes(qkv, num_heads)
            and not (qkv.requires_grad and torch.is_grad_enabled())):
        return window_attention(qkv, num_heads)
    return window_attention_reference(qkv, num_heads)
