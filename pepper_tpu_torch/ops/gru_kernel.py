"""The port's GRU kernels: hand-written CUDA kernels for Hopper and their
plain PyTorch twins, for the polish consensus model.

Each wrapper is the counterpart of the TPU kernel of the same name in
pepper_tpu/ops/gru_kernel.py (`gru_recurrence` of gru_recurrence_pallas):

  gru_direction_fused         one direction, the input projection fused in,
                              h0 in, (ys, hT) out (the float consensus)
  gru_direction_fused_static  the same with static int8 streams: int8 codes
                              round(h*127) out and a float32 hT (polish
                              --quantized)
  gru_recurrence              the recurrence over a precomputed xw, h0 in
                              (PEPPER_GRU_FUSED=0 PEPPER_GRU_KERNEL=1)

On a CUDA tensor a wrapper launches its kernel, built from csrc/<name>.cu
with nvcc for sm_90a at first use and bound through ctypes
(ops/cuda_build.py), and adds one to its `launches`; on a CPU tensor it
runs its `*_reference` twin, which does the same math in plain PyTorch.
There is no fallback from one to the other: a failed build or launch
raises.

All three share one recurrence core (csrc/gru_core.cuh), which picks its
body and the batch rows a block from B, H and the card's SM count; the two
fused kernels hand theirs a float32 scratch for the input projection of
all steps, which runs first (an f32 product for float x, an int8
tensor-core product for the static kernel's int8 x, whose int8 W_ih it
reads k-major: relaid once per weight tree on the served path,
models/quantize.py:polish_prepare_static, else at each launch).

The cell is torch.nn.GRU's (gru_cell, which models/rnn.py shares), with
f32 state and f32 sums; h is rounded to W_hh's dtype before the recurrent
product (to xw's dtype in gru_recurrence).  The kernels take the dtypes the polish
consensus hands them (consensus_predict in float32 or bfloat16) and refuse
others: float x with float32 weights; static float x with W_ih and W_hh of
its dtype; static int8 x with int8 W_ih and a float32 or bfloat16 W_hh.
Biases are float32, and h0 enters as float32.
"""

from __future__ import annotations

import os

import torch

from .cuda_build import (DTYPE_CODE, FLOATS, aligned, check_contiguous,
                         check_hidden, int8_codes, launch, ptr, relaid,
                         require_cuda, split_rows)
from .int8_matmul import int8_matmul

KERNELS = ("gru_direction_fused", "gru_direction_fused_static",
           "gru_recurrence")


def use_fused_gru(device) -> bool:
    """The fused-input-projection GRU path for tensors on `device`:
    PEPPER_GRU_FUSED=auto (the default) takes it on a CUDA device; 0 and 1
    force it off and on."""
    flag = os.environ.get("PEPPER_GRU_FUSED", "auto")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return torch.device(device).type == "cuda"


def use_pallas_gru() -> bool:
    """Opt-in (PEPPER_GRU_KERNEL=1): the unfused path runs the recurrence
    kernel (gru_direction_pallas) instead of models/rnn.py's gru_scan."""
    return os.environ.get("PEPPER_GRU_KERNEL", "0") == "1"


def _check_common(name, x_parts, w_ih_parts, b_ih, w_hh, b_hh, h0):
    """Shapes every direction kernel shares: 1-2 time-major parts
    (T, B, F_i), their (F_i, 3H) weights, (3H,) biases, (H, 3H) W_hh and a
    (B, H) h0."""
    H = w_hh.shape[0]
    if w_hh.shape != (H, 3 * H) or b_ih.numel() != 3 * H \
            or b_hh.numel() != 3 * H:
        raise ValueError(f"{name}: w_hh {tuple(w_hh.shape)}, b_ih "
                         f"{tuple(b_ih.shape)}, b_hh {tuple(b_hh.shape)} do "
                         f"not fit H={H}")
    if not 1 <= len(x_parts) <= 2 or len(w_ih_parts) != len(x_parts):
        raise ValueError(f"{name} takes one or two feature parts, got "
                         f"{len(x_parts)} x and {len(w_ih_parts)} w_ih")
    T, B = x_parts[0].shape[:2]
    for x, w in zip(x_parts, w_ih_parts):
        if x.dim() != 3 or x.shape[:2] != (T, B):
            raise ValueError(f"{name}: x part {tuple(x.shape)} is not "
                             f"(T={T}, B={B}, F)")
        if w.shape != (x.shape[2], 3 * H):
            raise ValueError(f"{name}: w_ih part {tuple(w.shape)} does not "
                             f"fit x part {tuple(x.shape)} and H={H}")
    if h0.shape != (B, H) or h0.dtype not in FLOATS:
        raise ValueError(f"{name}: h0 {tuple(h0.shape)} {h0.dtype} is not a "
                         f"float (B={B}, H={H})")
    for t in (b_ih, b_hh):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 biases, got {t.dtype}")
    check_hidden(H)


def gru_cell(xw, hw, h):
    """One torch.nn.GRU step from the gate sums: xw = x @ W_ih + b_ih and
    hw = h @ W_hh + b_hh, both (B, 3H), and the state h (B, H)."""
    xr, xz, xn = xw.chunk(3, dim=-1)
    hr, hz, hn = hw.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def recurrence_twin(xw, recurrent, h0, emit, out, reverse=False):
    """The loop every twin shares: xw (T, B, 3H) float32 gate inputs,
    recurrent(h) the (B, 3H) float32 hw of the f32 state h, out[t] =
    emit(h).  Returns the f32 state after the last step."""
    T = xw.shape[0]
    h = h0.float()
    for step in range(T):
        t = T - 1 - step if reverse else step
        h = gru_cell(xw[t], recurrent(h), h)
        out[t] = emit(h)
    return h


def _recurrent(w_hh, b_hh, h_dtype):
    """hw = bf(h) @ W_hh + b_hh in f32, bf rounding h to h_dtype."""
    w32, b32 = w_hh.float(), b_hh.float().reshape(-1)
    return lambda h: h.to(h_dtype).float() @ w32 + b32


def _float_projection(x_parts, w_ih_parts, b_ih):
    xw = None
    for x, w in zip(x_parts, w_ih_parts):
        part = x.float() @ w.float()
        xw = part if xw is None else xw + part
    return xw + b_ih.float().reshape(-1)


# ---------------------------------------------------------------------------
# gru_direction_fused


def gru_direction_fused_reference(x_parts, w_ih_parts, b_ih, w_hh, b_hh, h0,
                                  reverse=False):
    """Plain PyTorch twin of the kernel: same arguments, same dtype rules.
    The input projection of all steps is one f32 product up front; the loop
    over T carries the f32 h."""
    T, B, _ = x_parts[0].shape
    dtype = x_parts[0].dtype
    xw = _float_projection(x_parts, w_ih_parts, b_ih)
    out = torch.empty((T, B, w_hh.shape[0]), dtype=dtype, device=xw.device)
    recurrence_twin(xw, _recurrent(w_hh, b_hh, w_hh.dtype), h0,
                    lambda h: h.to(dtype), out, reverse)
    return out, (out[0] if reverse else out[-1])


def gru_direction_fused(x_parts, w_ih_parts, b_ih, w_hh, b_hh, h0,
                        reverse=False):
    """One GRU direction with the input projection fused in.

    x_parts: tuple of (T, B, F_i) time-major arrays, float32 or bfloat16,
    logically concatenated on the feature axis.  w_ih_parts: matching
    (F_i, 3H) float32 slices of the input weight.  b_ih, b_hh: (3H,)
    float32.  w_hh: (H, 3H) float32.  h0: (B, H), the carried hidden state.
    reverse=True runs the backward direction by indexing T-1-t.  Returns
    (ys (T, B, H) in natural order and x's dtype, hT = ys[-1], or ys[0]
    when reversed).  Any B; no padding."""
    x0 = x_parts[0]
    if x0.device.type == "cpu":
        return gru_direction_fused_reference(x_parts, w_ih_parts, b_ih, w_hh,
                                             b_hh, h0, reverse=reverse)
    require_cuda(x0, "gru_direction_fused")
    _check_common("gru_direction_fused", x_parts, w_ih_parts, b_ih, w_hh,
                  b_hh, h0)
    if x0.dtype not in FLOATS or any(x.dtype != x0.dtype for x in x_parts):
        raise TypeError("gru_direction_fused takes float32 or bfloat16 x "
                        f"parts of one dtype, got "
                        f"{[x.dtype for x in x_parts]}")
    for w in (*w_ih_parts, w_hh):
        if w.dtype != torch.float32:
            raise TypeError(f"gru_direction_fused takes float32 weights, got "
                            f"{w.dtype}")
    h0 = h0.float().contiguous()
    check_contiguous((*x_parts, *w_ih_parts, b_ih, w_hh, b_hh, h0),
                     x0.device, "gru_direction_fused")
    w_ih_parts = tuple(aligned(w) for w in w_ih_parts)
    w_hh = aligned(w_hh)
    T, B, F0 = x0.shape
    H = w_hh.shape[0]
    out = torch.empty((T, B, H), dtype=x0.dtype, device=x0.device)
    if T == 0 or B == 0:
        return out, h0.to(x0.dtype)
    # the input projection of all steps, x @ W_ih + b_ih in float32
    xw = torch.empty((T, B, 3 * H), dtype=torch.float32, device=x0.device)
    two = len(x_parts) > 1
    launch("gru_direction_fused", x0.device, DTYPE_CODE[x0.dtype], ptr(x0),
           ptr(x_parts[1] if two else None), ptr(w_ih_parts[0]),
           ptr(w_ih_parts[1] if two else None), F0,
           x_parts[1].shape[2] if two else 0, ptr(b_ih), ptr(w_hh),
           ptr(b_hh), ptr(h0), ptr(xw), ptr(out), T, B, H,
           int(bool(reverse)))
    gru_direction_fused.launches += 1
    return out, (out[0] if reverse else out[-1])


gru_direction_fused.launches = 0


def bigru_fused(x_parts, params, h0):
    """Bidirectional fused GRU over time-major feature parts.  h0: (B, 2, H)
    carried hidden ([:, 0] forward, [:, 1] backward).  Returns (fwd
    (T, B, H), bwd (T, B, H), hidden_out (B, 2, H))."""
    fwd, hf = gru_direction_fused(
        x_parts, split_rows(params["w_ih_f"], x_parts), params["b_ih_f"],
        params["w_hh_f"], params["b_hh_f"], h0[:, 0])
    bwd, hb = gru_direction_fused(
        x_parts, split_rows(params["w_ih_b"], x_parts), params["b_ih_b"],
        params["w_hh_b"], params["b_hh_b"], h0[:, 1], reverse=True)
    return fwd, bwd, torch.stack([hf, hb], dim=1)


# ---------------------------------------------------------------------------
# gru_direction_fused_static


def gru_direction_fused_static_reference(x_parts, w_ih_parts, b_ih, w_hh,
                                         b_hh, h0, acc_scale=None,
                                         reverse=False):
    """Plain PyTorch twin of the static kernel, same arguments.  Float x:
    one f32 input projection up front.  int8 x: the int32 products of all
    parts summed, then one rescale by acc_scale.  Emits round(h*127) codes
    and returns the f32 state after the last step."""
    T, B, _ = x_parts[0].shape
    if x_parts[0].dtype == torch.int8:
        acc = None
        for x, w in zip(x_parts, w_ih_parts):
            part = int8_matmul(x.reshape(T * B, -1), w)
            acc = part if acc is None else acc + part
        xw = (acc.reshape(T, B, -1).float() * acc_scale.float().reshape(-1)
              + b_ih.float().reshape(-1))
    else:
        xw = _float_projection(x_parts, w_ih_parts, b_ih)
    out = torch.empty((T, B, w_hh.shape[0]), dtype=torch.int8,
                      device=xw.device)
    hT = recurrence_twin(xw, _recurrent(w_hh, b_hh, w_hh.dtype), h0,
                         int8_codes, out, reverse)
    return out, hT


def _check_static(x_parts, w_ih_parts, w_hh, acc_scale):
    x_dtype = x_parts[0].dtype
    if any(x.dtype != x_dtype for x in x_parts):
        raise TypeError("gru_direction_fused_static takes x parts of one "
                        f"dtype, got {[x.dtype for x in x_parts]}")
    if any(w.dtype != x_dtype for w in w_ih_parts):
        raise TypeError(f"w_ih parts must have x's dtype {x_dtype}")
    H = w_hh.shape[0]
    if x_dtype == torch.int8:
        if acc_scale is None or acc_scale.numel() != 3 * H:
            raise ValueError("int8 x takes an acc_scale of 3H values")
        if any(x.shape[2] % 4 for x in x_parts):
            raise ValueError("int8 x parts take a multiple of 4 features")
        if any(x.data_ptr() % 4 for x in x_parts):
            raise ValueError("int8 x parts must be 4-byte aligned")
        if w_hh.dtype not in FLOATS:
            raise TypeError(f"int8 x takes a float32 or bfloat16 w_hh, got "
                            f"{w_hh.dtype}")
    elif x_dtype in FLOATS:
        if acc_scale is not None:
            raise ValueError("acc_scale is for int8 x only")
        if w_hh.dtype != x_dtype:
            raise TypeError(f"float x takes a w_hh of its dtype {x_dtype}, "
                            f"got {w_hh.dtype}")
    else:
        raise TypeError(f"gru_direction_fused_static takes float32, bfloat16 "
                        f"or int8 x, got {x_dtype}")


def gru_direction_fused_static(x_parts, w_ih_parts, b_ih, w_hh, b_hh, h0,
                               acc_scale=None, reverse=False):
    """One GRU direction with static-int8 streams.

    x_parts: tuple of (T, B, F_i) arrays, all int8 codes (scale 1/127) or
    all float.  For int8 x, w_ih_parts are int8 per-output-column
    quantized weights and acc_scale is the (3H,) combined rescale
    (w_scale/127) applied once to the summed int32 accumulator, and w_hh
    is float32 or bfloat16; for float x, w_ih_parts and w_hh share its
    dtype.  b_ih, b_hh: (3H,) float32.  h0: (B, H) float carry.  Returns
    (ys (T, B, H) int8 codes in natural order, hT (B, H) float32).  An
    int8 W_ih reaches the kernel k-major: the copy cuda_build.keep_relaid
    kept, or relaid at this launch."""
    x0 = x_parts[0]
    if x0.device.type == "cpu":
        return gru_direction_fused_static_reference(
            x_parts, w_ih_parts, b_ih, w_hh, b_hh, h0, acc_scale=acc_scale,
            reverse=reverse)
    require_cuda(x0, "gru_direction_fused_static")
    _check_common("gru_direction_fused_static", x_parts, w_ih_parts, b_ih,
                  w_hh, b_hh, h0)
    _check_static(x_parts, w_ih_parts, w_hh, acc_scale)
    T, B, F0 = x0.shape
    H = w_hh.shape[0]
    two = len(x_parts) > 1
    if x0.dtype == torch.int8:
        w0, w1 = relaid(w_ih_parts), None
    else:
        w0 = aligned(w_ih_parts[0])
        w1 = aligned(w_ih_parts[1]) if two else None
    h0 = h0.float().contiguous()
    scale = None if acc_scale is None else \
        acc_scale.reshape(-1).float().contiguous()
    # the core reads a float32 W_hh; a bfloat16 one is widened (exactly),
    # and h rounded to bfloat16 before the product, by whh_dtype
    w_hh32 = aligned(w_hh.float().contiguous())
    check_contiguous((*x_parts, w0, b_ih, w_hh32, b_hh, h0)
                     + ((w1,) if w1 is not None else ())
                     + ((scale,) if scale is not None else ()), x0.device,
                     "gru_direction_fused_static")
    out = torch.empty((T, B, H), dtype=torch.int8, device=x0.device)
    h_out = torch.empty((B, H), dtype=torch.float32, device=x0.device)
    if T == 0 or B == 0:
        return out, h0
    xw = torch.empty((T, B, 3 * H), dtype=torch.float32, device=x0.device)
    launch("gru_direction_fused_static", x0.device, DTYPE_CODE[x0.dtype],
           DTYPE_CODE[w_hh.dtype], ptr(x0), ptr(x_parts[1] if two else None),
           ptr(w0), ptr(w1), F0, x_parts[1].shape[2] if two else 0,
           ptr(scale), ptr(b_ih), ptr(w_hh32), ptr(b_hh), ptr(h0), ptr(xw),
           ptr(out), ptr(h_out), T, B, H, int(bool(reverse)))
    gru_direction_fused_static.launches += 1
    return out, h_out


gru_direction_fused_static.launches = 0


def bigru_fused_static(x_parts, params, h0, acc_scale=None):
    """Bidirectional static-int8 fused GRU.  h0: (B, 2, H) float carry.
    acc_scale: (as_f, as_b) per-column fused rescales when the x_parts are
    int8 codes, None for float inputs.  Returns (fwd_q (T, B, H) int8,
    bwd_q (T, B, H) int8, hidden_out (B, 2, H) float32)."""
    scale_f, scale_b = acc_scale if acc_scale is not None else (None, None)
    fwd, hf = gru_direction_fused_static(
        x_parts, split_rows(params["w_ih_f"], x_parts), params["b_ih_f"],
        params["w_hh_f"], params["b_hh_f"], h0[:, 0], acc_scale=scale_f)
    bwd, hb = gru_direction_fused_static(
        x_parts, split_rows(params["w_ih_b"], x_parts), params["b_ih_b"],
        params["w_hh_b"], params["b_hh_b"], h0[:, 1], acc_scale=scale_b,
        reverse=True)
    return fwd, bwd, torch.stack([hf, hb], dim=1)


# ---------------------------------------------------------------------------
# gru_recurrence


def gru_recurrence_reference(xw, w_hh, b_hh, h0):
    """Plain twin of the recurrence kernel: f32 state, h rounded to xw's
    dtype before the recurrent product, output in xw's dtype."""
    T, B, _ = xw.shape
    dtype = xw.dtype
    out = torch.empty((T, B, w_hh.shape[0]), dtype=dtype, device=xw.device)
    recurrence_twin(xw.float(), _recurrent(w_hh, b_hh, dtype), h0,
                    lambda h: h.to(dtype), out)
    return out


def gru_recurrence(xw, w_hh, b_hh, h0):
    """GRU recurrence over precomputed input projections, forward only
    (the caller flips for the backward direction).  xw: (T, B, 3H) float32
    or bfloat16 (x @ W_ih + b_ih); w_hh: (H, 3H) and b_hh: (3H,) float32;
    h0: (B, H).  Returns (T, B, H) in xw's dtype."""
    if xw.device.type == "cpu":
        return gru_recurrence_reference(xw, w_hh, b_hh, h0)
    require_cuda(xw, "gru_recurrence")
    if xw.dtype not in FLOATS or w_hh.dtype != torch.float32 \
            or b_hh.dtype != torch.float32:
        raise TypeError(f"gru_recurrence takes float32 or bfloat16 xw and "
                        f"float32 w_hh and b_hh, got {xw.dtype}, "
                        f"{w_hh.dtype} and {b_hh.dtype}")
    H = w_hh.shape[0]
    if xw.dim() != 3 or xw.shape[2] != 3 * H or w_hh.shape != (H, 3 * H) \
            or b_hh.numel() != 3 * H or h0.shape != (xw.shape[1], H):
        raise ValueError(f"xw {tuple(xw.shape)} / w_hh {tuple(w_hh.shape)} / "
                         f"b_hh {tuple(b_hh.shape)} / h0 {tuple(h0.shape)} "
                         f"are not (T, B, 3H) / (H, 3H) / (3H,) / (B, H)")
    check_hidden(H)
    h0 = h0.float().contiguous()
    check_contiguous((xw, w_hh, b_hh, h0), xw.device, "gru_recurrence")
    w_hh = aligned(w_hh)
    T, B, _ = xw.shape
    out = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    if T == 0 or B == 0:
        return out
    launch("gru_recurrence", xw.device, DTYPE_CODE[xw.dtype], ptr(xw),
           ptr(w_hh), ptr(b_hh), ptr(h0), ptr(out), T, B, H)
    gru_recurrence.launches += 1
    return out


gru_recurrence.launches = 0


def gru_direction_pallas(x, w_ih, w_hh, b_ih, b_hh, h0, reverse=False):
    """One GRU direction via the recurrence kernel; matches
    models/rnn.py gru_scan.  x: (B, T, F); h0: (B, H).  The input
    projection is one product in the promoted dtype of x and w_ih, as
    jnp.einsum does.  Returns (outputs (B, T, H), hT (B, H))."""
    xs = x.flip(1) if reverse else x
    dtype = torch.promote_types(x.dtype, w_ih.dtype)
    xw = torch.einsum("btf,fg->tbg", xs.to(dtype), w_ih.to(dtype)) + b_ih
    ys = gru_recurrence(xw.contiguous(), w_hh, b_hh, h0)
    hT = ys[-1]
    ys = ys.transpose(0, 1)
    if reverse:
        ys = ys.flip(1)
    return ys, hT
