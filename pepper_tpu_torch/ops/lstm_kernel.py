"""The port's LSTM kernels: hand-written CUDA kernels for Hopper and their
plain PyTorch twins.

Each wrapper is the counterpart of the TPU kernel of the same name in
pepper_tpu/ops/lstm_kernel.py (`lstm_recurrence` of
lstm_recurrence_pallas):

  lstm_direction_fused         one direction, the input projection fused in
  bilstm_dual_fused            both directions of it in one launch
  lstm_direction_fused_static  one direction with static int8 streams (the
                               static int8 serving modes)
  lstm_recurrence              the recurrence over a precomputed xw (the
                               dynamic int8 serving mode, and
                               bilstm_pallas, the unfused biLSTM)

On a CUDA tensor a wrapper launches its kernel, built from csrc/<name>.cu
with nvcc for sm_90a at first use and bound through ctypes
(ops/cuda_build.py), and adds one to its `launches`; on a CPU tensor it
runs its `*_reference` twin, which does the same math in plain PyTorch.
There is no fallback from one to the other: a failed build or launch
raises.

The float kernels compute, per step, gates = f32(b) + sum_i x_i[t] @ W_ih_i
+ bf(h) @ W_hh with f32 accumulation and f32 h/c state, where bf(h) is h
rounded to the weight dtype; h is emitted in the input dtype.  The bias is
upcast from whatever dtype the caller holds it in (transducer_infer casts
every param to the compute dtype first, as the JAX package does).  All
three float kernels run on the tensor cores (csrc/lstm_core.cuh): bfloat16
products directly, float32 ones as three TF32 products each (3xTF32,
within the twin's 1e-5).  bfloat16 inputs wider than FUSED_X_MAX
features, and float32 inputs of any width, are first projected into a
float32 xw scratch that the wrapper allocates.

The static kernel's int8 products are exact int32 sums with one float32
rescale, and its int8 codes are round(h*127), round-half-to-even.  Every
combination it takes, with int8 codes out or h in float32 or bfloat16,
runs on the same core, on the tensor cores for the int8 products too, a
float32 W_hh on the float32 core's codes kind.  bfloat16 x of at most
FUSED_X_MAX features joins the recurrence's step; other x (int8, wider
bfloat16, and float32 of any width) is projected first into a float32 xw
scratch the wrapper allocates (_static_scratch).  Its int8 weights are
read k-major: the
served path relays each weight once per weight tree
(models/quantize.py:prepare_static, cuda_build.keep_relaid), and a launch
handed a weight that has no kept copy relays it then.
"""

from __future__ import annotations

import os

import torch

# build_kernel stays importable from here
from .cuda_build import (  # noqa: F401
    DTYPE_CODE, FLOATS, aligned, build_kernel, check_contiguous,
    check_hidden, int8_codes, launch, ptr, relaid, require_cuda, split_rows)
from .int8_matmul import int8_matmul

KERNELS = ("lstm_direction_fused", "bilstm_dual_fused",
           "lstm_direction_fused_static", "lstm_recurrence")
# kXMax in csrc/lstm_core.cuh: bfloat16 feature parts of at most this many
# features in all join the step's product, in the float kernels and the
# static one; wider ones (and float32 ones of any width) are projected
# first, into a float32 xw scratch
FUSED_X_MAX = 32


def _check_parts(x_parts, w_ih_parts, H) -> None:
    """1-2 time-major parts (T, B, F_i) and their (F_i, 4H) weights."""
    if not 1 <= len(x_parts) <= 2 or len(w_ih_parts) != len(x_parts):
        raise ValueError("the kernel takes one or two feature parts, "
                         f"got {len(x_parts)} x and {len(w_ih_parts)} w_ih")
    T, B = x_parts[0].shape[:2]
    for x, w in zip(x_parts, w_ih_parts):
        if x.dim() != 3 or x.shape[:2] != (T, B):
            raise ValueError(f"x part {tuple(x.shape)} is not "
                             f"(T={T}, B={B}, F)")
        if w.shape != (x.shape[2], 4 * H):
            raise ValueError(f"w_ih part {tuple(w.shape)} does not fit "
                             f"x part {tuple(x.shape)} and H={H}")


def _recurrence_twin(xw, recurrent, emit, out, reverse=False):
    """The loop every twin shares: xw (T, B, 4H) float32 gate inputs,
    recurrent(h) the (B, 4H) float32 recurrent term of the f32 state h,
    out[t] = emit(h)."""
    T, B, _ = xw.shape
    h = torch.zeros((B, out.shape[2]), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    for step in range(T):
        t = T - 1 - step if reverse else step
        gates = xw[t] + recurrent(h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = emit(h)
    return out


def _float_recurrent(w_hh):
    w32 = w_hh.float()
    return lambda h: h.to(w_hh.dtype).float() @ w32


# ---------------------------------------------------------------------------
# lstm_direction_fused and bilstm_dual_fused


def lstm_direction_fused_reference(x_parts, w_ih_parts, b, w_hh,
                                   reverse=False):
    """Plain PyTorch twin of the kernel: same arguments, same dtype rules.
    The input projection of all steps is one f32 product up front; the
    loop over T carries f32 h and c."""
    T, B, _ = x_parts[0].shape
    dtype = x_parts[0].dtype
    xw = b.float()
    for x, w in zip(x_parts, w_ih_parts):
        xw = xw + x.float() @ w.float()          # (T, B, 4H)
    out = torch.empty((T, B, w_hh.shape[0]), dtype=dtype, device=xw.device)
    return _recurrence_twin(xw, _float_recurrent(w_hh),
                            lambda h: h.to(dtype), out, reverse)


def _check_kernel_args(x_parts, w_ih_parts, b, w_hh):
    x0 = x_parts[0]
    dtype = x0.dtype
    if dtype not in FLOATS:
        raise TypeError(f"lstm_direction_fused takes float32 or bfloat16, "
                        f"got {dtype}")
    H = w_hh.shape[0]
    if w_hh.shape != (H, 4 * H) or b.shape != (4 * H,):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} / b {tuple(b.shape)} "
                         f"do not fit H={H}")
    _check_parts(x_parts, w_ih_parts, H)
    for t in (*x_parts, *w_ih_parts, b, w_hh):
        if t.dtype != dtype:
            raise TypeError("x, w_ih, b and w_hh must share one dtype; got "
                            f"{t.dtype} beside {dtype}")
    check_contiguous((*x_parts, *w_ih_parts, b, w_hh), x0.device,
                     "lstm_direction_fused")


def _projection_scratch(x_parts, H):
    """The float32 xw (T, B, 4H) that the float kernels project their
    input into first: every float32 input, and bfloat16 inputs of more
    than FUSED_X_MAX features; None where the features join the step's
    product."""
    x0 = x_parts[0]
    if (x0.dtype == torch.bfloat16
            and sum(x.shape[2] for x in x_parts) <= FUSED_X_MAX):
        return None
    return torch.empty((*x0.shape[:2], 4 * H), dtype=torch.float32,
                       device=x0.device)


def lstm_direction_fused(x_parts, w_ih_parts, b, w_hh, reverse=False):
    """One LSTM direction with the input projection fused in.

    x_parts: tuple of (T, B, F_i) time-major arrays, logically
    concatenated on the feature axis.  w_ih_parts: matching (F_i, 4H)
    slices of the input weight.  b: (4H,).  w_hh: (H, 4H).  reverse=True
    runs the backward direction by indexing T-1-t.  Returns (T, B, H) in
    natural order, in the dtype of x.  Any B; no padding."""
    x0 = x_parts[0]
    if x0.device.type == "cpu":
        return lstm_direction_fused_reference(x_parts, w_ih_parts, b, w_hh,
                                              reverse=reverse)
    require_cuda(x0, "lstm_direction_fused")
    _check_kernel_args(x_parts, w_ih_parts, b, w_hh)
    T, B, F0 = x0.shape
    H = w_hh.shape[0]
    check_hidden(H)
    out = torch.empty((T, B, H), dtype=x0.dtype, device=x0.device)
    if T == 0 or B == 0:
        return out
    w_ih_parts = tuple(aligned(w) for w in w_ih_parts)
    w_hh = aligned(w_hh)
    x1, w1 = (x_parts[1], w_ih_parts[1]) if len(x_parts) > 1 else (None,
                                                                    None)
    xw = _projection_scratch(x_parts, H)
    launch("lstm_direction_fused", x0.device, DTYPE_CODE[x0.dtype],
           ptr(x0), ptr(x1), ptr(w_ih_parts[0]), ptr(w1), F0,
           0 if x1 is None else x1.shape[2], ptr(b), ptr(w_hh), ptr(xw),
           ptr(out), T, B, H, int(bool(reverse)))
    lstm_direction_fused.launches += 1
    return out


lstm_direction_fused.launches = 0


def bilstm_dual_fused_reference(x_parts, wf_parts, wb_parts, b_f, b_b,
                                w_hh_f, w_hh_b):
    """Plain twin: the two directions as two lstm_direction_fused twins."""
    return (lstm_direction_fused_reference(x_parts, wf_parts, b_f, w_hh_f),
            lstm_direction_fused_reference(x_parts, wb_parts, b_b, w_hh_b,
                                           reverse=True))


def bilstm_dual_fused(x_parts, wf_parts, wb_parts, b_f, b_b, w_hh_f,
                      w_hh_b):
    """Both directions of lstm_direction_fused in one launch.  x_parts:
    tuple of (T, B, F_i) time-major arrays; wf_parts/wb_parts: the forward
    and backward (F_i, 4H) weight slices.  Returns (fwd, bwd), each
    (T, B, H) in natural order."""
    x0 = x_parts[0]
    if x0.device.type == "cpu":
        return bilstm_dual_fused_reference(x_parts, wf_parts, wb_parts, b_f,
                                           b_b, w_hh_f, w_hh_b)
    require_cuda(x0, "bilstm_dual_fused")
    _check_kernel_args(x_parts, wf_parts, b_f, w_hh_f)
    _check_kernel_args(x_parts, wb_parts, b_b, w_hh_b)
    T, B, F0 = x0.shape
    H = w_hh_f.shape[0]
    if w_hh_b.shape != w_hh_f.shape:
        raise ValueError(f"w_hh_f {tuple(w_hh_f.shape)} and w_hh_b "
                         f"{tuple(w_hh_b.shape)} differ")
    check_hidden(H)
    out_f = torch.empty((T, B, H), dtype=x0.dtype, device=x0.device)
    out_b = torch.empty_like(out_f)
    if T == 0 or B == 0:
        return out_f, out_b
    wf_parts = tuple(aligned(w) for w in wf_parts)
    wb_parts = tuple(aligned(w) for w in wb_parts)
    w_hh_f, w_hh_b = aligned(w_hh_f), aligned(w_hh_b)
    xw_f, xw_b = (_projection_scratch(x_parts, H) for _ in range(2))
    two = len(x_parts) > 1
    launch("bilstm_dual_fused", x0.device, DTYPE_CODE[x0.dtype], ptr(x0),
           ptr(x_parts[1] if two else None), ptr(wf_parts[0]),
           ptr(wf_parts[1] if two else None), ptr(wb_parts[0]),
           ptr(wb_parts[1] if two else None), F0,
           x_parts[1].shape[2] if two else 0, ptr(b_f), ptr(b_b),
           ptr(w_hh_f), ptr(w_hh_b), ptr(xw_f), ptr(xw_b), ptr(out_f),
           ptr(out_b), T, B, H)
    bilstm_dual_fused.launches += 1
    return out_f, out_b


bilstm_dual_fused.launches = 0


def bilstm_fused(x_parts, params, dual=None):
    """Bidirectional LSTM over time-major feature parts (inference only).

    x_parts: tuple of (T, B, F_i) arrays, concatenated feature-wise.
    Returns (fwd, bwd), each (T, B, H) in natural order; the transducer
    head consumes the time-major streams directly.  dual=True runs both
    directions in one bilstm_dual_fused launch; dual=None reads
    PEPPER_LSTM_DUAL=1, as the JAX package does."""
    if dual is None:
        dual = os.environ.get("PEPPER_LSTM_DUAL", "0") == "1"
    wf = split_rows(params["w_ih_f"], x_parts)
    wb = split_rows(params["w_ih_b"], x_parts)
    if dual:
        return bilstm_dual_fused(x_parts, wf, wb, params["b_f"],
                                 params["b_b"], params["w_hh_f"],
                                 params["w_hh_b"])
    return (lstm_direction_fused(x_parts, wf, params["b_f"],
                                 params["w_hh_f"]),
            lstm_direction_fused(x_parts, wb, params["b_b"],
                                 params["w_hh_b"], reverse=True))


# ---------------------------------------------------------------------------
# lstm_direction_fused_static


def lstm_direction_fused_static_reference(x_parts, w_ih_parts, b, w_hh,
                                          acc_scale=None, rec_scale=None,
                                          reverse=False, out_int8=False,
                                          out_dtype=torch.bfloat16):
    """Plain PyTorch twin of the static kernel, same arguments.  Float x:
    one f32 input projection up front.  int8 x: the int32 products of all
    parts summed, then one rescale by acc_scale.  An int8 W_hh (rec_scale
    given) is fed round(h*127) every step and rescaled by rec_scale."""
    T, B, _ = x_parts[0].shape
    H = w_hh.shape[0]
    xw = b.float().reshape(-1)
    if x_parts[0].dtype == torch.int8:
        acc = None
        for x, w in zip(x_parts, w_ih_parts):
            part = int8_matmul(x.reshape(T * B, -1), w)
            acc = part if acc is None else acc + part
        xw = xw + acc.reshape(T, B, -1).float() * acc_scale.float().reshape(-1)
    else:
        for x, w in zip(x_parts, w_ih_parts):
            xw = xw + x.float() @ w.float()
    if rec_scale is None:
        recurrent = _float_recurrent(w_hh)
    else:
        r_scale = rec_scale.float().reshape(-1)

        def recurrent(h):
            return int8_matmul(int8_codes(h), w_hh).float() * r_scale
    out = torch.empty((T, B, H), device=xw.device,
                      dtype=torch.int8 if out_int8 else out_dtype)
    emit = int8_codes if out_int8 else (lambda h: h.to(out_dtype))
    return _recurrence_twin(xw, recurrent, emit, out, reverse)


def _check_static_args(x_parts, w_ih_parts, b, w_hh, acc_scale, rec_scale):
    x0 = x_parts[0]
    x_dtype = x0.dtype
    if x_dtype not in DTYPE_CODE:
        raise TypeError(f"lstm_direction_fused_static takes float32, "
                        f"bfloat16 or int8 x, got {x_dtype}")
    H = w_hh.shape[0]
    if w_hh.shape != (H, 4 * H) or b.numel() != 4 * H:
        raise ValueError(f"w_hh {tuple(w_hh.shape)} / b {tuple(b.shape)} "
                         f"do not fit H={H}")
    _check_parts(x_parts, w_ih_parts, H)
    scales = []
    for t in (*x_parts, *w_ih_parts):
        if t.dtype != x_dtype:
            raise TypeError(f"x parts and w_ih parts must share one dtype; "
                            f"got {t.dtype} beside {x_dtype}")
    if x_dtype == torch.int8:
        if acc_scale is None or acc_scale.numel() != 4 * H:
            raise ValueError("int8 x takes an acc_scale of 4H values")
        if any(x.shape[2] % 4 for x in x_parts):
            raise ValueError("int8 x parts take a multiple of 4 features")
        if any(x.data_ptr() % 4 for x in x_parts):
            raise ValueError("int8 x parts must be 4-byte aligned")
        scales.append(acc_scale)
    elif acc_scale is not None:
        raise ValueError("acc_scale is for int8 x only")
    if rec_scale is not None:
        if w_hh.dtype != torch.int8 or rec_scale.numel() != 4 * H:
            raise TypeError("rec_scale takes an int8 w_hh and 4H scales")
        scales.append(rec_scale)
    elif w_hh.dtype not in FLOATS or (x_dtype != torch.int8
                                       and w_hh.dtype != x_dtype):
        raise TypeError(f"a {w_hh.dtype} w_hh needs rec_scale, or the float "
                        f"dtype of x ({x_dtype})")
    check_contiguous((*x_parts, *w_ih_parts, b, w_hh, *scales), x0.device,
                     "lstm_direction_fused_static")


def static_x_joins(x_dtype, widths) -> bool:
    """Whether the static kernel's x, feature parts of `widths`, joins the
    recurrence's step, with no xw: bfloat16 x of at most FUSED_X_MAX
    features.  Other x is projected first (_static_scratch).
    csrc/lstm_direction_fused_static.cu:joins_step applies the same
    rule."""
    return x_dtype == torch.bfloat16 and sum(widths) <= FUSED_X_MAX


def _static_scratch(x_parts, H):
    """The float32 xw (T, B, 4H) that the static kernel projects x into
    first, or None where x joins the recurrence's step
    (static_x_joins)."""
    x0 = x_parts[0]
    if static_x_joins(x0.dtype, tuple(x.shape[2] for x in x_parts)):
        return None
    return torch.empty((*x0.shape[:2], 4 * H), dtype=torch.float32,
                       device=x0.device)


def lstm_direction_fused_static(x_parts, w_ih_parts, b, w_hh, acc_scale=None,
                                rec_scale=None, reverse=False, out_int8=False,
                                out_dtype=torch.bfloat16):
    """One LSTM direction with static-int8 streams.

    x_parts: tuple of (T, B, F_i) arrays, all int8 codes (scale 1/127) or
    all float.  For int8 x, w_ih_parts are int8 per-output-column
    quantized weights and acc_scale is the (4H,) combined rescale
    (w_scale/127) applied once to the summed int32 accumulator; for float
    x they share its dtype.  b: (4H,), used in float32.  w_hh: (H, 4H) in
    the float dtype of x (or float32/bfloat16 beside int8 x), or int8 with
    rec_scale (4H,).  out_int8=True emits round(h*127) int8; else out_dtype
    floats.  Returns (T, B, H) in natural order.  The int8 weights reach
    the kernel k-major: the copies cuda_build.keep_relaid kept, or relaid
    at this launch."""
    x0 = x_parts[0]
    if x0.device.type == "cpu":
        return lstm_direction_fused_static_reference(
            x_parts, w_ih_parts, b, w_hh, acc_scale=acc_scale,
            rec_scale=rec_scale, reverse=reverse, out_int8=out_int8,
            out_dtype=out_dtype)
    require_cuda(x0, "lstm_direction_fused_static")
    _check_static_args(x_parts, w_ih_parts, b, w_hh, acc_scale, rec_scale)
    T, B, F0 = x0.shape
    H = w_hh.shape[0]
    check_hidden(H)
    out_kind = torch.int8 if out_int8 else out_dtype
    if out_kind not in DTYPE_CODE:
        raise TypeError(f"out_dtype float32 or bfloat16, not {out_dtype}")
    out = torch.empty((T, B, H), dtype=out_kind, device=x0.device)
    if T == 0 or B == 0:
        return out
    two = len(x_parts) > 1
    # int8 W_ih: one k-major (4H, F) matrix for both parts
    w_parts = ((relaid(w_ih_parts),) if x0.dtype == torch.int8
               else tuple(aligned(w) for w in w_ih_parts))
    w_rec = aligned(w_hh if rec_scale is None else relaid((w_hh,)))

    def f32(t):
        return None if t is None else t.reshape(-1).float().contiguous()

    acc, rec, bias = f32(acc_scale), f32(rec_scale), f32(b)
    xw = _static_scratch(x_parts, H)
    launch("lstm_direction_fused_static", x0.device, DTYPE_CODE[x0.dtype],
           DTYPE_CODE[w_hh.dtype], DTYPE_CODE[out_kind], ptr(x0),
           ptr(x_parts[1] if two else None), ptr(w_parts[0]),
           ptr(w_parts[1] if len(w_parts) > 1 else None), F0,
           x_parts[1].shape[2] if two else 0, ptr(acc), ptr(rec),
           ptr(bias), ptr(w_rec), ptr(xw), ptr(out), T, B, H,
           int(bool(reverse)))
    lstm_direction_fused_static.launches += 1
    return out


lstm_direction_fused_static.launches = 0


def bilstm_fused_static(x_parts, params, acc_scale=None, rec_scale=None,
                        out_int8=False, out_dtype=torch.bfloat16):
    """Bidirectional wrapper over lstm_direction_fused_static.  params uses
    the w_ih_f/w_hh_f/b_f naming; int8 x takes int8 w_ih_* and the pair
    acc_scale = (acc_scale_f, acc_scale_b); rec_scale = (rec_f, rec_b) with
    int8 w_hh_*."""
    scale_f, scale_b = acc_scale if acc_scale is not None else (None, None)
    rscale_f, rscale_b = rec_scale if rec_scale is not None else (None, None)
    return tuple(
        lstm_direction_fused_static(
            x_parts, split_rows(params[f"w_ih_{sfx}"], x_parts),
            params[f"b_{sfx}"], params[f"w_hh_{sfx}"], acc_scale=scale,
            rec_scale=rscale, reverse=reverse, out_int8=out_int8,
            out_dtype=out_dtype)
        for sfx, scale, rscale, reverse in (("f", scale_f, rscale_f, False),
                                            ("b", scale_b, rscale_b, True)))


# ---------------------------------------------------------------------------
# lstm_recurrence


def lstm_recurrence_reference(xw, w_hh, reverse=False):
    """Plain twin of the recurrence kernel: f32 state, h rounded to xw's
    dtype before the recurrent product, output in xw's dtype; reverse=True
    steps t = T-1..0."""
    T, B, _ = xw.shape
    dtype = xw.dtype
    out = torch.empty((T, B, w_hh.shape[0]), dtype=dtype, device=xw.device)
    return _recurrence_twin(xw.float(), _float_recurrent(w_hh),
                            lambda h: h.to(dtype), out, reverse)


def lstm_recurrence(xw, w_hh, reverse=False):
    """LSTM recurrence over precomputed input projections.  xw: (T, B, 4H)
    float32 or bfloat16; w_hh: (H, 4H) in xw's dtype; reverse=True runs
    the backward direction by stepping t = T-1..0 (what flipping xw,
    running forward and flipping the output computes).  Returns (T, B, H)
    in natural order, in xw's dtype.  It runs on the tensor cores
    (csrc/lstm_core.cuh): bfloat16 products, or 3xTF32 in float32."""
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(xw, w_hh, reverse=reverse)
    require_cuda(xw, "lstm_recurrence")
    if xw.dtype not in FLOATS or w_hh.dtype != xw.dtype:
        raise TypeError(f"lstm_recurrence takes float32 or bfloat16 xw and "
                        f"w_hh of one dtype, got {xw.dtype} and {w_hh.dtype}")
    H = w_hh.shape[0]
    if xw.dim() != 3 or xw.shape[2] != 4 * H or w_hh.shape != (H, 4 * H):
        raise ValueError(f"xw {tuple(xw.shape)} / w_hh {tuple(w_hh.shape)} "
                         f"are not (T, B, 4H) / (H, 4H)")
    check_contiguous((xw, w_hh), xw.device, "lstm_recurrence")
    check_hidden(H)
    T, B, _ = xw.shape
    out = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    if T == 0 or B == 0:
        return out
    xw, w_hh = aligned(xw), aligned(w_hh)
    launch("lstm_recurrence", xw.device, DTYPE_CODE[xw.dtype], ptr(xw),
           ptr(w_hh), ptr(out), T, B, H, int(bool(reverse)))
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0


# ---------------------------------------------------------------------------
# the unfused biLSTM over lstm_recurrence


def use_pallas_lstm(device) -> bool:
    """Whether models/rnn.py's bilstm runs bilstm_pallas: PEPPER_LSTM_KERNEL
    =1 always (on the CPU that is lstm_recurrence's twin), =0 never, auto
    (the default) on a CUDA device."""
    flag = os.environ.get("PEPPER_LSTM_KERNEL", "auto")
    if flag in ("0", "1"):
        return flag == "1"
    return torch.device(device).type == "cuda"


def bilstm_pallas(x, params):
    """Bidirectional LSTM over lstm_recurrence, semantics identical to
    models/rnn.py's bilstm: x (B, T, F) -> (B, T, 2H) laid out [fwd, bwd].
    Each direction's input projection is one float32 product outside the
    kernel (as the JAX package's einsum sits outside its Pallas
    recurrence), rounded to x's dtype; the kernel steps the backward
    direction in reverse itself.  w_hh must be in x's dtype."""
    xf = x.float()

    def direction(w_ih, w_hh, b, reverse):
        xw = torch.einsum("btf,fg->tbg", xf, w_ih.float()) + b.float()
        return lstm_recurrence(xw.to(x.dtype).contiguous(), w_hh,
                               reverse=reverse)

    fwd = direction(params["w_ih_f"], params["w_hh_f"], params["b_f"], False)
    bwd = direction(params["w_ih_b"], params["w_hh_b"], params["b_b"], True)
    return torch.cat([fwd, bwd], dim=-1).transpose(0, 1)
