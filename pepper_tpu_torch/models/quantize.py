"""Int8 serving (`--quantized`), the port of the JAX package's
models/quantize.py: the lstm transducer's three modes below, and at the
end of the module the polish consensus GRU's static mode.

Three modes:

  static      Every activation that feeds a big product after the encoder
              is an LSTM hidden output h = o*tanh(c) in (-1, 1), so its int8
              scale is exactly 1/127.  The encoder emits round(h*127) int8
              streams, the decoder's input projection and linear_1 run as
              int8 x int8 -> int32 products with one fused rescale
              (w_scale/127 per output column), the rest in the compute
              dtype.  Both biLSTMs run lstm_direction_fused_static.
  static_rec  static, with the four recurrent weights int8 as well: the
              recurrence re-codes h as round(h*127) every step.
  dynamic     Per-output-channel int8 weights, per-row absmax int8
              activations computed per batch, int32 products rescaled by
              (row scale x column scale); the recurrences run
              lstm_recurrence on bfloat16 projections.

The quantizers are numpy and equal the JAX package's leaf for leaf and bit
for bit.  The int8 products outside the kernels are exact int32 sums
(ops/int8_matmul.py).  Rounding is round-half-to-even throughout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import gru_kernel, lstm_kernel
from ..ops.cuda_build import int8_codes, keep_relaid, split_rows
from ..ops.int8_matmul import int8_matmul

QUANTIZE_MODES = ("static", "static_rec", "dynamic")
_QUANT_PREFIXES = ("w_ih", "w")     # input projections + dense weights
_KEEP_FLOAT = ("w_hh",)             # recurrent weights stay float
_HEAD = ("linear_2", "linear_3", "linear_4", "linear_5", "output_layer_type")


def _should_quantize(key: str, leaf) -> bool:
    if np.asarray(leaf).ndim < 2:
        return False                # biases / vectors
    # w_hh is kept float before the "w" prefix below would match it
    if any(key.startswith(p) for p in _KEEP_FLOAT):
        return False
    return any(key == p or key.startswith(p) for p in _QUANT_PREFIXES)


def quantize_params(params):
    """float tree -> (int8-or-float tree, scale tree) for the dynamic
    mode.  Quantized leaves carry per-output-channel scales (1, N);
    recurrent weights and biases pass through unquantized with scale
    None."""

    def walk(node):
        q_node, s_node = {}, {}
        for key, value in node.items():
            if isinstance(value, dict):
                q_node[key], s_node[key] = walk(value)
                continue
            leaf = np.asarray(value)
            if _should_quantize(key, leaf):
                scale = np.maximum(np.abs(leaf).max(axis=0, keepdims=True),
                                   1e-8) / 127.0
                q_node[key] = np.clip(np.round(leaf / scale), -127,
                                      127).astype(np.int8)
                s_node[key] = scale.astype(np.float32)
            else:
                q_node[key] = leaf
                s_node[key] = None
        return q_node, s_node

    return walk(params)


def dequantize_params(quantized, scales, dtype=torch.bfloat16):
    """(quantized, scales) -> float tree of tensors in `dtype`; the product
    q*scale is taken in `dtype`."""

    def walk(q_node, s_node):
        out = {}
        for key, q in q_node.items():
            scale = s_node[key]
            if isinstance(q, dict):
                out[key] = walk(q, scale)
            elif scale is None:
                out[key] = torch.as_tensor(np.asarray(q)).to(dtype)
            else:
                out[key] = (torch.as_tensor(np.asarray(q)).to(dtype)
                            * torch.as_tensor(np.asarray(scale)).to(dtype))
        return out

    return walk(quantized, scales)


def _quantize_cols(w):
    """(K, N) float -> int8 codes, (1, N) per-output-column scales."""
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_params_static(params, rec_int8=False):
    """float param tree -> static int8 serving tree (numpy).

    decoder w_ih_* and linear_1 w become int8 with fused rescales as_* and
    linear_1 as (w_scale/127: the /127 dequantizes the int8 activation
    codes); everything else passes through as float32.  rec_int8=True
    (static_rec) also quantizes the four recurrent weights per output
    column, with rescales as_hh_*."""
    tree = {}
    for name, node in params.items():
        tree[name] = {k: np.asarray(v, np.float32) for k, v in node.items()}

    dec = tree["decoder"]
    for sfx in ("f", "b"):
        q, scale = _quantize_cols(dec[f"w_ih_{sfx}"])
        dec[f"w_ih_{sfx}"] = q
        dec[f"as_{sfx}"] = scale / 127.0
    if rec_int8:
        for layer in ("encoder", "decoder"):
            node = tree[layer]
            for sfx in ("f", "b"):
                q, scale = _quantize_cols(node[f"w_hh_{sfx}"])
                node[f"w_hh_{sfx}"] = q
                node[f"as_hh_{sfx}"] = scale / 127.0
    lin1 = tree["linear_1"]
    q, scale = _quantize_cols(lin1["w"])
    lin1["w"] = q
    lin1["as"] = (scale / 127.0).reshape(-1)
    return tree


# ---------------------------------------------------------------------------
# static and static_rec


def prepare_static(q, compute_dtype, device):
    """The static tree on `device` with the dtypes the kernels take: the
    encoder's w_ih, every float w_hh and the head after linear_1 in the
    compute dtype; int8 leaves, biases and rescales as they are (float32
    biases feed the kernels and linear_1).  Each int8 weight of the two
    biLSTMs is relaid once, k-major (what every static launch reads), and
    the copy kept beside it (cuda_build.keep_relaid) for every launch.  A
    no-op on a prepared tree."""

    def leaf(layer, key, value):
        value = torch.as_tensor(value).to(device)
        to_compute = ((layer == "encoder" and key.startswith("w_ih"))
                      or (key.startswith("w_hh") and value.dtype != torch.int8)
                      or layer in _HEAD)
        return (value.to(compute_dtype) if to_compute else value).contiguous()

    tree = {layer: {key: leaf(layer, key, value)
                    for key, value in node.items()}
            for layer, node in q.items()}
    for layer in ("encoder", "decoder"):
        for key in ("w_ih_f", "w_ih_b", "w_hh_f", "w_hh_b"):
            if tree[layer][key].dtype == torch.int8:
                keep_relaid(tree[layer][key])
    return tree


@torch.inference_mode()
def transducer_infer_static(q, x, compute_dtype=torch.bfloat16):
    """Static-scale int8 inference: (B, T, F) windows -> (B, 3) float32
    probabilities, through lstm_direction_fused_static."""
    q = prepare_static(q, compute_dtype, x.device)
    xt = x.transpose(0, 1).to(compute_dtype).contiguous()  # (T, B, F)
    enc, dec = q["encoder"], q["decoder"]

    def rec_scale(node):
        return ((node["as_hh_f"], node["as_hh_b"]) if "as_hh_f" in node
                else None)

    f1q, b1q = lstm_kernel.bilstm_fused_static(
        (xt,), enc, rec_scale=rec_scale(enc), out_int8=True)
    f2q, b2q = lstm_kernel.bilstm_fused_static(
        (f1q, b1q), dec, acc_scale=(dec["as_f"], dec["as_b"]),
        rec_scale=rec_scale(dec), out_int8=True)

    # linear_1 over the t-major flatten: the codes laid out as its rows
    # (t-major, [fwd|bwd]) make one exact int32 product, equal to the sum
    # of the fwd and bwd contractions
    T, B, _ = f2q.shape
    codes = torch.stack((f2q, b2q), dim=2).transpose(0, 1).reshape(B, -1)
    lin1 = q["linear_1"]
    acc = int8_matmul(codes, lin1["w"])
    h = acc.float() * lin1["as"] + lin1["b"]

    h = F.selu(h).to(compute_dtype)
    for name in ("linear_2", "linear_3", "linear_4", "linear_5"):
        h = F.selu(h @ q[name]["w"] + q[name]["b"])
    out = q["output_layer_type"]
    logits = h @ out["w"] + out["b"]
    return torch.softmax(logits.float(), dim=1)


# ---------------------------------------------------------------------------
# dynamic


def _dynamic_quant(x):
    """Per-row (last-axis) absmax int8 quantization of activations."""
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_linear(x, w_q, w_scale, b=None):
    """x float (..., K) @ int8 (K, N) -> float32 (..., N): dynamic-quant
    the rows, exact int32 product, rescale."""
    x_q, x_scale = _dynamic_quant(x)
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(*x_q.shape[:-1], acc.shape[-1])
    y = acc.float() * x_scale.float() * w_scale
    if b is not None:
        y = y + b
    return y


def _recurrence(xw, w_hh, reverse, compute_dtype):
    """xw: (B, T, 4H) float32 projections -> (B, T, H) hidden outputs
    through lstm_recurrence, which steps T-1..0 for the reverse
    direction."""
    xw_t = xw.to(compute_dtype).transpose(0, 1)
    ys = lstm_kernel.lstm_recurrence(xw_t.contiguous(), w_hh.to(compute_dtype),
                                     reverse=reverse)
    return ys.transpose(0, 1)


def _bilstm_int8(x, q, s, compute_dtype):
    """Bidirectional LSTM whose input projections run in int8."""
    outs = []
    for sfx, reverse in (("f", False), ("b", True)):
        xw = _int8_linear(x, q[f"w_ih_{sfx}"], s[f"w_ih_{sfx}"],
                          q[f"b_{sfx}"])
        outs.append(_recurrence(xw, q[f"w_hh_{sfx}"], reverse,
                                compute_dtype))
    return torch.cat(outs, dim=-1).float()


@torch.inference_mode()
def transducer_infer_quantized(quantized, scales, x,
                               compute_dtype=torch.bfloat16):
    """Dynamic int8 inference: (B, T, F) windows -> (B, 3) float32
    probabilities.  The recurrences run in compute_dtype, bfloat16 unless
    given (the runner gives none, as the JAX package's does)."""
    x = _bilstm_int8(x.float(), quantized["encoder"], scales["encoder"],
                     compute_dtype)
    x = _bilstm_int8(x, quantized["decoder"], scales["decoder"],
                     compute_dtype)
    x = x.reshape(x.shape[0], -1)
    for name in ("linear_1", "linear_2", "linear_3", "linear_4", "linear_5"):
        x = F.selu(_int8_linear(x, quantized[name]["w"], scales[name]["w"],
                                quantized[name]["b"]))
    logits = _int8_linear(x, quantized["output_layer_type"]["w"],
                          scales["output_layer_type"]["w"],
                          quantized["output_layer_type"]["b"])
    return torch.softmax(logits, dim=1)


# ---------------------------------------------------------------------------
# polish GRU static serving
#
# The polish consensus GRU's hidden stream h' = (1-z)*n + z*h is bounded in
# (-1, 1) like the LSTM's o*tanh(c), so the same exact-1/127 static scheme
# applies: the encoder emits round(h*127) int8 codes, the decoder's 256->384
# input projection runs int8 x int8 with one fused rescale, and the
# per-step head runs in int8.  Recurrent products, biases and the hidden
# carry stay float: the carry must stay exact for the sliding windows.


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def polish_quantize_params_static(params):
    """float polish param tree (numpy arrays or tensors) -> static int8
    serving tree (numpy): decoder w_ih_* and the output head w become int8
    with fused rescales as_* and as (w_scale/127)."""
    tree = {}
    for name, node in params.items():
        tree[name] = {k: _host(v).astype(np.float32) for k, v in node.items()}
    dec = tree["decoder"]
    for sfx in ("f", "b"):
        q, scale = _quantize_cols(dec[f"w_ih_{sfx}"])
        dec[f"w_ih_{sfx}"] = q
        dec[f"as_{sfx}"] = scale / 127.0
    out = tree["output"]
    q, scale = _quantize_cols(out["w"])
    out["w"] = q
    out["as"] = (scale / 127.0).reshape(-1)
    return tree


def polish_prepare_static(q):
    """The static polish tree (tensors, as params_from_jax gives them), its
    decoder's int8 W_ih relaid once, k-major (what
    gru_direction_fused_static's int8 projection reads), and the copies
    kept beside them (cuda_build.keep_relaid) for every launch.  Returns q;
    a no-op on a prepared tree."""
    for key in ("w_ih_f", "w_ih_b"):
        keep_relaid(q["decoder"][key])
    return q


def _gru_recurrence_xw(xw, w_hh, b_hh, h0, reverse):
    """GRU recurrence from precomputed float32 input projections, f32
    state (the unfused static path).  Returns (ys (T, B, H), hT)."""
    out = torch.empty((*xw.shape[:2], w_hh.shape[0]), dtype=torch.float32,
                      device=xw.device)
    hT = gru_kernel.recurrence_twin(xw, lambda h: h @ w_hh + b_hh, h0,
                                    lambda h: h, out, reverse)
    return out, hT


def _scan_bigru_to_q(xt, params, h0, compute_dtype):
    """Unfused encoder: float input projection in compute_dtype, f32
    recurrence with W_hh as stored, int8-coded streams out, float final
    hidden.  h0: (B, 2, H)."""

    def direction(sfx, h0d, reverse):
        xw = torch.einsum("tbf,fg->tbg", xt.to(compute_dtype),
                          params[f"w_ih_{sfx}"].to(compute_dtype)).float() \
            + params[f"b_ih_{sfx}"]
        ys, hT = _gru_recurrence_xw(xw, params[f"w_hh_{sfx}"],
                                    params[f"b_hh_{sfx}"], h0d.float(),
                                    reverse)
        return int8_codes(ys), hT

    fq, hf = direction("f", h0[:, 0], False)
    bq, hb = direction("b", h0[:, 1], True)
    return fq, bq, torch.stack([hf, hb], dim=1)


def _scan_bigru_q_to_q(x_parts_q, params, h0, compute_dtype):
    """Unfused decoder: int8 input projections with exact int32 sums and
    one rescale, f32 recurrence, int8 streams out, float final hidden."""
    T, B, _ = x_parts_q[0].shape

    def direction(sfx, h0d, reverse):
        acc = None
        for xp, w in zip(x_parts_q,
                         split_rows(params[f"w_ih_{sfx}"], x_parts_q)):
            part = int8_matmul(xp.reshape(T * B, -1), w)
            acc = part if acc is None else acc + part
        xw = (acc.reshape(T, B, -1).float() * params[f"as_{sfx}"].reshape(-1)
              + params[f"b_ih_{sfx}"])
        ys, hT = _gru_recurrence_xw(xw, params[f"w_hh_{sfx}"],
                                    params[f"b_hh_{sfx}"], h0d.float(),
                                    reverse)
        return int8_codes(ys), hT

    fq, hf = direction("f", h0[:, 0], False)
    bq, hb = direction("b", h0[:, 1], True)
    return fq, bq, torch.stack([hf, hb], dim=1)


@torch.inference_mode()
def polish_forward_static(q, xt, hidden, compute_dtype=torch.float32,
                          use_kernel=None):
    """Static-int8 polish forward, time-major.

    q: the static tree as tensors on xt's device (params_from_jax of
    polish_quantize_params_static, relaid by polish_prepare_static on the
    served path).  xt: (T, B, F) float window; hidden:
    (B, 2, H) float carry.  Returns (logits (T, B, C) float32,
    hidden_final (B, 2, H) float32).  use_kernel=None takes the kernel
    path where use_fused_gru says so: there the encoder's W_ih and W_hh
    and the decoder's W_hh run in compute_dtype."""
    if use_kernel is None:
        use_kernel = gru_kernel.use_fused_gru(xt.device)
    if use_kernel:
        enc = {k: (v.to(compute_dtype) if k.startswith(("w_ih", "w_hh"))
                   else v) for k, v in q["encoder"].items()}
        f1q, b1q, hid1 = gru_kernel.bigru_fused_static(
            (xt.to(compute_dtype).contiguous(),), enc, hidden)
        dec = {k: (v.to(compute_dtype) if k.startswith("w_hh") else v)
               for k, v in q["decoder"].items()}
        f2q, b2q, hid_final = gru_kernel.bigru_fused_static(
            (f1q, b1q), dec, hid1, acc_scale=(dec["as_f"], dec["as_b"]))
    else:
        f1q, b1q, hid1 = _scan_bigru_to_q(xt, q["encoder"], hidden,
                                          compute_dtype)
        f2q, b2q, hid_final = _scan_bigru_q_to_q((f1q, b1q), q["decoder"],
                                                 hid1, compute_dtype)

    # the head: two exact int32 products over the fwd and bwd halves of
    # its int8 weight (C = 5 columns; int8_matmul pads for torch._int_mm)
    w_q = q["output"]["w"]
    T, B, H = f2q.shape
    acc = (int8_matmul(f2q.reshape(T * B, H), w_q[:H])
           + int8_matmul(b2q.reshape(T * B, H), w_q[H:]))
    logits = (acc.reshape(T, B, -1).float() * q["output"]["as"]
              + q["output"]["b"])
    return logits, hid_final
