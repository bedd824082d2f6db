"""Plain float32 PyTorch reference of PEPPER's transformer window classifier
(pepper_variant/modules/python/models/simple_model_transformers.py:5-97):

  stem     x (B, T, F) as one channel (B, 1, T, F);
           relu(bn1(conv1(x))), then bn2(conv2(.)), + x, relu  (B, C, T, F)
           conv 3x3, padding 1, no bias; BatchNorm on its running
           statistics, eps 1e-5
  reshape  row-major (B, C, T, F) -> (B, T, C*F), not a transpose
  encoder  num_layers post-LN torch TransformerEncoderLayers, d_model
           D = C*F, ReLU FFN, LayerNorm eps 1e-5:
             a = MHA(x): [q | k | v] = x W_qkv + b_qkv; per head,
                 softmax(q k^T / sqrt(D / heads)) v; heads concatenated,
                 then out_proj
             x = LN1(x + a);  x = LN2(x + W2 relu(W1 x + b1) + b2)
  pyramid  flatten (B, T*D), Linear + ReLU to 128, 64, 32, 16, 8
  head     Linear(8 -> classes), softmax

Attention runs over a window's T positions, each window apart.  Dropout
(0.1 in the encoder, 0.1/0.1/0.2/0.1 in the pyramid) is off, as at
inference.  Weights are right-multiplied ((fan_in, fan_out), the layout of
the port's checkpoints), the qkv packed as torch's in_proj.  Every product,
the convolutions' (as im2col products) and the attention's two included,
runs in float32 with TF32 off; `precision` ("tf32", "fp8") rounds every
product's operands to that precision first (benchmark/precision.py),
which serves as a control of the comparison.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.precision import exact_float32, mm

EPS = 1e-5


def param_shapes(config: dict) -> dict:
    """{"group.leaf": (shape, scale)} of every drawn weight, in a fixed
    order.  Scales are torch's default initialisations (the packed qkv
    xavier-uniform, its bias and out_proj's 0), but for the pyramid's
    weights, drawn at the ReLU stack's variance-keeping sqrt(6 / fan_in)
    (torch's 1/sqrt(fan_in) shrinks the variance six-fold a layer, and
    over five the windows' share of the logits to ~0.006, where the
    probabilities hardly depend on the window); each norm's gamma and beta
    are drawn at 0.1, the caller adding 1 to the gammas; the BatchNorm
    running statistics are not drawn (calibrate_batchnorm)."""
    T, feats = config["window"], config["image_features"]
    C = config["conv_channels"]
    D, ffn = C * feats, config["ffn_size"]
    shapes = {}
    for conv, bn, fan_in in (("conv1", "bn1", 1), ("conv2", "bn2", C)):
        shapes[conv] = ((C, fan_in, 3, 3), (9 * fan_in) ** -0.5)
        shapes[f"{bn}.gamma"] = ((C,), 0.1)
        shapes[f"{bn}.beta"] = ((C,), 0.1)
    for i in range(config["num_layers"]):
        p = f"layers.{i}"
        shapes[f"{p}.w_qkv"] = ((D, 3 * D), (6.0 / (D + 3 * D)) ** 0.5)
        shapes[f"{p}.b_qkv"] = ((3 * D,), 0.0)
        shapes[f"{p}.out_proj.w"] = ((D, D), D ** -0.5)
        shapes[f"{p}.out_proj.b"] = ((D,), 0.0)
        shapes[f"{p}.ffn_1.w"] = ((D, ffn), D ** -0.5)
        shapes[f"{p}.ffn_1.b"] = ((ffn,), D ** -0.5)
        shapes[f"{p}.ffn_2.w"] = ((ffn, D), ffn ** -0.5)
        shapes[f"{p}.ffn_2.b"] = ((D,), ffn ** -0.5)
        for norm in ("norm1", "norm2"):
            shapes[f"{p}.{norm}.gamma"] = ((D,), 0.1)
            shapes[f"{p}.{norm}.beta"] = ((D,), 0.1)
    sizes = [T * D, *config["pyramid"]]
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:]), 1):
        shapes[f"linear_{i}.w"] = ((fan_in, fan_out), (6.0 / fan_in) ** 0.5)
        shapes[f"linear_{i}.b"] = ((fan_out,), fan_in ** -0.5)
    fan_in = sizes[-1]
    shapes["output_layer.w"] = ((fan_in, config["num_type_classes"]),
                                fan_in ** -0.5)
    shapes["output_layer.b"] = ((config["num_type_classes"],),
                                fan_in ** -0.5)
    return shapes


def _conv3x3(x, w, precision):
    """x (B, I, T, F), w (O, I, 3, 3) -> (B, O, T, F), padding 1, as one
    product of w with x's 3x3 patches."""
    B, _, T, feats = x.shape
    patches = F.unfold(x, kernel_size=3, padding=1)      # (B, I*9, T*F)
    return mm(w.reshape(w.shape[0], -1), patches, precision).view(
        B, w.shape[0], T, feats)


def _batchnorm(x, p):
    scale = p["gamma"] / torch.sqrt(p["var"] + EPS)
    return (x - p["mean"][:, None, None]) * scale[:, None, None] \
        + p["beta"][:, None, None]


def _linear(x, p, precision):
    return mm(x, p["w"], precision) + p["b"]


def _attention(x, lp, heads, precision):
    B, T, D = x.shape
    width = D // heads
    qkv = mm(x, lp["w_qkv"], precision) + lp["b_qkv"]
    q, k, v = (a.reshape(B, T, heads, width).transpose(1, 2)
               for a in qkv.split(D, dim=-1))
    scores = mm(q, k.transpose(-1, -2), precision) / math.sqrt(width)
    out = mm(torch.softmax(scores, dim=-1), v, precision)
    return _linear(out.transpose(1, 2).reshape(B, T, D), lp["out_proj"],
                   precision)


def _layer_norm(x, p):
    return F.layer_norm(x, x.shape[-1:], p["gamma"], p["beta"], EPS)


def _encoder_layer(x, lp, heads, precision):
    x = _layer_norm(x + _attention(x, lp, heads, precision), lp["norm1"])
    hidden = torch.relu(_linear(x, lp["ffn_1"], precision))
    return _layer_norm(x + _linear(hidden, lp["ffn_2"], precision),
                       lp["norm2"])


@torch.no_grad()
def calibrate_batchnorm(params: dict, config: dict,
                        images: torch.Tensor) -> None:
    """Sets each BatchNorm's running mean and (biased) variance in place to
    its input's statistics over `images` (B, T, F), per channel, in
    float32: what post-training calibration sets from a representative
    batch (bn1 first, then bn2 on what bn1 gives)."""
    with exact_float32():
        img = images.float()[:, None]
        out = _conv3x3(img, params["conv1"], None)
        for bn, conv in (("bn1", "conv2"), ("bn2", None)):
            params[bn]["mean"] = out.mean(dim=(0, 2, 3))
            params[bn]["var"] = out.var(dim=(0, 2, 3), correction=0)
            if conv is not None:
                out = _conv3x3(torch.relu(_batchnorm(out, params[bn])),
                               params[conv], None)


@torch.no_grad()
def forward(params: dict, config: dict, images: torch.Tensor,
            precision: str | None = None) -> torch.Tensor:
    """images (B, T, F) of any dtype -> class probabilities (B, classes),
    float32."""
    with exact_float32():
        x = images.float()
        B, T, feats = x.shape
        img = x[:, None]
        out = torch.relu(_batchnorm(
            _conv3x3(img, params["conv1"], precision), params["bn1"]))
        out = _batchnorm(_conv3x3(out, params["conv2"], precision),
                         params["bn2"])
        out = torch.relu(out + img)
        h = out.reshape(B, T, config["conv_channels"] * feats)
        for i in range(config["num_layers"]):
            h = _encoder_layer(h, params["layers"][str(i)],
                               config["num_heads"], precision)
        h = h.reshape(B, -1)
        for i in range(1, len(config["pyramid"]) + 1):
            h = torch.relu(_linear(h, params[f"linear_{i}"], precision))
        return torch.softmax(_linear(h, params["output_layer"], precision),
                             dim=1)
