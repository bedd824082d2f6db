"""Alternate model families of the reference, the port of the JAX
package's models/alternates.py:

  * pepper_variant/modules/python/models/simple_model_no_cnn.py:5-104 —
    a narrower LSTM transducer whose decoder re-reads the *input* image
    (the encoder's sequence output is discarded; only its final
    hidden/cell state is carried into the decoder).
  * pepper_variant/modules/python/models/simple_model_transformers.py:5-97 —
    residual Conv2d block + 6-layer post-LN transformer encoder + a
    128->64->32->16->8 linear pyramid.
  * pepper/modules/python/models/resnet.py:49-94 — a tiny one-plane
    "ResNet-18" feature extractor (two BasicConv2d stems + one BasicBlock).
  * pepper/modules/python/models/Seq2Seq_atn.py:14-135 — CRNN encoder
    (resnet + bidirectional GRU with direction-summed outputs) and an
    attention GRU decoder step.

The registry serves the first two; the last two are on no serving path in
either package.  Parameters are nested dicts of tensors with the JAX
package's keys and layout.  All run as plain PyTorch ops (the JAX package
runs no Pallas kernel for them): the recurrences are models/rnn.py's eager
lstm_scan and gru_scan, attention is written out as the JAX package
writes it, but for the transformer's attention on a card outside
training, which runs on the port's kernel (ops/attention_kernel.py).
`*_params_from_state_dict` converts equivalently-shaped torch checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops import attention_kernel
from ..options import ImageOptions
from .rnn import (
    dropout,
    gru_scan,
    init_gru_params,
    init_linear_params,
    init_lstm_params,
    linear,
    lstm_scan,
    uniform_init,
)
from .torch_convert import (
    _convert_gru,
    _convert_linear,
    _convert_lstm,
    _strip_module_prefix,
    _to_numpy,
)

# ---------------------------------------------------------------------------
# Shared building blocks
# ---------------------------------------------------------------------------


def _conv2d(x, w, *, stride=(1, 1)):
    """NCHW conv with 'same'-style explicit padding matching torch
    Conv2d(padding=p) when the kernel is odd; w: (O, I, kh, kw)."""
    kh, kw = w.shape[2], w.shape[3]
    return F.conv2d(x, w, stride=stride, padding=(kh // 2, kw // 2))


def _conv2d_valid(x, w, *, stride=(1, 1)):
    return F.conv2d(x, w, stride=stride)


def _batchnorm2d(x, p, *, train=False, eps=1e-5):
    """BatchNorm2d over NCHW.  Inference uses running stats; training uses
    batch statistics."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
    else:
        mean, var = p["mean"], p["var"]
    scale = p["gamma"] * torch.rsqrt(var + eps)
    shift = p["beta"] - mean * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _init_bn(channels, dtype=torch.float32, device=None):
    return {
        "gamma": torch.ones((channels,), dtype=dtype, device=device),
        "beta": torch.zeros((channels,), dtype=dtype, device=device),
        "mean": torch.zeros((channels,), dtype=dtype, device=device),
        "var": torch.ones((channels,), dtype=dtype, device=device),
    }


def _init_conv(generator, out_ch, in_ch, kh, kw, dtype=torch.float32,
               device=None):
    """A plain U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the JAX package
    draws it."""
    fan_in = in_ch * kh * kw
    return uniform_init(generator, (out_ch, in_ch, kh, kw),
                        1.0 / fan_in ** 0.5, dtype, device)


def _convert_bn(sd, prefix):
    return {
        "gamma": _to_numpy(sd[f"{prefix}.weight"]),
        "beta": _to_numpy(sd[f"{prefix}.bias"]),
        "mean": _to_numpy(sd[f"{prefix}.running_mean"]),
        "var": _to_numpy(sd[f"{prefix}.running_var"]),
    }


def _convert_conv(sd, prefix):
    return _to_numpy(sd[f"{prefix}.weight"]).copy()


# ---------------------------------------------------------------------------
# 1. No-CNN transducer (simple_model_no_cnn.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoCnnConfig:
    image_features: int = ImageOptions.IMAGE_HEIGHT            # 26
    window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1        # 33
    hidden: int = 128                                           # lstm_1/2_hidden_size
    num_type_classes: int = ImageOptions.TOTAL_TYPE_LABELS      # 3


_NO_CNN_PYRAMID = (256, 128, 64, 32, 16)                        # linear_1..5


def init_no_cnn_params(generator, config: NoCnnConfig = NoCnnConfig(),
                       dtype=torch.float32, device=None):
    H = config.hidden
    params = {
        "encoder": init_lstm_params(generator, config.image_features, H,
                                    dtype, device),
        "decoder": init_lstm_params(generator, config.image_features, H,
                                    dtype, device),
    }
    sizes = (2 * H * config.window,) + _NO_CNN_PYRAMID
    for i in range(5):
        params[f"linear_{i + 1}"] = init_linear_params(
            generator, sizes[i], sizes[i + 1], dtype, device)
    params["output_layer"] = init_linear_params(
        generator, _NO_CNN_PYRAMID[-1], config.num_type_classes, dtype,
        device)
    return params


def no_cnn_logits(params, x):
    """Forward to logits.  Reference quirk preserved: the encoder's sequence
    output is *discarded* — only its final (hidden, cell) per direction seeds
    the decoder, which re-reads the original input
    (simple_model_no_cnn.py:53-57: `x_out, (hidden, cell) = encoder(x);
    x, _ = decoder(x, (hidden, cell))`)."""
    enc = params["encoder"]
    _, (hf, cf) = lstm_scan(x, enc["w_ih_f"], enc["w_hh_f"], enc["b_f"])
    _, (hb, cb) = lstm_scan(x, enc["w_ih_b"], enc["w_hh_b"], enc["b_b"],
                            reverse=True)
    dec = params["decoder"]
    fwd, _ = lstm_scan(x, dec["w_ih_f"], dec["w_hh_f"], dec["b_f"],
                       h0=hf, c0=cf)
    bwd, _ = lstm_scan(x, dec["w_ih_b"], dec["w_hh_b"], dec["b_b"],
                       h0=hb, c0=cb, reverse=True)
    out = torch.cat([fwd, bwd], dim=-1)
    out = out.reshape(out.shape[0], -1)
    for i in range(1, 6):
        out = F.relu(linear(out, params[f"linear_{i}"]))
    return linear(out, params["output_layer"])


def no_cnn_apply(params, x, *, train=False):
    """Logits in train mode (paired with the cross-entropy loss), float32
    probabilities otherwise."""
    logits = no_cnn_logits(params, x)
    if train:
        return logits
    return torch.softmax(logits.float(), dim=1)


def no_cnn_params_from_state_dict(state_dict):
    sd = _strip_module_prefix(state_dict)
    params = {
        "encoder": _convert_lstm(sd, "encoder"),
        "decoder": _convert_lstm(sd, "decoder"),
    }
    for i in range(1, 6):
        params[f"linear_{i}"] = _convert_linear(sd, f"linear_{i}")
    params["output_layer"] = _convert_linear(sd, "output_layer")
    return params


# ---------------------------------------------------------------------------
# 2. Transformer window classifier (simple_model_transformers.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransformerConfig:
    image_features: int = ImageOptions.IMAGE_HEIGHT            # 26
    window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1        # 33
    conv_channels: int = 4                                      # out_channel
    num_heads: int = 8
    num_layers: int = 6
    ffn_size: int = 2048                                        # torch default
    num_type_classes: int = ImageOptions.TOTAL_TYPE_LABELS      # 3

    @property
    def d_model(self):
        return self.conv_channels * self.image_features          # 104


_TFM_PYRAMID = (128, 64, 32, 16, 8)


def init_transformer_params(generator,
                            config: TransformerConfig = TransformerConfig(),
                            dtype=torch.float32, device=None):
    D = config.d_model
    params = {
        "conv1": _init_conv(generator, config.conv_channels, 1, 3, 3, dtype,
                            device),
        "bn1": _init_bn(config.conv_channels, dtype, device),
        "conv2": _init_conv(generator, config.conv_channels,
                            config.conv_channels, 3, 3, dtype, device),
        "bn2": _init_bn(config.conv_channels, dtype, device),
        # keyed "0".."N-1" (not a list) so checkpoint '/'-flattening works
        "layers": {},
    }
    for i in range(config.num_layers):
        params["layers"][str(i)] = {
            # packed qkv like torch's in_proj: (D, 3D) right-multiply layout
            "w_qkv": uniform_init(generator, (D, 3 * D), 1.0 / D ** 0.5,
                                  dtype, device),
            "b_qkv": torch.zeros((3 * D,), dtype=dtype, device=device),
            "out_proj": init_linear_params(generator, D, D, dtype, device),
            "ffn_1": init_linear_params(generator, D, config.ffn_size,
                                        dtype, device),
            "ffn_2": init_linear_params(generator, config.ffn_size, D,
                                        dtype, device),
            "norm1": {"gamma": torch.ones((D,), dtype=dtype, device=device),
                      "beta": torch.zeros((D,), dtype=dtype, device=device)},
            "norm2": {"gamma": torch.ones((D,), dtype=dtype, device=device),
                      "beta": torch.zeros((D,), dtype=dtype, device=device)},
        }
    sizes = (D * config.window,) + _TFM_PYRAMID
    for i in range(5):
        params[f"linear_{i + 1}"] = init_linear_params(
            generator, sizes[i], sizes[i + 1], dtype, device)
    params["output_layer"] = init_linear_params(
        generator, _TFM_PYRAMID[-1], config.num_type_classes, dtype, device)
    return params


def _layernorm(x, p, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]


def _mha(x, lp, num_heads):
    """Self-attention, torch nn.MultiheadAttention semantics (packed qkv,
    per-head scaled dot product: ops/attention_kernel.py's route)."""
    qkv = x @ lp["w_qkv"] + lp["b_qkv"]
    return linear(attention_kernel.attention(qkv, num_heads), lp["out_proj"])


def _encoder_layer(x, lp, num_heads, generator=None, dropout_rate=0.1):
    """Post-LN torch TransformerEncoderLayer (norm_first=False):
    x = LN(x + drop(SA(x))); x = LN(x + drop(FFN(x))); torch's default
    dropout=0.1 applies in train mode (generator given), identity at
    eval."""
    sa = _mha(x, lp, num_heads)
    if generator is not None:
        sa = dropout(sa, dropout_rate, generator)
    x = _layernorm(x + sa, lp["norm1"])
    hidden = F.relu(linear(x, lp["ffn_1"]))
    if generator is not None:
        hidden = dropout(hidden, dropout_rate, generator)
    ffn = linear(hidden, lp["ffn_2"])
    if generator is not None:
        ffn = dropout(ffn, dropout_rate, generator)
    return _layernorm(x + ffn, lp["norm2"])


def transformer_logits(params, x, *,
                       config: TransformerConfig = TransformerConfig(),
                       train=False, generator=None):
    """x: (B, T, F) float -> (B, 3) logits.

    Mirrors simple_model_transformers.py:42-83 including its reshape quirk:
    the (B, C, T, F) conv output is row-major-reshaped (not transposed) to
    (B, T, C*F) before the encoder (`:57`).  In train mode with a
    generator, the reference's dropouts apply (0.1 in the encoder layers;
    0.1/0.1/0.2/0.1 in the linear pyramid, `:32-33,:67-79`)."""
    B, T, F_ = x.shape
    drop = generator if train else None
    img = x[:, None, :, :]                       # (B,1,T,F) NCHW
    out = _conv2d(img, params["conv1"])
    out = F.relu(_batchnorm2d(out, params["bn1"], train=train))
    out = _conv2d(out, params["conv2"])
    out = _batchnorm2d(out, params["bn2"], train=train)
    out = F.relu(out + img)                      # 1-channel residual broadcast
    out = out.reshape(B, T, config.conv_channels * F_)
    for i in range(len(params["layers"])):
        out = _encoder_layer(out, params["layers"][str(i)], config.num_heads,
                             generator=drop)
    out = out.reshape(B, -1)
    pyramid_dropout = (0.1, 0.1, 0.2, 0.1)
    for i in range(1, 6):
        out = F.relu(linear(out, params[f"linear_{i}"]))
        if drop is not None and i <= 4:
            out = dropout(out, pyramid_dropout[i - 1], drop)
    return linear(out, params["output_layer"])


def transformer_calibrate_batchnorm(params, x):
    """Fold BatchNorm running statistics from a calibration batch into the
    params (post-training calibration): train mode normalizes with batch
    stats and this sets the inference-time running stats from
    representative data.  Returns a new params tree."""
    img = torch.as_tensor(x).to(params["conv1"].device,
                                torch.float32)[:, None, :, :]
    out1 = _conv2d(img, params["conv1"])
    bn1 = dict(params["bn1"])
    bn1["mean"] = out1.mean(dim=(0, 2, 3))
    bn1["var"] = out1.var(dim=(0, 2, 3), correction=0)
    out1 = F.relu(_batchnorm2d(out1, bn1))
    out2 = _conv2d(out1, params["conv2"])
    bn2 = dict(params["bn2"])
    bn2["mean"] = out2.mean(dim=(0, 2, 3))
    bn2["var"] = out2.var(dim=(0, 2, 3), correction=0)
    new_params = dict(params)
    new_params["bn1"] = bn1
    new_params["bn2"] = bn2
    return new_params


def transformer_apply(params, x, *,
                      config: TransformerConfig = TransformerConfig(),
                      train=False, generator=None):
    """Logits in train mode (dropout drawn from `generator` when given),
    float32 probabilities otherwise."""
    logits = transformer_logits(params, x, config=config, train=train,
                                generator=generator)
    if train:
        return logits
    return torch.softmax(logits.float(), dim=1)


def transformer_params_from_state_dict(state_dict):
    sd = _strip_module_prefix(state_dict)
    params = {
        "conv1": _convert_conv(sd, "conv1"),
        "bn1": _convert_bn(sd, "bn1"),
        "conv2": _convert_conv(sd, "conv2"),
        "bn2": _convert_bn(sd, "bn2"),
        "layers": {},
    }
    i = 0
    while f"encoder.layers.{i}.self_attn.in_proj_weight" in sd:
        pre = f"encoder.layers.{i}"
        params["layers"][str(i)] = ({
            "w_qkv": _to_numpy(sd[f"{pre}.self_attn.in_proj_weight"]).T.copy(),
            "b_qkv": _to_numpy(sd[f"{pre}.self_attn.in_proj_bias"]),
            "out_proj": _convert_linear(sd, f"{pre}.self_attn.out_proj"),
            "ffn_1": _convert_linear(sd, f"{pre}.linear1"),
            "ffn_2": _convert_linear(sd, f"{pre}.linear2"),
            "norm1": {"gamma": _to_numpy(sd[f"{pre}.norm1.weight"]),
                      "beta": _to_numpy(sd[f"{pre}.norm1.bias"])},
            "norm2": {"gamma": _to_numpy(sd[f"{pre}.norm2.weight"]),
                      "beta": _to_numpy(sd[f"{pre}.norm2.bias"])},
        })
        i += 1
    for j in range(1, 6):
        params[f"linear_{j}"] = _convert_linear(sd, f"linear_{j}")
    params["output_layer"] = _convert_linear(sd, "output_layer")
    return params


# ---------------------------------------------------------------------------
# 3. Polish mini-ResNet feature extractor (pepper resnet.py)
# ---------------------------------------------------------------------------


def init_resnet_params(generator, dtype=torch.float32, device=None):
    """resnet18_custom: two 1-channel BasicConv2d stems (kernel (1,4)/s(1,4),
    then 1x1) + one 1-plane BasicBlock (resnet.py:49-94)."""
    def conv(kh, kw):
        return _init_conv(generator, 1, 1, kh, kw, dtype, device)

    return {
        "stem0_conv": conv(1, 4),
        "stem0_bn": _init_bn(1, dtype, device),
        "stem1_conv": conv(1, 1),
        "stem1_bn": _init_bn(1, dtype, device),
        "block_conv1": conv(3, 3),
        "block_bn1": _init_bn(1, dtype, device),
        "block_conv2": conv(3, 3),
        "block_bn2": _init_bn(1, dtype, device),
    }


def resnet_apply(params, x, *, train=False):
    """x: (B, 1, T, F) NCHW -> (B, 1, T, (F-4)//4 + 1).  BasicConv2d uses
    eps=0.001 (resnet.py:15); the BasicBlock BNs use the torch default."""
    out = _conv2d_valid(x, params["stem0_conv"], stride=(1, 4))
    out = F.relu(_batchnorm2d(out, params["stem0_bn"], train=train,
                              eps=1e-3))
    out = _conv2d_valid(out, params["stem1_conv"])
    out = F.relu(_batchnorm2d(out, params["stem1_bn"], train=train,
                              eps=1e-3))
    residual = out
    y = _conv2d(out, params["block_conv1"])
    y = F.relu(_batchnorm2d(y, params["block_bn1"], train=train))
    y = _conv2d(y, params["block_conv2"])
    y = _batchnorm2d(y, params["block_bn2"], train=train)
    return F.relu(y + residual)


def resnet_params_from_state_dict(state_dict):
    sd = _strip_module_prefix(state_dict)
    return {
        "stem0_conv": _convert_conv(sd, "Context_Conv2d_0a.conv"),
        "stem0_bn": _convert_bn(sd, "Context_Conv2d_0a.bn"),
        "stem1_conv": _convert_conv(sd, "Context_Conv2d_1a.conv"),
        "stem1_bn": _convert_bn(sd, "Context_Conv2d_1a.bn"),
        "block_conv1": _convert_conv(sd, "layer1.0.conv1"),
        "block_bn1": _convert_bn(sd, "layer1.0.bn1"),
        "block_conv2": _convert_conv(sd, "layer1.0.conv2"),
        "block_bn2": _convert_bn(sd, "layer1.0.bn2"),
    }


# ---------------------------------------------------------------------------
# 4. Seq2Seq attention polisher (pepper Seq2Seq_atn.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Seq2SeqConfig:
    # The reference hardcodes GRU input 5 (Seq2Seq_atn.py:69): the resnet
    # stem maps image width 20 -> (20-4)//4+1 = 5 feature columns.
    image_features: int = 20
    hidden: int = 128
    num_classes: int = 5

    @property
    def cnn_features(self):
        return (self.image_features - 4) // 4 + 1


def init_seq2seq_params(generator, config: Seq2SeqConfig = Seq2SeqConfig(),
                        dtype=torch.float32, device=None):
    H = config.hidden
    return {
        "cnn": init_resnet_params(generator, dtype, device),
        "encoder_gru": init_gru_params(generator, config.cnn_features, H,
                                       dtype, device),
        "decoder_gru": init_gru_params(generator, config.num_classes, H,
                                       dtype, device),
        "attn_out": init_linear_params(generator, 2 * H, H, dtype, device),
        "out": init_linear_params(generator, H, config.num_classes, dtype,
                                  device),
    }


def _bigru_summed(x, p, h0_f=None, h0_b=None):
    """Bidirectional GRU whose direction outputs are *summed*, the
    reference's merge (Seq2Seq_atn.py:82-85), not concatenated."""
    fwd, hf = gru_scan(x, p["w_ih_f"], p["w_hh_f"], p["b_ih_f"], p["b_hh_f"],
                       h0=h0_f)
    bwd, hb = gru_scan(x, p["w_ih_b"], p["w_hh_b"], p["b_ih_b"], p["b_hh_b"],
                       h0=h0_b, reverse=True)
    return fwd + bwd, (hf, hb)


def seq2seq_encode(params, images, *, train=False):
    """EncoderCRNN.forward (Seq2Seq_atn.py:72-89): resnet features ->
    (B, T, F') -> summed biGRU.  images: (B, 1, T, F) NCHW.
    Returns (context (B,T,H), hidden (hf, hb))."""
    feats = resnet_apply(params["cnn"], images, train=train)
    B, C, T, Fp = feats.shape
    feats = feats.permute(0, 2, 1, 3).reshape(B, T, C * Fp)
    return _bigru_summed(feats, params["encoder_gru"])


def _attention(output, context, attn_out):
    """Luong-style attention (Seq2Seq_atn.py:28-46): scores =
    output . context^T, mix = softmax(scores) . context, out =
    tanh(W[mix; output]); the softmax in float32 at least."""
    attn = torch.einsum("bod,bid->boi", output, context)
    attn = torch.softmax(
        attn.to(torch.promote_types(attn.dtype, torch.float32)),
        dim=-1).to(output.dtype)
    mix = torch.einsum("boi,bid->bod", attn, context)
    combined = torch.cat([mix, output], dim=-1)
    return torch.tanh(linear(combined, attn_out)), attn


def seq2seq_decode_step(params, class_onehot, context, hidden):
    """AttnDecoderRNN.forward_step (Seq2Seq_atn.py:112-126): one-step biGRU
    over the previous-class one-hot, direction-summed, attention over the
    encoder context, linear head.  class_onehot: (B, num_classes);
    hidden: (hf, hb) each (B, H).  Returns (logits (B, C), hidden, attn)."""
    x = class_onehot[:, None, :]                     # (B, 1, C)
    out, hidden = _bigru_summed(x, params["decoder_gru"],
                                h0_f=hidden[0], h0_b=hidden[1])
    out, attn = _attention(out, context, params["attn_out"])
    logits = linear(out[:, 0, :], params["out"])
    return logits, hidden, attn


def seq2seq_params_from_state_dict(state_dict, cnn_prefix="encoder"):
    """Convert torch EncoderCRNN + AttnDecoderRNN state dicts merged under
    'encoder.' / 'decoder.' prefixes."""
    sd = _strip_module_prefix(state_dict)
    cnn_sd = {k[len("encoder.cnn_encoder.cnn."):]: v for k, v in sd.items()
              if k.startswith("encoder.cnn_encoder.cnn.")}
    return {
        "cnn": resnet_params_from_state_dict(cnn_sd),
        "encoder_gru": _convert_gru(sd, "encoder.gru"),
        "decoder_gru": _convert_gru(sd, "decoder.gru"),
        "attn_out": _convert_linear(sd, "decoder.attention.linear_out"),
        "out": _convert_linear(sd, "decoder.out"),
    }
