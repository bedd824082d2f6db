"""The variant-mode window classifier ("TransducerGRU" in the reference —
actually a stacked bidirectional LSTM; pepper_variant/.../models/simple_model.py:6-88).

  encoder: biLSTM(features -> 256)        -> (B, 33, 512)
  decoder: biLSTM(512 -> 256)             -> (B, 33, 512)
  flatten                                  -> (B, 33*512)
  5 x [Linear(512) + SELU (+dropout 0.2)] -> (B, 512)   (linear_1 maps 16896->512)
  head:   Linear(512 -> 3)                -> (B, 3)
  softmax at inference.

Parameters are a nested dict of tensors with the JAX package's keys and
layout (the same as its .npz checkpoints), so `params_from_jax`
(models/params.py, re-exported here) is a copy.
`Transducer` is the nn.Module that holds such a dict.  Inference runs
`_fused_logits`: both biLSTMs through the fused LSTM kernel
(ops/lstm_kernel.py), time-major throughout, and linear_1 as two products
against views of its weight; the dense layers are torch.matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..options import ImageOptions
from .params import map_params, params_from_jax  # noqa: F401
from .rnn import (bilstm, dropout, init_linear_params, init_lstm_params,
                  linear)

DENSE_LAYERS = ("linear_1", "linear_2", "linear_3", "linear_4", "linear_5",
                "output_layer_type")


@dataclass(frozen=True)
class TransducerConfig:
    image_features: int = ImageOptions.IMAGE_HEIGHT          # 26 (48 for HP)
    window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1      # 33 (21 for HP)
    hidden: int = 256
    linear_size: int = 512
    num_type_classes: int = ImageOptions.TOTAL_TYPE_LABELS    # 3
    dropout: float = 0.2


def init_transducer_params(generator: torch.Generator,
                           config: TransducerConfig = TransducerConfig(),
                           dtype=torch.float32, device=None):
    H, L = config.hidden, config.linear_size
    params = {
        "encoder": init_lstm_params(generator, config.image_features, H,
                                    dtype, device),
        "decoder": init_lstm_params(generator, 2 * H, H, dtype, device),
        "linear_1": init_linear_params(generator, 2 * H * config.window, L,
                                       dtype, device),
    }
    for name in ("linear_2", "linear_3", "linear_4", "linear_5"):
        params[name] = init_linear_params(generator, L, L, dtype, device)
    params["output_layer_type"] = init_linear_params(
        generator, L, config.num_type_classes, dtype, device)
    return params


class Transducer(nn.Module):
    """Holds a transducer parameter dict as nn.Parameters (no gradients:
    the port serves inference).  `params()` returns the nested dict the
    functions below take; `forward` returns class probabilities."""

    def __init__(self, params: dict):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({
                key: nn.Parameter(value, requires_grad=False)
                for key, value in group.items()})
            for name, group in params.items()})

    @classmethod
    def init(cls, generator: torch.Generator,
             config: TransducerConfig = TransducerConfig(),
             dtype=torch.float32, device=None) -> "Transducer":
        return cls(init_transducer_params(generator, config, dtype, device))

    def params(self) -> dict:
        return {name: dict(group.items())
                for name, group in self.layers.items()}

    def forward(self, x, compute_dtype=torch.float32):
        return transducer_infer(self.params(), x, compute_dtype)


def transducer_logits(params, x, *, train=False, dropout_rate=0.2,
                      generator=None):
    """Forward pass to logits. x: (B, T, F) float.  Inference runs the
    fused kernel path; train=True runs the eager biLSTM with dropout drawn
    from `generator` (when given)."""
    if not train:
        return _fused_logits(params, x)
    x = bilstm(x, params["encoder"], allow_kernel=False)
    x = bilstm(x, params["decoder"], allow_kernel=False)
    drop = generator is not None
    if drop:
        x = dropout(x, dropout_rate, generator)
    # row-major (t-major) flatten, same as torch.flatten(x, 1, 2)
    x = x.reshape(x.shape[0], -1)
    for name in ("linear_1", "linear_2", "linear_3", "linear_4"):
        x = F.selu(linear(x, params[name]))
        if drop:
            x = dropout(x, dropout_rate, generator)
    x = F.selu(linear(x, params["linear_5"]))
    return linear(x, params["output_layer_type"])


def _fused_logits(params, x):
    """Inference forward on the fused biLSTM (ops/lstm_kernel.py): the
    input projections run inside the kernel, the encoder->decoder handoff
    passes the fwd/bwd streams as separate feature parts (no concat),
    everything stays time-major, and the t-major flatten + linear_1 is two
    contractions against views of linear_1's weight."""
    from ..ops.lstm_kernel import bilstm_fused

    xt = x.transpose(0, 1).contiguous()  # (T, B, F) time-major
    f1, b1 = bilstm_fused((xt,), params["encoder"])
    f2, b2 = bilstm_fused((f1, b1), params["decoder"])

    T = xt.shape[0]
    w1 = params["linear_1"]["w"]          # (T*2H, L), rows t-major [fwd|bwd]
    H = w1.shape[0] // (2 * T)
    w1 = w1.reshape(T, 2 * H, -1)
    x = (torch.einsum("tbh,thl->bl", f2, w1[:, :H])
         + torch.einsum("tbh,thl->bl", b2, w1[:, H:])
         + params["linear_1"]["b"])

    x = F.selu(x)
    for name in ("linear_2", "linear_3", "linear_4", "linear_5"):
        x = F.selu(linear(x, params[name]))
    return linear(x, params["output_layer_type"])


def transducer_apply(params, x, *, train=False, generator=None):
    """Reference-equivalent forward: logits in train mode, softmax otherwise
    (simple_model.py:78-82)."""
    logits = transducer_logits(params, x, train=train, generator=generator)
    if train:
        return logits
    return torch.softmax(logits.float(), dim=1)


@torch.inference_mode()
def transducer_infer(params, x, compute_dtype=torch.float32):
    """Inference step: casts inputs and every param (the biases included)
    to compute_dtype (e.g. bfloat16 for serving) and returns float32 class
    probabilities."""
    params = map_params(lambda p: p.to(compute_dtype), params)
    return transducer_apply(params, x.to(compute_dtype), train=False)
