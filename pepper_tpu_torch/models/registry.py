"""Window-classifier model-family registry.

The reference's model layer ships several architectures
(simple_model.py, simple_model_no_cnn.py, simple_model_transformers.py);
the JAX package and this port serve three of them (lstm, no_cnn,
transformer), selectable end to end: checkpoints record the family in
their metadata and the runner builds it from there.  Each family
provides:
  init(generator)                     -> params dict
  logits(params, x, train, generator) -> (B, 3) logits
  infer(params, x, compute_dtype)     -> (B, 3) float32 probabilities
  calibrate(params, x)                -> params (optional post-training
                                         calibration, e.g. BatchNorm
                                         running stats from a batch)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..options import ImageOptions
from ..utils import profiling
from .params import map_params

MODEL_TYPES = ("lstm", "no_cnn", "transformer")


@dataclass(frozen=True)
class ModelFamily:
    name: str
    init: Callable
    logits: Callable
    infer: Callable
    calibrate: Callable | None = None


def _make_infer(logits_fn):
    """Inference of a family without kernels of its own: every float param
    and the windows in compute_dtype (bfloat16 for serving), softmax in
    float32."""

    @torch.inference_mode()
    def infer(params, x, compute_dtype=torch.float32):
        params = map_params(
            lambda p: p.to(compute_dtype) if p.is_floating_point() else p,
            params)
        logits = logits_fn(params, x.to(compute_dtype), False, None)
        return torch.softmax(logits.float(), dim=1)

    return infer


def make_family(name: str,
                image_features: int = ImageOptions.IMAGE_HEIGHT,
                window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                ) -> ModelFamily:
    """Build a family bound to concrete image dimensions (26x33 variant
    mode, 48x21 HP mode)."""
    if name == "lstm":
        from .transducer import (TransducerConfig, init_transducer_params,
                                 transducer_infer, transducer_logits)

        config = TransducerConfig(image_features=image_features,
                                  window=window)

        def logits(params, x, train, generator):
            return transducer_logits(params, x, train=train,
                                     generator=generator)

        def infer(params, x, compute_dtype=torch.float32):
            return transducer_infer(params, x, compute_dtype)

        return ModelFamily(
            name, lambda generator: init_transducer_params(generator, config),
            logits, infer)

    if name == "no_cnn":
        from .alternates import NoCnnConfig, init_no_cnn_params, no_cnn_logits

        config = NoCnnConfig(image_features=image_features, window=window)

        def logits(params, x, train, generator):
            return no_cnn_logits(params, x)

        return ModelFamily(
            name, lambda generator: init_no_cnn_params(generator, config),
            logits, _make_infer(logits))

    if name == "transformer":
        from .alternates import (TransformerConfig, init_transformer_params,
                                 transformer_calibrate_batchnorm,
                                 transformer_logits)

        config = TransformerConfig(image_features=image_features,
                                   window=window)

        def logits(params, x, train, generator):
            return transformer_logits(params, x, config=config, train=train,
                                      generator=generator)

        served = _make_infer(logits)

        # the forward's enqueue is one span
        def infer(params, x, compute_dtype=torch.float32):
            with profiling.span("transformer.forward"):
                return served(params, x, compute_dtype)

        return ModelFamily(
            name, lambda generator: init_transformer_params(generator,
                                                            config),
            logits, infer, calibrate=transformer_calibrate_batchnorm)

    raise ValueError(
        f"unknown model_type {name!r}; expected one of {MODEL_TYPES}")
