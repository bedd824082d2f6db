"""Batched inference over candidate windows on one torch device.

Windows stream in-process into padded batches through the transducer, in
float or in one of the int8 serving modes of models/quantize.py: the int8
window images are uploaded as int8 from pinned host memory and cast to
the compute dtype on the device; `dispatch` enqueues a batch and returns at
once, `resolve` waits for it, so the streaming pipeline overlaps batch k's
device work with host window generation for batch k+1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decode.candidate_finder import CandidatePrediction
from ..device import resolve_device
from ..models import quantize
from ..models.transducer import map_params, params_from_jax
from ..options import ImageOptions


class InferenceRunner:
    def __init__(self, params, batch_size: int = 512,
                 compute_dtype: str = "float32",
                 window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                 features: int = ImageOptions.IMAGE_HEIGHT,
                 quantized: bool = False, model_type: str = "lstm",
                 quantize_mode: str = "static", device=None):
        if quantize_mode not in quantize.QUANTIZE_MODES:
            raise ValueError(f"unknown quantize_mode {quantize_mode!r}")
        if quantized and model_type != "lstm":
            raise ValueError("quantized serving is only supported for "
                             "the lstm family")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.window = window
        self.features = features
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self.model_type = model_type
        self.quantized = quantized
        self.quantize_mode = quantize_mode
        # one device; a multi-device runner must keep every bucket divisible
        # by this count (see _bucket)
        self.num_devices = 1
        # every tree is made device-resident once, its dtypes set once, so
        # a dispatch moves only the windows
        if not quantized:
            from ..models.registry import make_family

            self._family_infer = make_family(
                model_type, image_features=features, window=window).infer
            self.params = map_params(
                lambda p: p.to(self.compute_dtype),
                params_from_jax(params, self.device))
        elif quantize_mode == "dynamic":
            q, scales = quantize.quantize_params(params)
            self.params = params_from_jax(q, self.device)
            self._scales = params_from_jax(scales, self.device)
        else:
            self.params = quantize.prepare_static(
                quantize.quantize_params_static(
                    params, rec_int8=quantize_mode == "static_rec"),
                self.compute_dtype, self.device)

    def _forward(self, padded: torch.Tensor) -> torch.Tensor:
        if not self.quantized:
            return self._family_infer(self.params, padded,
                                      self.compute_dtype)
        if self.quantize_mode == "dynamic":
            # the recurrences run in bfloat16 whatever compute_dtype says,
            # as in the JAX package's runner
            return quantize.transducer_infer_quantized(
                self.params, self._scales, padded)
        return quantize.transducer_infer_static(self.params, padded,
                                                self.compute_dtype)

    def _upload_dtype(self, images: np.ndarray):
        """int8 window images ship to the device as int8 (a quarter of the
        float32 bytes) and are cast to the compute dtype on the device; the
        cast is exact because every int8 value is exact in bfloat16 and
        float32.  Other inputs ship as float32."""
        if self.model_type == "lstm" and images.dtype == np.int8:
            return np.int8
        return np.float32

    def _bucket(self, n: int) -> int:
        """Pad size for an n-window chunk: the next power of two (floor
        256), capped at batch_size, so partial batches do not carry
        full-size zero padding."""
        b = 256
        while b < n:
            b <<= 1
        b = max(min(b, self.batch_size), n)
        assert b % self.num_devices == 0, (b, self.num_devices)
        return b

    def _upload(self, chunk: np.ndarray, dtype) -> torch.Tensor:
        """Zero-padded (bucket, window, features) batch on the device."""
        shape = (self._bucket(len(chunk)), self.window, self.features)
        torch_dtype = torch.int8 if dtype == np.int8 else torch.float32
        if self.device.type != "cuda":
            host = torch.zeros(shape, dtype=torch_dtype)
            host.numpy()[:len(chunk)] = chunk
            return host.to(self.device)
        # pinned staging buffer from torch's caching host allocator: it is
        # not handed out again until this copy has completed
        host = torch.empty(shape, dtype=torch_dtype, pin_memory=True)
        view = host.numpy()
        view[:len(chunk)] = chunk
        view[len(chunk):] = 0
        return host.to(self.device, non_blocking=True)

    def predict_images(self, images: np.ndarray) -> np.ndarray:
        """(N, window, features) -> (N, 3) float32 probabilities."""
        n = len(images)
        if n == 0:
            return np.zeros((0, 3), np.float32)
        dtype = self._upload_dtype(images)
        probs_out = np.zeros((n, 3), np.float32)
        for start in range(0, n, self.batch_size):
            chunk = images[start:start + self.batch_size]
            probs = self._forward(self._upload(chunk, dtype))
            probs_out[start:start + len(chunk)] = \
                probs[:len(chunk)].cpu().numpy()
        return probs_out

    def dispatch(self, windows):
        """Upload and enqueue ONE window batch without waiting for it;
        resolve() returns its predictions.  The handle holds the device
        probabilities and a CUDA event recorded after them (None on the
        CPU, where the forward has already run)."""
        if not windows:
            return (None, None, windows, np.zeros((0, 3), np.float32))
        images = np.stack([w.image for w in windows])
        if len(images) > self.batch_size:
            # oversized chunk: the synchronous multi-batch loop
            return (None, None, windows, self.predict_images(images))
        probs = self._forward(
            self._upload(images, self._upload_dtype(images)))[:len(images)]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return (probs, event, windows, None)

    def resolve(self, handle) -> list[CandidatePrediction]:
        dev, event, windows, probs = handle
        if probs is None:
            if event is not None:
                event.synchronize()
            probs = dev.cpu().numpy()
        return [
            CandidatePrediction(
                contig=w.contig, position=w.position, depth=w.depth,
                candidates=list(w.candidates),
                candidate_frequency=list(w.candidate_frequency),
                prediction_base=probs[i])
            for i, w in enumerate(windows)
        ]

    def predict(self, windows) -> list[CandidatePrediction]:
        """CandidateWindow list -> CandidatePrediction list."""
        if not windows:
            return []
        return self.resolve(self.dispatch(windows))


def fake_predict(windows) -> list[CandidatePrediction]:
    """Ground-truth passthrough backend (the reference's --dry mode,
    predict_distributed_cpu_fake.py:12-51 + one-hot labels from
    dataloader.py:156-165): predictions are the one-hot type labels."""
    predictions = []
    for w in windows:
        probs = np.zeros(3, np.float64)
        probs[int(w.type_label)] = 1.0
        predictions.append(CandidatePrediction(
            contig=w.contig, position=w.position, depth=w.depth,
            candidates=list(w.candidates),
            candidate_frequency=list(w.candidate_frequency),
            prediction_base=probs))
    return predictions
