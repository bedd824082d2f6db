"""Batched inference over candidate windows on one torch device or, data
parallel, on several.

Windows stream in-process into padded batches through the transducer, in
float or in one of the int8 serving modes of models/quantize.py: the int8
window images are uploaded as int8 from pinned host memory and cast to
the compute dtype on the device; `dispatch` enqueues a batch and returns at
once, `resolve` waits for it, so the streaming pipeline overlaps batch k's
device work with host window generation for batch k+1.  On a card,
`dispatch` also queues the copy of the batch's probabilities into pinned
host memory right behind its forward, and the batch's event is recorded
after that copy: `resolve` waits only for its own batch, never for the
forward of a batch dispatched after it.

With a list of devices (the JAX package's mesh runner), the parameters are
replicated once on every device, the batch and every bucket are rounded up
to a multiple of the device count, and each padded batch is split into
contiguous row blocks, one a device in list order: each block is uploaded
and enqueued on its own device's current stream before any is waited on,
and `resolve` waits on each block's event and concatenates in order.

While a torch.profiler session is active, `dispatch` and `resolve` are
spans (utils/profiling.py) that share the batch's id, their phases the
children: `runner.dispatch.stack`, `.stage`, `.enqueue`;
`runner.resolve.wait` (the event), `.fetch` (the host copy's read),
`.objects`.  Always on, `profiling.resolve_ready()` counts the resolves
whose every block had completed when its wait began.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..decode.candidate_finder import CandidatePrediction
from ..device import resolve_device
from ..models import quantize
from ..models.transducer import map_params, params_from_jax
from ..options import ImageOptions
from ..parallel.mesh import round_up
from ..utils import profiling


class InferenceRunner:
    def __init__(self, params, batch_size: int = 512,
                 compute_dtype: str = "float32",
                 window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                 features: int = ImageOptions.IMAGE_HEIGHT,
                 quantized: bool = False, model_type: str = "lstm",
                 quantize_mode: str = "static", device=None, devices=None):
        """device: the one torch device (cuda unless given); devices: a
        list of more than one to run data parallel over (it overrides
        device)."""
        if quantize_mode not in quantize.QUANTIZE_MODES:
            raise ValueError(f"unknown quantize_mode {quantize_mode!r}")
        if quantized and model_type != "lstm":
            raise ValueError("quantized serving is only supported for "
                             "the lstm family")
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.num_devices = len(self.devices)
        # every bucket splits into equal blocks, one a device (see _bucket)
        self.batch_size = round_up(batch_size, self.num_devices)
        self.window = window
        self.features = features
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self.model_type = model_type
        self.quantized = quantized
        self.quantize_mode = quantize_mode
        # every tree is made resident on each device once, its dtypes set
        # once, so a dispatch moves only the windows: (params, scales) a
        # device
        if not quantized:
            from ..models.registry import make_family

            self._family_infer = make_family(
                model_type, image_features=features, window=window).infer
            self._trees = [(map_params(lambda p: p.to(self.compute_dtype),
                                       params_from_jax(params, d)), None)
                           for d in self.devices]
        elif quantize_mode == "dynamic":
            q, scales = quantize.quantize_params(params)
            self._trees = [(params_from_jax(q, d), params_from_jax(scales, d))
                           for d in self.devices]
        else:
            # quantized once; each device's copy has its int8 weights
            # relaid once (prepare_static -> cuda_build.keep_relaid)
            q = quantize.quantize_params_static(
                params, rec_int8=quantize_mode == "static_rec")
            self._trees = [(quantize.prepare_static(q, self.compute_dtype, d),
                            None) for d in self.devices]
        self.params = self._trees[0][0]

    def _forward(self, padded: torch.Tensor, tree) -> torch.Tensor:
        """One device's forward over its block, with that device's
        (params, scales)."""
        params, scales = tree
        if not self.quantized:
            return self._family_infer(params, padded, self.compute_dtype)
        if self.quantize_mode == "dynamic":
            # the recurrences run in bfloat16 whatever compute_dtype says,
            # as in the JAX package's runner
            return quantize.transducer_infer_quantized(params, scales, padded)
        return quantize.transducer_infer_static(params, padded,
                                                self.compute_dtype)

    @staticmethod
    def _upload_dtype(images: np.ndarray):
        """int8 window images ship to the device as int8 (a quarter of the
        float32 bytes), for every family, and are cast to the compute dtype
        on the device; the cast is exact because every int8 value is exact
        in bfloat16 and float32.  Other inputs ship as float32."""
        return np.int8 if images.dtype == np.int8 else np.float32

    def _bucket(self, n: int) -> int:
        """Pad size for an n-window chunk: the next power of two (floor
        256), capped at batch_size and rounded up to the device count, so
        partial batches do not carry full-size zero padding and every
        device gets an equal block."""
        b = 256
        while b < n:
            b <<= 1
        return max(round_up(min(b, self.batch_size), self.num_devices), n)

    def _enqueue(self, chunk: np.ndarray, dtype):
        """Upload one chunk of at most batch_size windows, zero-padded to
        its bucket, and enqueue its forward without waiting: one contiguous
        row block a device, each on its device's current stream.  Returns
        the blocks that hold windows, as (probabilities of those windows,
        None) on the CPU, and on a card as (a pinned host tensor that the
        probabilities are copied into behind the forward, a CUDA event
        recorded after that copy)."""
        n = len(chunk)
        with profiling.span("runner.dispatch.stage"):
            bucket = self._bucket(n)
            profiling.count_rows("runner", n, bucket)
            # one pinned staging buffer from torch's caching host
            # allocator: it is not handed out again until every copy from
            # it has completed
            pinned = any(d.type == "cuda" for d in self.devices)
            host = torch.empty((bucket, self.window, self.features),
                               dtype=torch.int8 if dtype == np.int8
                               else torch.float32, pin_memory=pinned)
            view = host.numpy()
            view[:n] = chunk
            view[n:] = 0
        per = bucket // self.num_devices
        used = -(-n // per)     # the devices whose rows hold windows
        blocks = []
        with profiling.span("runner.dispatch.enqueue"):
            # every upload is queued before any forward, and the staging
            # block freed right after them: the host allocator records its
            # reuse event on each stream's tail when the block is freed, so
            # its reuse waits for the uploads alone, not for the forwards
            xs = [host[i * per:(i + 1) * per].to(
                device, non_blocking=device.type == "cuda")
                for i, device in enumerate(self.devices[:used])]
            del host, view
            for i, (device, tree, x) in enumerate(zip(self.devices,
                                                      self._trees, xs)):
                cuda = device.type == "cuda"
                with torch.cuda.device(device) if cuda else \
                        contextlib.nullcontext():
                    probs = self._forward(x, tree)[:min(per, n - i * per)]
                    event = None
                    if cuda:
                        # queued now, the copy runs before any later
                        # batch's forward on this stream; its pinned block
                        # is not handed out again until the copy completes
                        out = torch.empty(probs.shape, dtype=probs.dtype,
                                          pin_memory=True)
                        out.copy_(probs, non_blocking=True)
                        probs = out
                        event = torch.cuda.Event()
                        event.record()
                blocks.append((probs, event))
        return blocks

    @staticmethod
    def _gather(blocks) -> np.ndarray:
        """Wait on each block's event, in order, and concatenate the
        blocks into a new array (a pinned block goes back to the host
        allocator's cache once its handle is dropped, so no result may be a
        view of it).  Counts the call in profiling.resolve_ready(), ready
        if every block's event had completed when its wait began."""
        out = []
        ready = True
        for probs, event in blocks:
            with profiling.span("runner.resolve.wait"):
                if event is not None:
                    ready = event.query() and ready
                    event.synchronize()
            with profiling.span("runner.resolve.fetch"):
                out.append(probs.numpy())
        profiling.count_resolve(ready)
        return np.concatenate(out) if out else np.zeros((0, 3), np.float32)

    def predict_images(self, images: np.ndarray) -> np.ndarray:
        """(N, window, features) -> (N, 3) float32 probabilities."""
        n = len(images)
        if n == 0:
            return np.zeros((0, 3), np.float32)
        dtype = self._upload_dtype(images)
        probs_out = np.zeros((n, 3), np.float32)
        for start in range(0, n, self.batch_size):
            chunk = images[start:start + self.batch_size]
            probs_out[start:start + len(chunk)] = self._gather(
                self._enqueue(chunk, dtype))
        return probs_out

    def dispatch(self, windows):
        """Upload and enqueue ONE window batch without waiting for it;
        resolve() returns its predictions.  The handle holds the device
        blocks of _enqueue and the batch id that dispatch's and resolve's
        spans share."""
        if not windows:
            return (None, windows, np.zeros((0, 3), np.float32), None)
        batch = profiling.new_batch()
        with profiling.span("runner.dispatch", batch):
            with profiling.span("runner.dispatch.stack"):
                images = np.stack([w.image for w in windows])
            if len(images) > self.batch_size:
                # oversized chunk: the synchronous multi-batch loop
                return (None, windows, self.predict_images(images), batch)
            return (self._enqueue(images, self._upload_dtype(images)),
                    windows, None, batch)

    def resolve(self, handle) -> list[CandidatePrediction]:
        blocks, windows, probs, batch = handle
        with profiling.span("runner.resolve", batch):
            if probs is None:
                probs = self._gather(blocks)
            with profiling.span("runner.resolve.objects"):
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
