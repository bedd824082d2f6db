"""Consensus inference: hidden-state-carry sliding windows over 1000-column
chunks, the port of the JAX package's polish/consensus.py.

Reference semantics (pepper/modules/python/models/predict_distributed_cpu.py
:42-100): zero hidden (B, 2, 128); for i in range(0, 1000, 50) with window
100: logits, hidden = model(image[:, i:i+100], hidden); softmax votes
accumulate into a (B, 1000, 5) tensor; labels = argmax; phred from the vote
fraction with counts 2 in the interior and 1 in the 50-base edges.

The window loop is a Python loop carrying `hidden`.  On the fused path
(ops/gru_kernel.py, a CUDA tensor by default) the windows go time-major
through the kernels and the overlap-add happens once at the end, as two
shifted half-window concatenations; the unfused path adds each window's
probabilities into the votes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.params import params_from_jax
from ..models.polish_gru import polish_forward, polish_forward_fused
from ..models.quantize import (polish_forward_static,
                               polish_prepare_static,
                               polish_quantize_params_static)
from ..ops.gru_kernel import use_fused_gru
from ..options import PolishImageOptions
from ..parallel.mesh import round_up
from ..utils import profiling

SEQ_LENGTH = PolishImageOptions.SEQ_LENGTH          # 1000
SEQ_OVERLAP = PolishImageOptions.SEQ_OVERLAP        # 50
TRAIN_WINDOW = 100
WINDOW_JUMP = 50
STARTS = tuple(range(0, SEQ_LENGTH - TRAIN_WINDOW + 1, WINDOW_JUMP))
# window i covers [50i, 50i+100): the half-window overlap-add applies
HALF_WINDOWS = (TRAIN_WINDOW == 2 * WINDOW_JUMP
                and (len(STARTS) + 1) * WINDOW_JUMP == SEQ_LENGTH)


def _overlap_add(probs):
    """probs: (n_windows, TRAIN_WINDOW, B, C) -> votes (B, SEQ_LENGTH, C):
    segment j of 50 = window j's first half + window j-1's second half."""
    n, _, B, C = probs.shape
    half = WINDOW_JUMP
    zeros = torch.zeros((1, half, B, C), dtype=torch.float32,
                        device=probs.device)
    segments = (torch.cat([probs[:, :half], zeros], dim=0)
                + torch.cat([zeros, probs[:, half:]], dim=0))
    return segments.reshape(SEQ_LENGTH, B, C).transpose(0, 1)


def _labels_and_phred(votes):
    """votes (B, SEQ_LENGTH, C) -> (votes, labels int32, phred float32)."""
    B = votes.shape[0]
    base_values = votes.max(dim=2).values
    labels = votes.argmax(dim=2).to(torch.int32)
    counts = torch.ones((B, SEQ_LENGTH - 2 * SEQ_OVERLAP),
                        dtype=torch.float32, device=votes.device)
    counts = torch.nn.functional.pad(counts, (SEQ_OVERLAP, SEQ_OVERLAP)) + 1.0
    fraction = base_values / counts
    phred = -10.0 * torch.log10(torch.clamp_min(1.0 - fraction, 1e-30))
    phred = torch.where(fraction >= 1.0, torch.full_like(phred, 100.0),
                        phred)
    return votes, labels, phred


def _windows_tm(images):
    """The overlapping windows of images (B, SEQ_LENGTH, F), time-major
    (TRAIN_WINDOW, B, F) each."""
    return [images[:, s:s + TRAIN_WINDOW].transpose(0, 1).contiguous()
            for s in STARTS]


@torch.inference_mode()
def consensus_scan(params, images, num_classes=5):
    """images: (B, SEQ_LENGTH, F) float tensor; params: the polish tree as
    tensors on its device.  Returns (votes (B, SEQ_LENGTH, C) float32,
    labels (B, SEQ_LENGTH) int32, phred (B, SEQ_LENGTH) float32)."""
    B = images.shape[0]
    hidden = torch.zeros((B, 2, 128), dtype=images.dtype,
                         device=images.device)
    if use_fused_gru(images.device) and HALF_WINDOWS:
        probs = []
        for window in _windows_tm(images):
            logits, hidden = polish_forward_fused(params, window, hidden)
            probs.append(torch.softmax(logits.float(), dim=2))
        return _labels_and_phred(_overlap_add(torch.stack(probs)))

    votes = torch.zeros((B, SEQ_LENGTH, num_classes), dtype=torch.float32,
                        device=images.device)
    for s in STARTS:
        logits, hidden = polish_forward(
            params, images[:, s:s + TRAIN_WINDOW], hidden, allow_kernel=True)
        votes[:, s:s + TRAIN_WINDOW] += torch.softmax(logits.float(), dim=2)
    return _labels_and_phred(votes)


@torch.inference_mode()
def consensus_scan_static(q, images, num_classes=5):
    """Static-int8 consensus (models/quantize.py polish_forward_static):
    the same sliding windows and overlap-add as consensus_scan, logits
    from the int8 serving tree q (tensors on the images' device).
    images: (B, SEQ_LENGTH, F) float."""
    B = images.shape[0]
    hidden = torch.zeros((B, 2, 128), dtype=torch.float32,
                         device=images.device)
    assert HALF_WINDOWS
    probs = []
    for window in _windows_tm(images):
        logits, hidden = polish_forward_static(q, window, hidden,
                                               compute_dtype=window.dtype)
        probs.append(torch.softmax(logits, dim=2))
    return _labels_and_phred(_overlap_add(torch.stack(probs)))


def dry_consensus_labels(images: np.ndarray):
    """Deterministic model-free backend (polish analog of the variant-mode
    --dry fixture): per-position dominant observation from the image itself.
    Channels (summary.get_feature_index): rev A..T -> 0..3, fwd A..T ->
    4..7, gap rev/fwd -> 8/9.  Label 1..4 = ACGT, 0 = gap."""
    images = images.astype(np.float32)
    base_votes = images[..., 0:4] + images[..., 4:8]        # (N, L, 4)
    gap_votes = images[..., 8] + images[..., 9]             # (N, L)
    best_base = np.argmax(base_votes, axis=-1)              # 0..3
    best_votes = np.max(base_votes, axis=-1)
    labels = np.where(gap_votes > best_votes, 0, best_base + 1)
    # all-zero columns (padding) decode to 0
    labels = np.where((base_votes.sum(-1) + gap_votes) == 0, 0, labels)
    phred = np.full(labels.shape, 60.0, np.float32)
    return labels.astype(np.int32), phred


_tree_cache: dict = {}


def _device_tree_cached(params, device, quantize_mode):
    """Memo of the serving tree on each device, keyed on (device, mode) and
    the host params' identity, so per-file predict calls reuse one tree a
    device and devices do not evict each other: the float tree, or the
    static-int8 one for quantize_mode="static", its int8 weights relaid
    once a device for the kernels (polish_prepare_static).  A new params
    tree replaces the device's entry, so reloads do not accumulate."""
    key = (str(device), quantize_mode)
    hit = _tree_cache.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    if quantize_mode == "static":
        tree = polish_prepare_static(params_from_jax(
            polish_quantize_params_static(params), device))
    else:
        tree = params_from_jax(params, device)
    _tree_cache[key] = (params, tree)
    return tree


def consensus_predict(params, images: np.ndarray, batch_size: int = 512,
                      compute_dtype=torch.float32,
                      quantize_mode: str | None = None, device=None,
                      devices=None):
    """Batched host wrapper: (N, 1000, 10) uint8 images -> (labels, phred)
    numpy arrays, on `device` (cuda unless given).  The final batch pads
    to a power-of-two bucket between 32 and batch_size.

    devices: a list to run data parallel over (the JAX package's mesh, the
    fan-out of predict_distributed_gpu.py:39-70): the batch and each bucket
    round up to the device count, each padded batch splits into contiguous
    row blocks, one a device, and every block is enqueued before any is
    read back.  The hidden carry is per chunk, so the labels and phred
    equal one device's.

    params: the float polish tree (numpy arrays as load_params gives them,
    or tensors).  quantize_mode="static" serves through the exact-1/127
    int8 tree (consensus_scan_static).

    While a torch.profiler session is active the call is a span
    `consensus.predict` (utils/profiling.py), and each batch's phases its
    children: `consensus.pad`, `.upload`, `.enqueue` (scan_fn) and
    `.fetch`; the padded rows count always."""
    devices = [resolve_device(d) for d in (devices or [device])]
    n = len(images)
    if n == 0:
        return (np.zeros((0, SEQ_LENGTH), np.int32),
                np.zeros((0, SEQ_LENGTH), np.float32))
    scan_fn = consensus_scan
    if quantize_mode == "static":
        scan_fn = consensus_scan_static
    elif quantize_mode not in (None, "", "none", "off"):
        raise ValueError(
            f"unsupported polish quantize_mode: {quantize_mode!r}")
    trees = [_device_tree_cached(params, d,
                                 "static" if scan_fn is consensus_scan_static
                                 else None) for d in devices]
    n_devices = len(devices)
    batch_size = round_up(batch_size, n_devices)
    all_labels = np.zeros((n, SEQ_LENGTH), np.int32)
    all_phred = np.zeros((n, SEQ_LENGTH), np.float32)
    with profiling.span("consensus.predict"):
        for start in range(0, n, batch_size):
            chunk = images[start:start + batch_size]
            batch_id = profiling.new_batch()
            with profiling.span("consensus.pad", batch_id):
                bucket = 32
                while bucket < len(chunk):
                    bucket *= 2
                bucket = round_up(min(bucket, batch_size), n_devices)
                profiling.count_rows("consensus", len(chunk), bucket)
                padded = np.zeros((bucket, SEQ_LENGTH, images.shape[2]),
                                  np.float32)
                padded[:len(chunk)] = chunk
            per = bucket // n_devices
            blocks = []
            for i, (d, tree) in enumerate(zip(devices, trees)):
                rows = min(per, len(chunk) - i * per)
                if rows <= 0:       # padding only
                    break
                with profiling.span("consensus.upload", batch_id):
                    batch = torch.from_numpy(
                        padded[i * per:(i + 1) * per]).to(
                            device=d, dtype=compute_dtype)
                with profiling.span("consensus.enqueue", batch_id):
                    _, labels, phred = scan_fn(tree, batch)
                blocks.append((labels[:rows], phred[:rows]))
            row = start
            for labels, phred in blocks:
                with profiling.span("consensus.fetch", batch_id):
                    all_labels[row:row + len(labels)] = labels.cpu().numpy()
                    all_phred[row:row + len(phred)] = phred.cpu().numpy()
                row += len(labels)
    return all_labels, all_phred
