"""The pileup histogram: (row, col, ±1) events summed into the region image,
as a hand-written CUDA kernel for Hopper and its plain PyTorch twin.

The pileup walk emits millions of scatter-accumulate events per region
(region_summary.cpp populate_summary_matrix).  The kernel takes them as
they come, three flat int32 arrays in any order, and adds each into an
int32 (n_rows, n_cols) image; an event outside the image adds nothing.

  pileup_histogram_events     tensor level, the kernel: the counterpart of
                              the TPU kernel body _histogram_kernel
                              (reached through pepper_tpu/ops/
                              pileup_kernel.py::accumulate_pallas and
                              device_windows.py::_fused_events_classify);
                              counts `launches`
  pileup_histogram_events_reference
                              its plain twin: a mask, then one index_add_
  pileup_histogram            the same sum over the TPU kernel's input, the
                              host binning of _bin_events (events sorted by
                              row into TILE_R-row tiles, each padded to a
                              common capacity of whole CHUNK_E chunks with
                              the sentinel rel_row = -1), into the padded
                              (n_tiles * TILE_R, COL_PAD) image; on the card
                              it turns the slabs into flat events and runs
                              pileup_histogram_events
  pileup_histogram_reference  its plain twin
  accumulate_numpy / accumulate_torch / accumulate_cuda
                              host level, the counterparts of the JAX
                              package's accumulate_numpy / accumulate_jax /
                              accumulate_pallas: numpy events in, an int64
                              numpy (rows, cols) image out, so each can serve
                              as a RegionalSummary matrix_backend

On a CUDA tensor pileup_histogram_events launches the kernel, built from
csrc/pileup_histogram.cu with nvcc for sm_90a at first use and bound
through ctypes (ops/cuda_build.py); on a CPU tensor it runs the twin.
There is no fallback from one to the other: a failed build or launch
raises.  Sums are exact in int32 (the TPU kernel's f32 is exact below
2**24 and its wrapper casts to int anyway).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .cuda_build import check_contiguous, launch, ptr, require_cuda

TILE_R = 256
CHUNK_E = 2048
COL_PAD = 64  # feature columns padded to a lane-friendly width (26/48 -> 64)
_SUBCHUNKS = 8
_SUBCHUNK_E = CHUNK_E // _SUBCHUNKS  # 256: the TPU kernel's (8, 256) blocks

KERNELS = ("pileup_histogram_events",)
# the wrapper's library (ops/cuda_build.py), csrc/pileup_histogram.cu
LIBRARIES = {"pileup_histogram_events": "pileup_histogram"}


def accumulate_numpy(rows, cols, deltas, shape):
    out = np.zeros(shape, np.int64)
    np.add.at(out, (rows, cols), deltas)
    return out


def _bin_events(rows, cols, deltas, n_rows):
    """Sort events by row and bin into TILE_R tiles padded to a common
    capacity (multiple of CHUNK_E). Returns (rel_rows, cols, deltas) each
    shaped (n_tiles, capacity) with sentinel rel_row = -1, n_tiles and the
    capacity.  (The JAX package can round the capacity up to a power of two
    so that its dispatches share a compilation; here it is the fullest
    tile's.)  The TPU kernel's input layout, kept as the JAX package's byte
    for byte for the slab wrapper and its tests: no path of the port sorts
    or bins its events, since the kernel takes them unbinned."""
    n_tiles = max(1, -(-n_rows // TILE_R))
    order = np.argsort(rows, kind="stable")
    rows = rows[order]
    cols = cols[order]
    deltas = deltas[order]
    tile_of = rows // TILE_R
    counts = np.bincount(tile_of, minlength=n_tiles)
    capacity = max(CHUNK_E, int(-(-counts.max() // CHUNK_E) * CHUNK_E))

    rel = np.full((n_tiles, capacity), -1, np.int32)
    out_cols = np.zeros((n_tiles, capacity), np.int32)
    out_deltas = np.zeros((n_tiles, capacity), np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    # vectorized fill: event i goes to (tile_of[i], i - starts[tile_of[i]])
    slot = np.arange(len(rows)) - starts[tile_of]
    rel[tile_of, slot] = rows - tile_of * TILE_R
    out_cols[tile_of, slot] = cols
    out_deltas[tile_of, slot] = deltas
    return rel, out_cols, out_deltas, n_tiles, capacity


# ---------------------------------------------------------------------------
# tensor level: flat events


def _check_events(rows, cols, deltas, n_rows, n_cols):
    for name, t in (("rows", rows), ("cols", cols), ("deltas", deltas)):
        if t.dtype != torch.int32:
            raise TypeError(f"pileup_histogram_events takes int32 events, "
                            f"{name} is {t.dtype}")
        if t.dim() != 1 or t.numel() != rows.numel():
            raise ValueError("rows, cols and deltas must be 1-d and of one "
                             f"length, got {tuple(rows.shape)}, "
                             f"{tuple(cols.shape)}, {tuple(deltas.shape)}")
    if n_rows <= 0 or n_cols <= 0 or n_rows * n_cols >= 2 ** 31:
        raise ValueError(f"image ({n_rows}, {n_cols}) is empty or holds "
                         "2**31 entries or more")


def pileup_histogram_events_reference(rows, cols, deltas, n_rows, n_cols):
    """Plain twin of the kernel, same arguments: the events inside the
    image, then one index_add_ into a zeroed int32 image."""
    _check_events(rows, cols, deltas, n_rows, n_cols)
    rows, cols = rows.long(), cols.long()
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    out = torch.zeros(n_rows * n_cols, dtype=torch.int32, device=rows.device)
    out.index_add_(0, (rows * n_cols + cols)[keep], deltas[keep])
    return out.reshape(n_rows, n_cols)


def pileup_histogram_events(rows, cols, deltas, n_rows, n_cols):
    """The histogram of a flat event list.

    rows, cols, deltas: 1-d int32 tensors of N events, in any order.
    Returns the int32 (n_rows, n_cols) image: image[row, col] is the sum of
    the deltas of the events at (row, col); events outside it add
    nothing."""
    if rows.device.type == "cpu":
        return pileup_histogram_events_reference(rows, cols, deltas, n_rows,
                                                 n_cols)
    require_cuda(rows, "pileup_histogram_events")
    _check_events(rows, cols, deltas, n_rows, n_cols)
    check_contiguous((rows, cols, deltas), rows.device,
                     "pileup_histogram_events")
    out = torch.zeros((n_rows, n_cols), dtype=torch.int32,
                      device=rows.device)
    if rows.numel() == 0:
        return out
    launch(LIBRARIES["pileup_histogram_events"], rows.device, ptr(rows),
           ptr(cols), ptr(deltas), rows.numel(), ptr(out), n_rows, n_cols)
    pileup_histogram_events.launches += 1
    return out


pileup_histogram_events.launches = 0


# ---------------------------------------------------------------------------
# tensor level: the TPU kernel's binned slabs


def _check_slabs(rel, cols, deltas, n_tiles, n_chunks):
    slots = n_tiles * n_chunks * CHUNK_E
    for name, t in (("rel", rel), ("cols", cols), ("deltas", deltas)):
        if t.dtype != torch.int32:
            raise TypeError(f"pileup_histogram takes int32 slabs, {name} is "
                            f"{t.dtype}")
        if t.numel() != slots:
            raise ValueError(f"{name} holds {t.numel()} slots, not n_tiles "
                             f"* n_chunks * CHUNK_E = {slots}")


def pileup_histogram_reference(rel, cols, deltas, n_tiles, n_chunks):
    """Plain twin of the slab histogram, same arguments: every slot whose
    rel_row lies in [0, TILE_R) and whose col lies in [0, COL_PAD) adds its
    delta at (tile * TILE_R + rel_row, col); other slots (the -1 sentinel)
    contribute nothing, as in the TPU kernel's one-hot products."""
    _check_slabs(rel, cols, deltas, n_tiles, n_chunks)
    rel = rel.reshape(n_tiles, -1).long()
    cols = cols.reshape(n_tiles, -1).long()
    tiles = torch.arange(n_tiles, device=rel.device)[:, None]
    keep = (rel >= 0) & (rel < TILE_R) & (cols >= 0) & (cols < COL_PAD)
    flat = ((tiles * TILE_R + rel) * COL_PAD + cols)[keep]
    out = torch.zeros(n_tiles * TILE_R * COL_PAD, dtype=torch.int32,
                      device=rel.device)
    out.index_add_(0, flat, deltas.reshape(n_tiles, -1)[keep])
    return out.reshape(n_tiles * TILE_R, COL_PAD)


def pileup_histogram(rel, cols, deltas, n_tiles, n_chunks):
    """The histogram of binned event slabs, the TPU kernel's input.

    rel, cols, deltas: int32 tensors of n_tiles * n_chunks * CHUNK_E
    slots, tile-major (the (n_tiles, capacity) arrays of _bin_events, or
    the TPU kernel's (n_tiles * n_chunks, 8, 256) blocks of them).  Returns
    the int32 (n_tiles * TILE_R, COL_PAD) image.  On the card the slots
    become flat events, row tile * TILE_R + rel_row (-1 where rel_row lies
    outside [0, TILE_R)), for pileup_histogram_events."""
    if rel.device.type == "cpu":
        return pileup_histogram_reference(rel, cols, deltas, n_tiles,
                                          n_chunks)
    require_cuda(rel, "pileup_histogram")
    _check_slabs(rel, cols, deltas, n_tiles, n_chunks)
    return pileup_histogram_events(*slab_events(rel, cols, deltas, n_tiles),
                                   n_tiles * TILE_R, COL_PAD)


def slab_events(rel, cols, deltas, n_tiles):
    """The slots of binned slabs as flat events of the padded image: row
    tile * TILE_R + rel_row, or -1 (outside any image) where rel_row lies
    outside [0, TILE_R), as the sentinel does."""
    rel = rel.reshape(n_tiles, -1)
    tiles = torch.arange(n_tiles, dtype=torch.int32,
                         device=rel.device)[:, None] * TILE_R
    rows = torch.where((rel >= 0) & (rel < TILE_R), tiles + rel, -1)
    return rows.reshape(-1), cols.reshape(-1), deltas.reshape(-1)


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`; to a card through pinned
    memory, asynchronously on the current stream."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# host level: RegionalSummary matrix backends


def accumulate_torch(rows, cols, deltas, shape, device=None):
    """The scatter in plain PyTorch (the JAX package's accumulate_jax):
    one index_put_ with accumulate=True on an int64 image on `device`
    (cuda unless the caller asks for another)."""
    device = resolve_device(device)
    if len(rows) == 0:
        return np.zeros(shape, np.int64)
    out = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    out.index_put_((torch.as_tensor(np.asarray(rows, np.int64),
                                    device=device),
                    torch.as_tensor(np.asarray(cols, np.int64),
                                    device=device)),
                   torch.as_tensor(np.asarray(deltas, np.int64),
                                   device=device), accumulate=True)
    return out.cpu().numpy()


def accumulate_cuda(rows, cols, deltas, shape, device=None):
    """The histogram kernel as a matrix backend, the counterpart of the
    JAX package's accumulate_pallas: uploads the events as they are and
    sums them with pileup_histogram_events on `device` (cuda unless the
    caller asks for another; on the CPU the twin runs).  Returns the int64
    numpy image of `shape`."""
    device = resolve_device(device)
    n_rows, n_cols = shape
    if len(rows) == 0:
        return np.zeros(shape, np.int64)
    image = pileup_histogram_events(
        *(upload(np.asarray(a, np.int32), device)
          for a in (rows, cols, deltas)), n_rows, n_cols)
    return image.cpu().numpy().astype(np.int64)


BACKENDS = {
    "numpy": accumulate_numpy,
    "torch": accumulate_torch,
    "cuda": accumulate_cuda,
}


def get_backend(name: str):
    return BACKENDS[name]
