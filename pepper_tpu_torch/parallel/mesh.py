"""Data parallelism over local torch devices, the port of the JAX
package's parallel/mesh.py.

The PEPPER workload is region-sharded data parallelism (the reference
fans its inference over every CUDA device, predict_distributed_gpu.py:
39-70, and its --callers_per_gpu files, RunInference.py:24-84).  Here one
process splits each padded batch into contiguous row blocks, one a device
in list order, with the parameters replicated on every device: where the
JAX package takes a `Mesh` with one `data` axis, these helpers take an
explicit list of torch devices.  The CLIs always build distinct
`cuda:i`; a list may name one device twice, which runs the same split,
replicas and gather on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.params import params_from_jax


def resolve_num_devices(num_devices: int | None, device) -> int:
    """Normalize a --num_devices request against the local device count of
    `device`'s type: -1/0/None = all local devices, N>0 = min(N, local).
    On the CPU the count is 1, as JAX on one CPU device gives."""
    device = torch.device(device)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    if num_devices is None or num_devices <= 0:
        return local
    return min(num_devices, local)


def local_devices(num_devices: int | None, device):
    """The first `resolve_num_devices(n, device)` local devices as
    `cuda:i`, or None when that resolves to one device (plain one-device
    dispatch on `device`)."""
    n = resolve_num_devices(num_devices, device)
    if n <= 1:
        return None
    return [torch.device("cuda", index) for index in range(n)]


def replicate(tree, devices) -> list:
    """One copy of a parameter tree (numpy arrays or tensors) on each
    device, in the list's order."""
    return [params_from_jax(tree, device) for device in devices]


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def split_rows(array, n_parts: int):
    """Pad axis 0 of a host array with zeros up to a multiple of n_parts
    and split it into n_parts contiguous, equal row blocks in order.
    Returns (the blocks, the unpadded row count)."""
    array = np.asarray(array)
    n = len(array)
    padded = round_up(n, n_parts)
    if padded != n:
        widths = [(0, padded - n)] + [(0, 0)] * (array.ndim - 1)
        array = np.pad(array, widths)
    return np.split(array, n_parts), n


def pad_to_multiple(array, multiple, axis=0):
    """Pad axis 0 up to a multiple (needed to shard uneven batches)."""
    n = array.shape[axis]
    remainder = n % multiple
    if remainder == 0:
        return array, n
    pad = multiple - remainder
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, pad)
    return np.pad(array, widths), n


def host_batch_rows(array, process_index: int, process_count: int):
    """This host's contiguous row-slice of a global batch whose length is a
    multiple of the global device count (and therefore of process_count,
    with equal devices per process — device order groups rows by
    process)."""
    per_host = len(array) // process_count
    return array[process_index * per_host:(process_index + 1) * per_host]


def make_global_batch(array, devices) -> list:
    """A process's rows of a padded global batch as one tensor a device:
    contiguous equal row blocks in the list's order (split_rows), the
    counterpart of the JAX package's batch-sharded global array.  The rows
    must already be a multiple of len(devices)."""
    blocks, n = split_rows(array, len(devices))
    if sum(len(block) for block in blocks) != n:
        raise ValueError(f"{n} rows do not split evenly over "
                         f"{len(devices)} devices")
    return [torch.from_numpy(np.ascontiguousarray(block)).to(device)
            for block, device in zip(blocks, devices)]
