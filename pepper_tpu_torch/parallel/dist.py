"""Multi-process region-sharded execution, the port of the JAX package's
parallel/dist.py with torch.distributed in the place of jax.distributed.

The reference's parallelism is process-pool + HDF5 files with silently
dropped shards on worker death (ImageGenerationUI.py:330-339 logs and
continues).  Here shard completion is explicit: a region manifest records
every interval, processes claim intervals deterministically (interval i
belongs to rank i mod world — no coordination needed), and done-markers
make resume exact.

The process group uses the gloo backend: the sharded paths gather host
arrays and files only, no device tensor crosses processes, and gloo also
serves several ranks on one GPU (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join the process group, from explicit arguments (coordinator
    "host:port", world size, rank) or from torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT environment; a no-op for one process.
    Returns (rank, world)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if coordinator_address is not None:
            if int(num_processes) > 1:
                dist.init_process_group(
                    "gloo", init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group("gloo", init_method="env://")
    return process_index(), process_count()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_intervals(intervals, process_index: int, process_count: int):
    """Deterministic round-robin interval assignment (the reference's
    `i % threads == pid` scheme, ImageGenerationUI.py:211, lifted to
    hosts)."""
    return [interval for i, interval in enumerate(intervals)
            if i % process_count == process_index]


@dataclass
class RegionManifest:
    """JSON manifest of work intervals + done-markers for exact resume."""

    directory: str

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, "region_manifest.json")

    def _marker(self, interval) -> str:
        contig, start, end = interval
        return os.path.join(self.directory, "done",
                            f"{contig}_{start}_{end}.done")

    def write(self, intervals) -> None:
        os.makedirs(os.path.join(self.directory, "done"), exist_ok=True)
        with open(self.manifest_path, "w") as f:
            json.dump({"intervals": [list(i) for i in intervals]}, f)

    def read(self):
        with open(self.manifest_path) as f:
            return [tuple(i) for i in json.load(f)["intervals"]]

    def mark_done(self, interval) -> None:
        with open(self._marker(interval), "w") as f:
            f.write("done\n")

    def is_done(self, interval) -> bool:
        return os.path.exists(self._marker(interval))

    def pending(self):
        return [interval for interval in self.read()
                if not self.is_done(interval)]

    def completed(self):
        return [interval for interval in self.read()
                if self.is_done(interval)]


def all_gather_rows(local_array):
    """All-gather a (n_i, d) array across the processes' host memory;
    returns the concatenation in rank order on every process.  With one
    process it is the identity."""
    local_array = np.asarray(local_array)
    if process_count() == 1:
        return local_array
    import torch
    import torch.distributed as dist

    rows = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count())]
    dist.all_gather(rows, torch.tensor([len(local_array)]))
    rows = [int(r) for r in rows]
    padded = np.zeros((max(rows),) + local_array.shape[1:],
                      local_array.dtype)
    padded[:len(local_array)] = local_array
    parts = [torch.zeros_like(torch.from_numpy(padded))
             for _ in rows]
    dist.all_gather(parts, torch.from_numpy(padded))
    return np.concatenate([part.numpy()[:n] for part, n in zip(parts, rows)])


def barrier(name: str = "pepper") -> None:
    """Wait for every process; `name` says which step, for the reader."""
    if process_count() == 1:
        return
    import torch.distributed as dist

    dist.barrier()


def all_reduce_sum(arrays):
    """Sum a list of host arrays over the processes (one gloo all-reduce
    of a float64 buffer); each comes back in its own dtype and shape.  With
    one process it returns its input."""
    arrays = [np.asarray(array) for array in arrays]
    if process_count() == 1:
        return arrays
    import torch
    import torch.distributed as dist

    flat = torch.from_numpy(np.concatenate(
        [array.astype(np.float64).ravel() for array in arrays]))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, offset = [], 0
    for array in arrays:
        part = flat[offset:offset + array.size].numpy()
        out.append(part.reshape(array.shape).astype(array.dtype))
        offset += array.size
    return out
