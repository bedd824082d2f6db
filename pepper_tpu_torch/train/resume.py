"""Crash-safe training state (params + optimizer state + step counter),
the counterpart of the JAX package's train/orbax_io.py: one torch.save
file a step under `directory`/step_N, written to a temporary name and
renamed.  The portable .npz format (models/checkpoint.py) remains the
serving/interchange format."""

from __future__ import annotations

import os

import torch

from ..models.params import map_params


def save_train_state(directory: str, step: int, params, optimizer,
                     metadata: dict | None = None) -> str:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    state = {"params": map_params(lambda p: p.detach().cpu(), params),
             "optimizer": optimizer.state_dict(),
             "meta": metadata or {}}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_train_state(directory: str, step: int | None = None,
                        device="cpu"):
    """Returns (step, state) — state has params (tensors on `device`),
    optimizer (a state_dict for optimizer.load_state_dict) and meta."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    state = torch.load(path, map_location=device, weights_only=True)
    return step, state
