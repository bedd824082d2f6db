"""Which torch device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: cuda unless the caller
    asks for another.  Raises when CUDA is asked for (or defaulted to) and
    missing; the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return device
