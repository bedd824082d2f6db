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


def pop_device_arg(argv):
    """The positional arguments of a script's argv without `--device X`,
    and X (None when absent: cuda)."""
    argv = list(argv)
    if "--device" not in argv:
        return argv, None
    at = argv.index("--device")
    if at + 1 >= len(argv):
        raise SystemExit("--device takes a torch device (cuda, cpu)")
    device = argv[at + 1]
    del argv[at:at + 2]
    return argv, device
