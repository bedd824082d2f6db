"""Legacy HP sliding-window predictor: the r0.7-era `--use_hp_info`
inference flow (pepper_variant/modules/python/models/
predict_hp_distributed_cpu.py:30-120 and predict_hp_distributed_gpu.py),
the port of the JAX package's infer/hp_sliding.py.

Reference semantics: per 1000-column haplotype image pair, a GRU
transducer with explicit hidden carry is slid over windows of
TRAIN_WINDOW=100 with WINDOW_JUMP=50 (Options.py:83-90); each window's
softmax is scaled by x10000, truncated to int, zero-padded to the full
sequence length, and accumulated per haplotype
(predict_hp_distributed_cpu.py:54-95).  The integer-scaled accumulation
makes overlap votes exactly reproducible.

The window loop is a Python loop over models/polish_gru.py's
polish_forward with the hidden state carried: on a CUDA tensor with
allow_kernel that runs the fused GRU kernel, or the recurrence kernel
under PEPPER_GRU_FUSED=0 PEPPER_GRU_KERNEL=1 (ops/gru_kernel.py).  Adding
a window's votes into its slice of the accumulator is the zero-pad and
add, in int32.  The downstream consumer is decode/hp_legacy.py's
CandidateFinderHP.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.polish_gru import polish_forward
from ..parallel.mesh import replicate, split_rows

TRAIN_WINDOW = 100     # TrainOptions.TRAIN_WINDOW (Options.py:84)
WINDOW_JUMP = 50       # TrainOptions.WINDOW_JUMP (Options.py:85)
VOTE_SCALE = 10000     # predict_hp_distributed_cpu.py:88


@torch.inference_mode()
def hp_votes_scan(params, images, allow_kernel=True):
    """images: (B, L, F) float tensor, L a multiple of WINDOW_JUMP; params
    a polish tree of tensors on images' device.  Returns int32 (B, L, C)
    accumulated x10000 softmax votes, matching the reference's window loop
    (`for i in range(0, L, 50): if i+100 > L: break`) with hidden state
    carried across windows.  The hidden size is derived from the recurrent
    weights, so it can never desync from the params."""
    B, L, _ = images.shape
    C = params["output"]["w"].shape[1]
    hidden_size = params["encoder"]["w_hh_f"].shape[0]
    votes = torch.zeros((B, L, C), dtype=torch.int32, device=images.device)
    # a sequence shorter than one window: the reference loop breaks before
    # its first iteration, leaving all-zero votes
    hidden = torch.zeros((B, 2, hidden_size), dtype=images.dtype,
                         device=images.device)
    for start in range(0, L - TRAIN_WINDOW + 1, WINDOW_JUMP):
        window = images[:, start:start + TRAIN_WINDOW]
        logits, hidden = polish_forward(params, window, hidden,
                                        allow_kernel=allow_kernel)
        probs = torch.softmax(logits.float(), dim=2)
        # truncation toward zero, as torch's int() of the reference
        votes[:, start:start + TRAIN_WINDOW] += (
            probs * VOTE_SCALE).to(torch.int32)
    return votes


def predict_hp(params, images_hp1, images_hp2, allow_kernel=True,
               device=None, devices=None):
    """Both haplotype image stacks through the shared model (the reference
    runs one ONNX session for both, predict_hp_distributed_cpu.py:63-73).
    params: a polish tree (numpy arrays as load_params gives them, or
    tensors); images: (B, L, F) arrays.  Runs on `device` (cuda unless
    given), or data parallel over the list `devices` (the JAX package's
    mesh branch, the fan-out of predict_hp_distributed_gpu.py): each
    haplotype batch is padded to a multiple of the device count and split
    into contiguous row blocks, one a device, with the params replicated;
    exact, because the hidden carry is per sequence and the votes are
    integers.  Returns (votes_hp1, votes_hp2) int32 (B, L, C) numpy
    arrays."""
    devices = [resolve_device(d) for d in (devices or [device])]
    trees = replicate(params, devices)
    pending = []
    # every block of both haplotypes is enqueued before any is read back
    for images in (images_hp1, images_hp2):
        blocks, n = split_rows(images, len(devices))
        pending.append(([hp_votes_scan(tree, torch.as_tensor(block).to(d),
                                       allow_kernel=allow_kernel)
                         for block, d, tree in zip(blocks, devices, trees)],
                        n))
    return tuple(np.concatenate([v.cpu().numpy() for v in votes])[:n]
                 for votes, n in pending)
