"""The one general generator: weights and inputs from the run's seed.

Weights: every leaf a configuration's reference module lists
(`param_shapes`), drawn uniform in (-scale, scale) in one call on the
device from a torch.Generator seeded with the run's seed, float32 as a
checkpoint holds them.  The program and the reference are both handed a
tree made by this function; the reference draws its own again.

Inputs: a pool of distinct batches, drawn on the host with numpy from the
seed, by the value kind the configuration's `input` names.  The traffic
mix says how many rows a batch holds and how many batches the pool holds;
every seed gives batches of the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch


def _seed(seed: int, stream: int) -> int:
    """A 63-bit torch seed for one stream of a run seed."""
    mixed = np.random.SeedSequence([seed % (1 << 64), stream])
    return int(mixed.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(shapes: dict, seed: int, device) -> dict:
    """shapes: {"a.b": (shape, scale)} in order -> the nested tree of
    float32 tensors on `device`, drawn in one call."""
    sizes = [int(np.prod(shape)) for shape, _ in shapes.values()]
    scales = torch.tensor([scale for _, scale in shapes.values()],
                          dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(_seed(seed, 0))
    flat = torch.rand(sum(sizes), generator=generator, device=device,
                      dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0).mul_(torch.repeat_interleave(
        scales, torch.tensor(sizes, device=device)))
    tree: dict = {}
    offset = 0
    for (path, (shape, _)), size in zip(shapes.items(), sizes):
        *groups, leaf = path.split(".")
        node = tree
        for group in groups:
            node = node.setdefault(group, {})
        node[leaf] = flat[offset:offset + size].view(*shape)
        offset += size
    return tree


def _column_fractions(rng, size, spec):
    """Polish pileup columns (polish/summary.py: count / coverage * total,
    truncated to uint8): channels 0-3 reverse A-T, 4-7 forward A-T, 8/9
    gap reverse/forward.  A column's dominant base (or gap) takes most of
    `total`, split between the strands; an error share goes to one other
    channel."""
    *lead, features = size
    assert features == 10
    total = float(spec["total"])
    base = rng.integers(0, 5, size=lead)
    strand = rng.uniform(0.3, 0.7, size=lead)
    error = rng.uniform(0.0, 0.3, size=lead)
    other = rng.integers(0, 10, size=lead)
    rev = np.where(base == 4, 8, base)
    fwd = np.where(base == 4, 9, base + 4)
    image = np.zeros(size, np.float32)
    main = total * (1.0 - error)
    np.put_along_axis(image, rev[..., None], (main * strand)[..., None], -1)
    np.put_along_axis(image, fwd[..., None],
                      (main * (1.0 - strand))[..., None], -1)
    noise = np.take_along_axis(image, other[..., None], -1) + (
        total * error)[..., None]
    np.put_along_axis(image, other[..., None], noise, -1)
    return np.minimum(image, 255.0).astype(np.dtype(spec["dtype"]))


def _pileup_counts(rng, size, spec):
    """Variant-caller windows (ops/pileup_ref.py's layout, counts clamped
    to +-125 as int8): channel 0 the reference base's value 1-4; 4 and 15
    the forward and reverse coverage; 8-13 and 19-24 the forward and
    reverse counts of A, C, G, T, insert, delete.  A window's depth is
    drawn between `depth_low` and `depth_high` and split between the
    strands; each column's reads match its reference base but for an
    error share on one other channel; in the middle column a drawn
    fraction of them carries the candidate allele instead, its support on
    5 and 16.  Every other channel is 0, as in a pileup."""
    *lead, T, features = size
    assert features == 26
    depth = rng.integers(spec["depth_low"], spec["depth_high"] + 1,
                         size=(*lead, 1))
    depth = np.maximum(depth + rng.integers(-3, 4, size=(*lead, T)), 1)
    fwd = np.rint(depth * rng.uniform(0.3, 0.7, size=(*lead, 1)))
    rev = depth - fwd
    base = rng.integers(0, 4, size=(*lead, T))
    error = rng.uniform(0.0, 0.15, size=(*lead, T))
    other = (base + rng.integers(1, 6, size=(*lead, T))) % 6
    mid = T // 2
    fraction = rng.uniform(0.15, 1.0, size=lead)
    alt = (base[..., mid] + rng.integers(1, 6, size=lead)) % 6
    onehot = np.eye(6, dtype=np.float32)
    matched = onehot[base] * (1.0 - error)[..., None] \
        + onehot[other] * error[..., None]
    matched[..., mid, :] += (onehot[alt] - onehot[base[..., mid]]) * (
        fraction * (1.0 - error[..., mid]))[..., None]
    image = np.zeros(size, np.dtype(spec["dtype"]))
    image[..., 0] = base + 1
    for start, coverage, support, reads in ((8, 4, 5, fwd),
                                            (19, 15, 16, rev)):
        image[..., coverage] = np.minimum(reads, 125)
        counts = np.minimum(np.rint(matched * reads[..., None]), 125)
        image[..., start:start + 6] = counts
        image[..., mid, support] = np.take_along_axis(
            counts[..., mid, :], alt[..., None], -1)[..., 0]
    return image


VALUE_KINDS = {"column_fractions": _column_fractions,
               "pileup_counts": _pileup_counts}


def make_pool(config: dict, rows: int, pool: int, item_shape, seed: int):
    """(pool, rows, *item_shape) input batches of the config's value kind,
    drawn on the host from the seed."""
    spec = config["input"]
    rng = np.random.default_rng([seed % (1 << 64), 1])
    return VALUE_KINDS[spec["values"]](rng, (pool, rows, *item_shape), spec)


def sample_flags(seed: int, every: int, n: int = 1 << 20) -> np.ndarray:
    """Which batch indices a run keeps for the comparison: about one in
    `every`, drawn from the seed."""
    rng = np.random.default_rng([seed % (1 << 64), 2])
    return rng.integers(0, every, size=n) == 0
