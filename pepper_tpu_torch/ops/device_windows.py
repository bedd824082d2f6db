"""Device-side candidate-window extraction, feature injection and the two
fused region flows (the JAX package's ops/device_windows.py).

The region image goes to the device once; windows are gathered there
around each candidate's expanded row and the per-candidate type-specific
features (region_summary.cpp:848-904: type/length columns, fwd/rev
support, sign flips, delete-span fill) are injected with masks, then the
windows go straight to the classifier.  Host-side prep is a dozen scalars
per candidate (CandidateDescriptors).

  classify_regions_images  host-native int8 region images -> gather and
                           inject -> classifier (--device_pileup)
  classify_regions_events  raw (row, col, ±1) pileup events, shifted into
                           the strided layout and uploaded as they are ->
                           the histogram kernel (ops/pileup_kernel.py) ->
                           reference channel, clamp, gather and inject ->
                           classifier
  classify_region_device   the one-region form of the event flow

Each runs on `device`, cuda unless the caller asks for another; the
classifier is the port's transducer_infer, which casts every parameter and
the windows to compute_dtype (the JAX flows' tree_map(astype)), so on a
card it launches the LSTM kernels.  Packages and descriptors stay numpy (they cross the fork
pool); tensors exist only inside these functions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.params import params_from_jax
from ..models.transducer import transducer_infer
from ..options import ImageOptions
from . import pileup_kernel
from .pileup_kernel import upload

MAX_COLOR = ImageOptions.MAX_COLOR_VALUE
DESCRIPTOR_NAMES = ("base_index", "type_digit", "type_value", "depth_fwd",
                    "depth_rev", "flip_fwd_col", "flip_rev_col",
                    "star_fwd_col", "star_rev_col", "del_len")


@dataclass
class CandidateDescriptors:
    """Per-candidate injection scalars, all (K,) int32."""

    base_index: np.ndarray      # expanded row of the candidate
    type_digit: np.ndarray      # 1 snp / 2 insert / 3 delete
    type_value: np.ndarray      # col1 alt value (snp) or len-1 (indel)
    depth_fwd: np.ndarray       # clamped fwd support
    depth_rev: np.ndarray
    flip_fwd_col: np.ndarray    # supporting-observation column to sign-flip
    flip_rev_col: np.ndarray
    star_fwd_col: np.ndarray    # '*' columns for the delete span fill
    star_rev_col: np.ndarray
    del_len: np.ndarray         # candidate length - 1 (0 for snp)


@dataclass
class RegionPackage:
    """One region's fused-flow payload: window metadata (image=None) plus
    the native int8 region image and injection descriptors.  Produced by
    the summarizer under --device_pileup, consumed by
    infer.device_runner.DeviceRegionRunner."""

    windows: list
    image: np.ndarray
    region_rows: int
    descriptors: "CandidateDescriptors"


def descriptors_from_candidates(candidates, summary):
    """Build CandidateDescriptors from (position, candidate_string,
    allele_fwd, allele_rev) tuples + a RegionalSummary (for ref bases)."""
    from .pileup_ref import get_feature_index, get_reference_feature_value

    rows = {name: [] for name in DESCRIPTOR_NAMES}
    for position, candidate, fwd, rev in candidates:
        ref_base = summary.reference_sequence[position - summary.ref_start]
        type_digit = int(candidate[0])
        if type_digit == 1:
            type_value = get_reference_feature_value(candidate[1])
            flip_f = get_feature_index(ref_base, candidate[1], False)
            flip_r = get_feature_index(ref_base, candidate[1], True)
        elif type_digit == 2:
            type_value = min(len(candidate) - 1, MAX_COLOR)
            flip_f = get_feature_index(ref_base, "I", False)
            flip_r = get_feature_index(ref_base, "I", True)
        else:
            type_value = min(len(candidate) - 1, MAX_COLOR)
            flip_f = get_feature_index(ref_base, "D", False)
            flip_r = get_feature_index(ref_base, "D", True)
        rows["base_index"].append(summary._base_index(position))
        rows["type_digit"].append(type_digit)
        rows["type_value"].append(type_value)
        rows["depth_fwd"].append(min(fwd, MAX_COLOR))
        rows["depth_rev"].append(min(rev, MAX_COLOR))
        rows["flip_fwd_col"].append(flip_f)
        rows["flip_rev_col"].append(flip_r)
        rows["star_fwd_col"].append(get_feature_index(ref_base, "*", False))
        rows["star_rev_col"].append(get_feature_index(ref_base, "*", True))
        rows["del_len"].append(len(candidate) - 1 if type_digit == 3 else 0)
    return CandidateDescriptors(**{
        name: np.asarray(values, np.int32) for name, values in rows.items()
    })


def extract_windows_device(image, descriptors, window_size=32):
    """image: (R, F) int32 region matrix (already clamped); descriptors:
    the (K,) int32 tensors of descriptors_to_tree, on image's device.
    Returns (K, window_size+1, F) float32 candidate windows with the
    injections, equal to the host windows value for value."""
    R, F = image.shape
    half = window_size // 2
    W = window_size + 1
    device = image.device
    padded = torch.nn.functional.pad(image.to(torch.int32),
                                     (0, 0, half, half))

    def column(name):
        return descriptors[name].to(torch.int32)[:, None, None]

    # jax.lax.dynamic_slice clamps its start so that the slice fits
    start = descriptors["base_index"].long().clamp(0, max(0, R + 2 * half
                                                          - W))
    window = padded[start[:, None] + torch.arange(W, device=device)]
    rows = torch.arange(W, device=device)[None, :, None]
    cols = torch.arange(F, device=device)[None, None, :]
    mid = half
    type_digit = column("type_digit")
    type_value = column("type_value")
    depth_fwd = column("depth_fwd")
    depth_rev = column("depth_rev")

    is_mid = rows == mid
    # type column: 1 for snp, 2 insert, 3 delete; support columns by type
    type_col = torch.where(type_digit == 1, 1,
                           torch.where(type_digit == 2, 2, 3))
    fwd_col = torch.where(type_digit == 1, 5,
                          torch.where(type_digit == 2, 6, 7))
    rev_col = torch.where(type_digit == 1, 16,
                          torch.where(type_digit == 2, 17, 18))
    # the mid-row values go in before the sign flips, as on the host
    window = torch.where(is_mid & (cols == type_col), type_value, window)
    window = torch.where(is_mid & (cols == fwd_col), depth_fwd, window)
    window = torch.where(is_mid & (cols == rev_col), depth_rev, window)
    flip_mid = is_mid & ((cols == column("flip_fwd_col"))
                         | (cols == column("flip_rev_col")))
    window = torch.where(flip_mid, -window, window)

    # delete span fill (region_summary.cpp:895-904), after the mid row
    end_index = torch.clamp(mid + column("del_len") - 1, max=window_size - 1)
    in_span = (type_digit == 3) & (rows > mid) & (rows <= end_index)
    window = torch.where(in_span & (cols == 3), type_value, window)
    window = torch.where(in_span & (cols == 7), depth_fwd, window)
    window = torch.where(in_span & (cols == 18), depth_rev, window)
    span_flip = in_span & ((cols == column("star_fwd_col"))
                           | (cols == column("star_rev_col")))
    window = torch.where(span_flip, -window, window)
    # int8 wrap: the host pipeline casts the region image to int8 and
    # negates in int8, so -(-128) stays -128; the Python-style modulo of
    # torch.remainder wraps the int32 values the same way
    window = torch.remainder(window + 128, 256) - 128
    return window.to(torch.float32)


def descriptors_to_tree(descriptors: CandidateDescriptors,
                        device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(getattr(descriptors, name),
                                             np.int32), device=device)
            for name in DESCRIPTOR_NAMES}


# ---------------- fused region flows ----------------
#
# Both flows run over a strided layout: region r occupies rows
# [r*stride + HALF, r*stride + HALF + n_rows_r) of the concatenated image,
# so window gathers can never bleed across regions (the margins are zero,
# matching the host's zero padding at region edges).

HALF = 16  # candidate_window_size // 2


def _fused_images_classify(params, images, descriptors,
                           compute_dtype=torch.float32):
    windows = extract_windows_device(images.to(torch.int32), descriptors)
    return transducer_infer(params, windows, compute_dtype)


def _fused_events_classify(params, rows, cols, deltas, ref_col, clamp_mask,
                           descriptors, total_rows,
                           compute_dtype=torch.float32):
    """The event flow's device half: the histogram kernel on the flat
    events into the (total_rows, F) image, then the reference channel, the
    clamp of columns [CLAMP_COL_START, CLAMP_COL_END) on the rows of
    clamp_mask, the window gather and the classifier."""
    F = ImageOptions.IMAGE_HEIGHT
    image = pileup_kernel.pileup_histogram_events(rows, cols, deltas,
                                                  total_rows, F)
    image[:, 0] += ref_col
    cs, ce = ImageOptions.CLAMP_COL_START, ImageOptions.CLAMP_COL_END
    clamped = image[:, cs:ce].clamp(ImageOptions.MIN_COLOR_VALUE, MAX_COLOR)
    image[:, cs:ce] = torch.where(clamp_mask[:, None], clamped,
                                  image[:, cs:ce])
    windows = extract_windows_device(image, descriptors)
    return transducer_infer(params, windows, compute_dtype)


def pack_regions(region_sizes):
    """Strided offsets for a batch of regions: returns (stride, offsets)
    where region r's expanded row 0 lands at offsets[r] and windows stay
    inside [r*stride, (r+1)*stride).  The stride is rounded up to a
    multiple of 256, as in the JAX package."""
    region_rows_max = max(int(s) for s in region_sizes)
    stride = -(-(region_rows_max + 2 * HALF) // 256) * 256
    offsets = np.arange(len(region_sizes), dtype=np.int64) * stride + HALF
    return stride, offsets


def classify_regions_images(params, images, descriptor_list, region_sizes,
                            compute_dtype=torch.float32, device=None):
    """Fused image flow over a batch of regions.

    images: list of (n_rows_r, F) int8 host-native region images (already
    clamped + int8-cast by generate_summary); descriptor_list: one
    CandidateDescriptors per region (base_index region-local);
    region_sizes: rows per region.  Returns (K_total, 3) float32
    probabilities on `device`, in region-major window order."""
    device = resolve_device(device)
    stride, offsets = pack_regions(region_sizes)
    F = images[0].shape[1]
    stacked = np.zeros((len(images) * stride, F), np.int8)
    for r, image in enumerate(images):
        stacked[offsets[r]:offsets[r] + image.shape[0]] = image
    merged, k_total = _merge_descriptors(descriptor_list, offsets,
                                         device=device)
    return _fused_images_classify(
        params_from_jax(params, device), upload(stacked, device), merged,
        compute_dtype=compute_dtype)[:k_total]


def pack_events(event_list, ref_channels, region_sizes):
    """The event flow's host half: the events shifted into the strided
    layout and concatenated, in the order they came (no sort, no binning),
    the reference channel and the clamp mask.  Returns (rows, cols, deltas,
    ref_col, clamp_mask, total_rows, offsets), all numpy, the events
    int32."""
    stride, offsets = pack_regions(region_sizes)
    total_rows = len(event_list) * stride
    rows = np.concatenate([np.asarray(e[0], np.int32) + np.int32(offsets[r])
                           for r, e in enumerate(event_list)])
    cols = np.concatenate([np.asarray(e[1], np.int32)
                           for e in event_list])
    deltas = np.concatenate([np.asarray(e[2], np.int32)
                             for e in event_list])
    ref_col = np.zeros(total_rows, np.int32)
    clamp_mask = np.zeros(total_rows, bool)
    for r, channel in enumerate(ref_channels):
        ref_col[offsets[r]:offsets[r] + len(channel)] = channel
        # clamp covers expanded rows [0, region_size) = all but the stop row
        clamp_mask[offsets[r]:offsets[r] + int(region_sizes[r]) - 1] = True
    return rows, cols, deltas, ref_col, clamp_mask, total_rows, offsets


def classify_regions_events(params, event_list, ref_channels,
                            descriptor_list, region_sizes,
                            compute_dtype=torch.float32, device=None):
    """Fused event flow over a batch of regions: events are shifted into
    the strided layout on the host and uploaded as they are, and the
    histogram -> windows -> classifier chain runs on `device`.

    event_list: per region (rows, cols, deltas); ref_channels: per region
    expanded reference channel values; region_sizes: expanded rows per
    region (region_size + 1, i.e. including the stop row).  Returns
    (K_total, 3) float32 probabilities on `device`."""
    device = resolve_device(device)
    rows, cols, deltas, ref_col, clamp_mask, total_rows, offsets = \
        pack_events(event_list, ref_channels, region_sizes)
    merged, k_total = _merge_descriptors(descriptor_list, offsets,
                                         device=device)
    probs = _fused_events_classify(
        params_from_jax(params, device), upload(rows, device),
        upload(cols, device), upload(deltas, device),
        upload(ref_col, device), upload(clamp_mask, device), merged,
        total_rows=total_rows, compute_dtype=compute_dtype)
    return probs[:k_total]


def _merge_descriptors(descriptor_list, offsets, pad_to: int = 128,
                       device=None):
    """Concatenate per-region descriptors with base offsets applied;
    windows are padded to a multiple of `pad_to` (snp-shaped dummies), the
    JAX package's batch shape.  Returns (tensors on `device`, k_total)."""
    device = resolve_device(device)
    merged = {}
    k_total = sum(len(np.asarray(d.base_index)) for d in descriptor_list)
    k_padded = max(pad_to, -(-k_total // pad_to) * pad_to)
    for name in DESCRIPTOR_NAMES:
        parts = []
        for r, descriptors in enumerate(descriptor_list):
            values = np.asarray(getattr(descriptors, name), np.int32)
            if name == "base_index":
                values = values + np.int32(offsets[r])
            parts.append(values)
        column = np.zeros(k_padded, np.int32)
        if name == "type_digit":
            column[k_total:] = 1
        if parts:
            column[:k_total] = np.concatenate(parts)
        merged[name] = torch.as_tensor(column, device=device)
    return merged, k_total


def classify_region_device(params, rows, cols, deltas, ref_values,
                           descriptors: CandidateDescriptors,
                           region_rows: int, compute_dtype=torch.float32,
                           device=None):
    """The one-region event flow on `device`: classify_regions_events on a
    batch of one.  Returns (K, 3) float32 probabilities.

    rows/cols/deltas: pileup events; ref_values: (region_rows - 1,) col-0
    encoding; region_rows = region_size + 1."""
    return classify_regions_events(params, [(rows, cols, deltas)],
                                   [ref_values], [descriptors], [region_rows],
                                   compute_dtype=compute_dtype, device=device)
