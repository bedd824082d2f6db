"""The port's device-window flows on the CPU against the JAX package's, on
tests/test_device_windows.py's scenes with the same weights (H=32, through
params_from_jax).

Bars: descriptors, packing and window extraction are exact (integers; the
windows equal the host's value for value, int8 wrap included);
probabilities are held to atol 2e-4, the transducer bar of
tests/test_torch_transducer.py (the two frameworks sum in other orders;
JAX holds its own flows to its host path at 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.infer.device_runner import DeviceRegionRunner as JaxRunner
from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.ops import device_windows as jdw
from pepper_tpu.ops.device_windows import RegionPackage as JaxPackage
from pepper_tpu.ops.pileup_ref import RegionalSummary as JaxSummary
from pepper_tpu_torch.infer.device_runner import DeviceRegionRunner
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.models.transducer import (params_from_jax,
                                                transducer_infer)
from pepper_tpu_torch.ops import device_windows as dw
from pepper_tpu_torch.ops import pileup_kernel
from pepper_tpu_torch.ops.pileup_ref import (RegionalSummary,
                                             encode_reference_values)

from test_device_windows import _region_scene, build_scene
from test_pileup import REF, THRESHOLDS

ATOL = 2e-4
CPU = torch.device("cpu")


def _params(seed):
    return jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(seed), TransducerConfig(hidden=32,
                                                   linear_size=64)))


def _port_batch(tmp_path, name):
    return BamReader(str(tmp_path / name)).get_reads("chr1", 0, 39)


def _summaries(jax_batch, port_batch, backend=None):
    """The host summary of both packages on one scene: (jax, port)."""
    out = []
    for cls, batch in ((JaxSummary, jax_batch), (RegionalSummary,
                                                  port_batch)):
        summary = cls("chr1", 0, 39, REF, matrix_backend=backend)
        summary.generate_max_insert_summary(batch)
        summary.windows = summary.generate_summary(batch, **THRESHOLDS)
        out.append(summary)
    return out


def _events(batch):
    """The walker's event stream and the expanded reference channel."""
    recorder = RegionalSummary("chr1", 0, 39, REF, matrix_backend="unused")
    recorder.generate_max_insert_summary(batch)
    recorder.matrix_backend = lambda rows, cols, deltas, shape: (
        setattr(recorder, "_events", (rows, cols, deltas))
        or np.zeros(shape, np.int64))
    recorder.generate_summary(batch, **THRESHOLDS)
    values = np.asarray(encode_reference_values(REF))
    if recorder.total_observed_insert_bases:
        values = np.repeat(values, 1 + recorder.max_observed_insert[:40])
    return recorder._events, values


def _descriptor_arrays(descriptors):
    return {name: np.asarray(getattr(descriptors, name))
            for name in dw.DESCRIPTOR_NAMES}


def test_descriptors_from_candidates_equal_jax(tmp_path):
    jax_batch = build_scene(tmp_path)
    theirs, ours = _summaries(jax_batch, _port_batch(tmp_path, "fused.bam"))
    assert ours.descriptor_rows == theirs.descriptor_rows
    assert len(ours.descriptor_rows) >= 3        # snp + insert + delete
    a = _descriptor_arrays(dw.descriptors_from_candidates(
        ours.descriptor_rows, ours))
    b = _descriptor_arrays(jdw.descriptors_from_candidates(
        theirs.descriptor_rows, theirs))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype == np.int32
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("sizes", [[41], [41, 43, 300], [10001, 9000],
                                   [256 - 32, 257 - 32]])
def test_pack_regions_equals_jax(sizes):
    stride, offsets = dw.pack_regions(sizes)
    j_stride, j_offsets = jdw.pack_regions(sizes)
    assert stride == j_stride
    np.testing.assert_array_equal(offsets, j_offsets)


def _random_descriptors(rng, k, rows):
    return dw.CandidateDescriptors(**{
        name: rng.integers(0, rows if name == "base_index" else 30, k)
        .astype(np.int32) for name in dw.DESCRIPTOR_NAMES})


@pytest.mark.parametrize("counts", [[0], [3, 0, 5], [100, 40], [128], [129]])
def test_merge_descriptors_equals_jax(counts):
    rng = np.random.default_rng(sum(counts))
    descriptors = [_random_descriptors(rng, k, 40) for k in counts]
    offsets = dw.pack_regions([41] * len(counts))[1]
    ours, k_total = dw._merge_descriptors(descriptors, offsets, device=CPU)
    theirs, j_total = jdw._merge_descriptors(
        [jdw.CandidateDescriptors(**_descriptor_arrays(d))
         for d in descriptors], offsets)
    assert k_total == j_total == sum(counts)
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert ours[name].dtype == torch.int32
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(theirs[name]), err_msg=name)


def test_extract_windows_equal_host_and_jax(tmp_path):
    jax_batch = build_scene(tmp_path)
    _, host = _summaries(jax_batch, _port_batch(tmp_path, "fused.bam"))
    descriptors = dw.descriptors_from_candidates(host.descriptor_rows, host)
    image = host.image_int8.astype(np.int32)
    ours = dw.extract_windows_device(
        torch.from_numpy(image), dw.descriptors_to_tree(descriptors, CPU))
    theirs = np.asarray(jdw.extract_windows_device(
        jnp.asarray(image), jdw.descriptors_to_tree(
            jdw.CandidateDescriptors(**_descriptor_arrays(descriptors)))))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert len(host.windows) == len(ours)
    for window, got in zip(host.windows, ours.numpy()):
        np.testing.assert_array_equal(got.astype(np.int8), window.image,
                                      err_msg=str(window.candidates))


def test_extract_windows_edge_cases_equal_jax():
    """-128 wraps under both sign flips, long delete spans, and starts
    that dynamic_slice clamps (before the image and past its end)."""
    rng = np.random.default_rng(7)
    rows, k = 50, 64
    image = rng.integers(-128, 128, (rows, 26)).astype(np.int32)
    image[rng.random(image.shape) < 0.2] = -128
    arrays = {
        "base_index": np.concatenate([[0, 1, rows - 1, rows, rows + 20,
                                       rows + 100], rng.integers(
                                           0, rows, k - 6)]),
        "type_digit": rng.integers(1, 4, k),
        "type_value": rng.integers(0, 126, k),
        "depth_fwd": rng.integers(0, 126, k),
        "depth_rev": rng.integers(0, 126, k),
        "flip_fwd_col": rng.integers(8, 15, k),
        "flip_rev_col": rng.integers(19, 26, k),
        "star_fwd_col": np.full(k, 14),
        "star_rev_col": np.full(k, 25),
        "del_len": rng.integers(0, 40, k),
    }
    arrays = {name: a.astype(np.int32) for name, a in arrays.items()}
    ours = dw.extract_windows_device(
        torch.from_numpy(image),
        dw.descriptors_to_tree(dw.CandidateDescriptors(**arrays), CPU))
    theirs = np.asarray(jdw.extract_windows_device(
        jnp.asarray(image),
        jdw.descriptors_to_tree(jdw.CandidateDescriptors(**arrays))))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (theirs == -128).any() and ours.abs().max() <= 128


def test_classify_region_device_matches_jax(tmp_path):
    jax_batch = build_scene(tmp_path)
    port_batch = _port_batch(tmp_path, "fused.bam")
    theirs_summary, host = _summaries(jax_batch, port_batch)
    (rows, cols, deltas), ref_values = _events(port_batch)
    descriptors = dw.descriptors_from_candidates(host.descriptor_rows, host)
    params = _params(0)
    ours = dw.classify_region_device(params, rows, cols, deltas, ref_values,
                                     descriptors, 41, device="cpu")
    theirs = np.asarray(jdw.classify_region_device(
        params, rows, cols, deltas, encode_reference_values(REF),
        jdw.CandidateDescriptors(**_descriptor_arrays(descriptors)), 41))
    assert ours.shape == theirs.shape == (len(host.windows), 3)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL, rtol=0)
    host_probs = transducer_infer(
        params_from_jax(params, CPU),
        torch.from_numpy(np.stack([w.image for w in host.windows])))
    np.testing.assert_allclose(ours.numpy(), host_probs.numpy(), atol=1e-6,
                               rtol=0)


def _region_batch(tmp_path):
    """Three regions of different expanded sizes (tests/test_device_windows
    .py's scenes): per region the port's host summary and events."""
    regions = []
    for seed in (3, 4, 5):
        jax_batch = _region_scene(tmp_path, seed, f"r{seed}")
        port_batch = _port_batch(tmp_path, f"r{seed}.bam")
        _, host = _summaries(jax_batch, port_batch)
        events, ref_channel = _events(port_batch)
        regions.append(dict(host=host, events=events, ref=ref_channel,
                            descriptors=dw.descriptors_from_candidates(
                                host.descriptor_rows, host)))
    return regions


@pytest.mark.parametrize("flow", ["images", "events"])
def test_classify_regions_flows_match_jax(tmp_path, flow):
    regions = _region_batch(tmp_path)
    params = _params(1)
    sizes = [r["host"].region_rows for r in regions]
    descriptors = [r["descriptors"] for r in regions]
    jax_descriptors = [jdw.CandidateDescriptors(**_descriptor_arrays(d))
                       for d in descriptors]
    if flow == "images":
        images = [r["host"].image_int8 for r in regions]
        ours = dw.classify_regions_images(params, images, descriptors, sizes,
                                          device="cpu")
        theirs = jdw.classify_regions_images(params, images, jax_descriptors,
                                             sizes)
    else:
        events = [r["events"] for r in regions]
        refs = [r["ref"] for r in regions]
        ours = dw.classify_regions_events(params, events, refs, descriptors,
                                          sizes, device="cpu")
        theirs = jdw.classify_regions_events(params, events, refs,
                                             jax_descriptors, sizes)
    host_windows = [w for r in regions for w in r["host"].windows]
    assert ours.shape == (len(host_windows), 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL,
                               rtol=0)
    host_probs = transducer_infer(
        params_from_jax(params, CPU),
        torch.from_numpy(np.stack([w.image for w in host_windows])))
    np.testing.assert_allclose(ours.numpy(), host_probs.numpy(), atol=1e-6,
                               rtol=0)


def test_events_flow_launch_count_and_capacity(tmp_path):
    """On the CPU the flow runs the histogram's twin: no launch is
    counted.  pack_events hands the kernel every event once, unsorted and
    unpadded: the regions' events concatenated in order, rows shifted by
    each region's offset, int32, in an image of the regions' strides."""
    regions = _region_batch(tmp_path)
    events = [r["events"] for r in regions]
    sizes = [r["host"].region_rows for r in regions]
    rows, cols, deltas, ref_col, clamp_mask, total_rows, offsets = \
        dw.pack_events(events, [r["ref"] for r in regions], sizes)
    stride, expected_offsets = dw.pack_regions(sizes)
    np.testing.assert_array_equal(offsets, expected_offsets)
    assert total_rows == 3 * stride == 3 * dw.pack_regions([41, 41, 41])[0]
    for name, got, want in (
            ("rows", rows, [np.asarray(e[0], np.int64) + offsets[r]
                            for r, e in enumerate(events)]),
            ("cols", cols, [e[1] for e in events]),
            ("deltas", deltas, [e[2] for e in events])):
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.concatenate(want),
                                      err_msg=name)
    assert ref_col.shape == clamp_mask.shape == (total_rows,)
    before = pileup_kernel.pileup_histogram_events.launches
    dw.classify_regions_events(_params(1), events,
                               [r["ref"] for r in regions],
                               [r["descriptors"] for r in regions], sizes,
                               device="cpu")
    assert pileup_kernel.pileup_histogram_events.launches == before


def test_device_runner_matches_jax_runner(tmp_path):
    regions = _region_batch(tmp_path)
    params = _params(2)
    packages = [dw.RegionPackage(windows=r["host"].windows,
                                 image=r["host"].image_int8,
                                 region_rows=r["host"].region_rows,
                                 descriptors=r["descriptors"])
                for r in regions]
    ours = DeviceRegionRunner(params, region_batch=2,
                              device="cpu").predict(packages)
    theirs = JaxRunner(params, region_batch=2).predict([
        JaxPackage(windows=p.windows, image=p.image,
                   region_rows=p.region_rows,
                   descriptors=jdw.CandidateDescriptors(
                       **_descriptor_arrays(p.descriptors)))
        for p in packages])
    assert len(ours) == len(theirs) == sum(len(p.windows) for p in packages)
    for a, b in zip(ours, theirs):
        assert (a.contig, a.position, a.candidates) == \
            (b.contig, b.position, b.candidates)
        assert a.prediction_base.dtype == np.float64
        np.testing.assert_allclose(a.prediction_base, b.prediction_base,
                                   atol=ATOL, rtol=0)


def test_entry_points_without_device_raise_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    regions = _region_batch(tmp_path)[:1]
    params = _params(0)
    host = regions[0]["host"]
    calls = [
        lambda: DeviceRegionRunner(params),
        lambda: dw.classify_regions_images(
            params, [host.image_int8], [regions[0]["descriptors"]],
            [host.region_rows]),
        lambda: dw.classify_regions_events(
            params, [regions[0]["events"]], [regions[0]["ref"]],
            [regions[0]["descriptors"]], [host.region_rows]),
        lambda: dw.classify_region_device(
            params, *regions[0]["events"], regions[0]["ref"],
            regions[0]["descriptors"], host.region_rows),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
