"""The port's pileup histogram on the CPU against the JAX package's: the host
binning byte for byte, the kernel's twin on flat events in any order (and
on the slabs' flat events) equal to JAX's numpy golden and Pallas kernel
(interpret mode off the TPU), every matrix backend (numpy golden, the
plain torch scatter, the kernel's twin) equal to JAX's numpy golden, XLA
scatter and Pallas kernel on the same events, and the event-stream windows
of RegionalSummary(matrix_backend=...) equal to the in-place walker's.
All comparisons are exact: the sums are integers."""

import functools

import numpy as np
import pytest
import torch

from pepper_tpu.io.bam_writer import BamRecord, write_bam
from pepper_tpu.ops import pileup_kernel as jpk
from pepper_tpu.ops.pileup_ref import RegionalSummary as JaxSummary
from pepper_tpu.io.bam import BamReader as JaxBamReader
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.ops import pileup_kernel as pk
from pepper_tpu_torch.ops.pileup_ref import RegionalSummary

from test_pileup import REF, THRESHOLDS, match_read
from test_pileup_kernel import random_events

CASES = [(10, 40), (5000, 300), (50000, 4096), (3, 1)]
CPU = {"device": "cpu"}


def _port_backends():
    return {"numpy": pk.accumulate_numpy,
            "torch": functools.partial(pk.accumulate_torch, **CPU),
            "cuda_twin": functools.partial(pk.accumulate_cuda, **CPU)}


def test_constants_match_jax():
    assert (pk.TILE_R, pk.CHUNK_E, pk.COL_PAD, pk._SUBCHUNKS,
            pk._SUBCHUNK_E) == (jpk.TILE_R, jpk.CHUNK_E, jpk.COL_PAD,
                                jpk._SUBCHUNKS, jpk._SUBCHUNK_E)
    assert pk.KERNELS == ("pileup_histogram_events",)
    assert set(pk.BACKENDS) == {"numpy", "torch", "cuda"}
    assert pk.get_backend("cuda") is pk.accumulate_cuda


@pytest.mark.parametrize("order", ["drawn", "reversed"])
@pytest.mark.parametrize("n_events,n_rows", CASES + [(70000, 600)])
def test_bin_events_equals_jax(n_events, n_rows, order):
    """Byte-equal slabs, in the events' order as drawn and reversed (the
    stable sort keeps the order of a row's events, and both must agree on
    it)."""
    rows, cols, deltas = random_events(n_events, n_rows, 26, seed=n_events)
    if order == "reversed":
        rows, cols, deltas = rows[::-1], cols[::-1], deltas[::-1]
    ours = pk._bin_events(rows, cols, deltas, n_rows + 1)
    theirs = jpk._bin_events(rows, cols, deltas, n_rows + 1)
    assert ours[3:] == theirs[3:]
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_events,n_rows", CASES)
def test_backends_equal_jax_backends(n_events, n_rows):
    rows, cols, deltas = random_events(n_events, n_rows, 26, seed=n_events)
    shape = (n_rows + 1, 26)
    golden = jpk.accumulate_numpy(rows, cols, deltas, shape)
    for name, theirs in (("jax", jpk.accumulate_jax),
                         ("pallas", jpk.accumulate_pallas)):
        np.testing.assert_array_equal(theirs(rows, cols, deltas, shape),
                                      golden, err_msg=name)
    for name, ours in _port_backends().items():
        out = ours(rows, cols, deltas, shape)
        assert out.dtype == np.int64 and out.shape == shape, name
        np.testing.assert_array_equal(out, golden, err_msg=name)


def test_empty_events():
    shape = (10, 26)
    empty = np.zeros(0, np.int32)
    before = pk.pileup_histogram_events.launches
    for name, fn in _port_backends().items():
        out = fn(empty, empty, empty, shape)
        assert out.shape == shape and out.dtype == np.int64, name
        assert not out.any(), name
    assert pk.pileup_histogram_events.launches == before


def _ordered(events, order):
    rows, cols, deltas = events
    if order == "row_sorted":
        idx = np.argsort(rows, kind="stable")
    elif order == "reversed":
        idx = np.arange(len(rows))[::-1]
    else:
        idx = np.arange(len(rows))
    return rows[idx], cols[idx], deltas[idx]


def _events_twin(rows, cols, deltas, shape):
    out = pk.pileup_histogram_events_reference(
        *(torch.from_numpy(np.ascontiguousarray(a, np.int32))
          for a in (rows, cols, deltas)), *shape)
    assert out.dtype == torch.int32 and tuple(out.shape) == shape
    return out.numpy()


@pytest.mark.parametrize("order", ["drawn", "row_sorted", "reversed"])
@pytest.mark.parametrize("n_events", [0, 1, 3, 4097])
def test_events_twin_equals_jax(n_events, order):
    """The flat-event twin in the order drawn, sorted by row and reversed
    equals JAX's numpy golden and its Pallas kernel (which bins them)."""
    n_rows = 300
    rows, cols, deltas = _ordered(
        random_events(n_events, n_rows, 26, seed=n_events + 11), order)
    shape = (n_rows, 26)
    ours = _events_twin(rows, cols, deltas, shape)
    np.testing.assert_array_equal(
        ours, jpk.accumulate_numpy(rows, cols, deltas, shape))
    np.testing.assert_array_equal(
        ours, jpk.accumulate_pallas(rows, cols, deltas, shape))


@pytest.mark.parametrize("order", ["drawn", "row_sorted"])
def test_events_outside_image_add_nothing(order):
    """Events with a row or column outside the image add nothing: against
    the numpy golden of the events inside it and, for the rows that JAX's
    binning takes (below the last tile's end), its Pallas kernel."""
    n_rows, shape = 300, (300, 26)
    inside = random_events(2000, n_rows, 26, seed=5)
    rng = np.random.RandomState(6)
    outside_cols = (rng.randint(0, 512, 300).astype(np.int32),
                    rng.choice([-7, -1, 26, 63, 64, 1000], 300)
                    .astype(np.int32),
                    rng.choice([-1, 1], 300).astype(np.int32))
    outside_rows = (rng.randint(n_rows, 512, 300).astype(np.int32),
                    rng.randint(0, 26, 300).astype(np.int32),
                    rng.choice([-1, 1], 300).astype(np.int32))
    admissible = _ordered(tuple(np.concatenate(p) for p in zip(
        inside, outside_cols, outside_rows)), order)
    golden = jpk.accumulate_numpy(*inside, shape)
    np.testing.assert_array_equal(_events_twin(*admissible, shape), golden)
    np.testing.assert_array_equal(jpk.accumulate_pallas(*admissible, shape),
                                  golden)
    far = (np.array([-1, -300, 2 ** 20, 2 ** 31 - 1], np.int32),
           np.array([0, 3, 5, 25], np.int32), np.ones(4, np.int32))
    everything = _ordered(tuple(np.concatenate(p) for p in zip(
        admissible, far)), order)
    np.testing.assert_array_equal(_events_twin(*everything, shape), golden)


def test_events_twin_rejects_bad_events():
    good = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        pk.pileup_histogram_events(good, good.long(), good, 3, 26)
    with pytest.raises(ValueError, match="one length"):
        pk.pileup_histogram_events(good, good[:3], good, 3, 26)
    with pytest.raises(ValueError, match="empty"):
        pk.pileup_histogram_events(good, good, good, 0, 26)


def _slab_case():
    """Binned slabs with a few slots the kernel must skip (rows and columns
    out of range), as the TPU kernel's (n_tiles * n_chunks, 8, 256)
    blocks, and the TPU kernel's full padded (n_tiles * 256, 64) output on
    them (interpret mode)."""
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    rows, cols, deltas = random_events(9000, 700, 64, seed=3)
    rel, bc, bd, n_tiles, capacity = jpk._bin_events(rows, cols, deltas, 701)
    n_chunks = capacity // jpk.CHUNK_E
    rel[0, -3:] = [-5, 256, 300]
    bc[1, :2] = [-1, 64]

    def to_blocks(a):
        return a.reshape(n_tiles * n_chunks, jpk._SUBCHUNKS, jpk._SUBCHUNK_E)

    spec = pl.BlockSpec((1, jpk._SUBCHUNKS, jpk._SUBCHUNK_E),
                        lambda t, k: (t * n_chunks + k, 0, 0))
    theirs = np.asarray(pl.pallas_call(
        jpk._histogram_kernel, grid=(n_tiles, n_chunks),
        in_specs=[spec, spec, spec],
        out_specs=pl.BlockSpec((jpk.TILE_R, jpk.COL_PAD), lambda t, k: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles * jpk.TILE_R, jpk.COL_PAD),
                                       jnp.float32),
        interpret=True)(to_blocks(rel), to_blocks(bc), to_blocks(bd)))
    slabs = [torch.from_numpy(to_blocks(a)) for a in (rel, bc, bd)]
    return slabs, n_tiles, n_chunks, theirs.astype(np.int32)


def test_twin_equals_pallas_kernel_on_slabs():
    """The tensor-level twin on the binned slabs equals the TPU kernel's
    full padded (n_tiles * 256, 64) output, sentinel slots, out-of-range
    rows and columns included."""
    slabs, n_tiles, n_chunks, theirs = _slab_case()
    ours = pk.pileup_histogram(*slabs, n_tiles, n_chunks)
    assert ours.dtype == torch.int32
    assert ours.shape == (n_tiles * pk.TILE_R, pk.COL_PAD)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_slab_events_equal_pallas_kernel_on_slabs():
    """What the slab wrapper hands the kernel on the card: the slots as
    flat events (the sentinel and out-of-range rows become -1) give the
    TPU kernel's padded image through the flat-event twin."""
    slabs, n_tiles, n_chunks, theirs = _slab_case()
    rows, cols, deltas = pk.slab_events(*slabs, n_tiles)
    assert rows.dtype == torch.int32 and rows.shape == cols.shape
    assert int((rows < 0).sum()) >= int((slabs[0] < 0).sum())
    ours = pk.pileup_histogram_events_reference(
        rows, cols, deltas, n_tiles * pk.TILE_R, pk.COL_PAD)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_histogram_rejects_bad_slabs():
    good = torch.zeros(pk.CHUNK_E, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        pk.pileup_histogram(good.long(), good, good, 1, 1)
    with pytest.raises(ValueError, match="slots"):
        pk.pileup_histogram(good, good, good, 2, 1)


def test_entry_points_without_device_raise_here():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    rows, cols, deltas = random_events(10, 40, 26)
    for fn in (pk.accumulate_cuda, pk.accumulate_torch):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(rows, cols, deltas, (41, 26))


def _scene_bam(tmp_path):
    reads = [match_read(f"m{i}") for i in range(6)]
    snp_seq = REF[:20] + "T" + REF[21:]
    reads += [match_read(f"s{i}", flag=(0x10 if i % 2 else 0), seq=snp_seq)
              for i in range(4)]
    ins_seq = REF[:21] + "GG" + REF[21:]
    reads += [BamRecord(f"i{i}", 0, 0, 60, "21M2I19M", ins_seq, [30] * 42)
              for i in range(3)]
    del_seq = REF[:30] + REF[33:]
    reads += [BamRecord(f"d{i}", 0, 0, 60, "30M3D7M", del_seq, [30] * 37)
              for i in range(3)]
    path = str(tmp_path / "t.bam")
    write_bam(path, [("chr1", 40)], sorted(reads, key=lambda r: r.pos))
    return path


def _windows(cls, batch, backend):
    rs = cls("chr1", 0, 39, REF, matrix_backend=backend)
    rs.generate_max_insert_summary(batch)
    return rs.generate_summary(batch, **THRESHOLDS)


@pytest.mark.parametrize("backend", sorted(_port_backends()))
def test_event_stream_windows_match_inplace(tmp_path, backend):
    path = _scene_bam(tmp_path)
    batch = BamReader(path).get_reads("chr1", 0, 39)
    golden = _windows(RegionalSummary, batch, None)
    jax_golden = _windows(JaxSummary,
                          JaxBamReader(path).get_reads("chr1", 0, 39), None)
    windows = _windows(RegionalSummary, batch, _port_backends()[backend])
    assert len(windows) == len(golden) == len(jax_golden) > 0
    for w, g, j in zip(windows, golden, jax_golden):
        assert (w.contig, w.position, w.candidates) == \
            (g.contig, g.position, g.candidates) == \
            (j.contig, j.position, j.candidates)
        assert w.image.dtype == g.image.dtype
        np.testing.assert_array_equal(w.image, g.image)
        np.testing.assert_array_equal(w.image, j.image)
