"""The port's HDF5 stores (io/datastore.py, polish/datastore.py) against
the JAX package's, on the CPU: each package's store reads the files the
other's writes, field for field (ImageStore with and without train
labels, PredictionStore's window batches and its HP chunk layout,
PolishImageStore, PolishPredictionStore), a resumed write keeps the
first, and the reference-style files of tests/test_datastore_compat.py
read as the JAX package reads them.  call_variant and polish run with
h5py made unimportable, and a store then raises an ImportError naming
the subcommands that need it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pepper_tpu.decode.candidate_finder import \
    CandidatePrediction as JaxPrediction
from pepper_tpu.io import datastore as jstore
from pepper_tpu.ops.pileup_ref import CandidateWindow as JaxWindow
from pepper_tpu.polish import datastore as jpolish_store
from pepper_tpu_torch.decode.candidate_finder import CandidatePrediction
from pepper_tpu_torch.io import datastore
from pepper_tpu_torch.ops.pileup_ref import CandidateWindow
from pepper_tpu_torch.polish import datastore as polish_store

from test_datastore_compat import (write_reference_style_images,
                                   write_reference_style_predictions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (writer, reader): the port's store writes and the JAX package's reads,
# and the other way round
WAYS = [("port", "jax"), ("jax", "port")]
IMAGE_STORES = {"port": datastore.ImageStore, "jax": jstore.ImageStore}
PREDICTION_STORES = {"port": datastore.PredictionStore,
                     "jax": jstore.PredictionStore}


def _windows(cls, n, seed, features=26, width=33):
    rng = np.random.RandomState(seed)
    return [cls(contig=("chr1", "chr10")[i % 2],
                position=int(rng.randint(0, 10**6)),
                depth=int(rng.randint(0, 255)),
                candidates=[f"{j + 1}{'ACGT'[j]}" for j in range(i % 3 + 1)],
                candidate_frequency=[int(v) for v in
                                     rng.randint(0, 200, i % 3 + 1)],
                image=rng.randint(-125, 126, (width, features)).astype(
                    np.int8),
                base_label=int(rng.randint(0, 15)),
                type_label=int(rng.randint(0, 3)))
            for i in range(n)]


def _predictions(cls, n, seed):
    rng = np.random.RandomState(seed)
    return [cls(contig="chr2", position=int(rng.randint(0, 10**6)),
                depth=int(rng.randint(0, 255)),
                candidates=["1T", "2AG"][:i % 2 + 1],
                candidate_frequency=[int(v) for v in
                                     rng.randint(0, 99, i % 2 + 1)],
                prediction_base=rng.dirichlet(np.ones(3)))
            for i in range(n)]


def _window_fields(w):
    return (w.contig, w.position, w.depth, w.candidates,
            w.candidate_frequency, w.image.astype(np.int32).tobytes(),
            w.base_label, w.type_label)


@pytest.mark.parametrize("train_mode", [False, True])
@pytest.mark.parametrize("writer,reader", WAYS)
def test_image_store_files_read_both_ways(tmp_path, writer, reader,
                                          train_mode):
    path = str(tmp_path / "images.hdf5")
    cls = {"port": CandidateWindow, "jax": JaxWindow}[writer]
    summaries = {"chr1_0_1000": _windows(cls, 5, 1),
                 "chr10_0_500": _windows(cls, 3, 2, features=48, width=21)}
    with IMAGE_STORES[writer](path, "w") as store:
        for name, windows in summaries.items():
            store.write_summary(name, windows, train_mode)
            store.write_summary(name, windows[:1], train_mode)  # ignored
        store.write_summary("empty", [], train_mode)            # skipped
    with IMAGE_STORES[reader](path, "r") as store:
        assert store.summary_names() == sorted(summaries)
        for name, windows in summaries.items():
            got = store.read_summary(name)
            assert all(w.image.dtype == np.int32 for w in got)
            want = [_window_fields(w) for w in windows]
            if not train_mode:
                want = [f[:6] + (0, 0) for f in want]
            assert [_window_fields(w) for w in got] == want


@pytest.mark.parametrize("writer,reader", WAYS)
def test_prediction_store_batches_read_both_ways(tmp_path, writer, reader):
    path = str(tmp_path / "predictions.hdf")
    cls = {"port": CandidatePrediction, "jax": JaxPrediction}[writer]
    batches = {0: _predictions(cls, 4, 3), "chr2_0_100": _predictions(
        cls, 2, 4)}
    with PREDICTION_STORES[writer](path, "w") as store:
        for key, predictions in batches.items():
            store.write_prediction(key, predictions)
    # a resumed run appends and never rewrites a batch it already has
    with PREDICTION_STORES[writer](path, "a") as store:
        store.write_prediction(0, _predictions(cls, 4, 9))
    with PREDICTION_STORES[reader](path, "r") as store:
        assert sorted(store.batch_names()) == sorted(
            f"batch_{key}" for key in batches)
        for key, predictions in batches.items():
            got = store.read_batch(f"batch_{key}")
            assert len(got) == len(predictions)
            for a, b in zip(got, predictions):
                assert (a.contig, a.position, a.depth, a.candidates,
                        a.candidate_frequency) == (
                    b.contig, b.position, b.depth, b.candidates,
                    b.candidate_frequency)
                assert a.prediction_base.dtype == np.float64
                np.testing.assert_array_equal(a.prediction_base,
                                              b.prediction_base)


@pytest.mark.parametrize("writer,reader", WAYS)
def test_prediction_store_hp_chunks_read_both_ways(tmp_path, writer,
                                                   reader):
    path = str(tmp_path / "hp.hdf")
    rng = np.random.RandomState(5)
    chunks = {("chr1", 0, 1000, 0): None, ("chr1", 0, 1000, 11): None,
              ("chr1", 900, 2000, 2): None, ("chr3", 0, 500, 1): None}
    for key in chunks:
        chunks[key] = (rng.randint(0, 5000, 7), rng.randint(0, 3, 7),
                       rng.randint(-20000, 20000, (7, 5)),
                       rng.randint(-20000, 20000, (7, 5)))
    with PREDICTION_STORES[writer](path, "w") as store:
        for key, arrays in chunks.items():
            store.write_prediction_hp(*key, *arrays)
        first = next(iter(chunks))
        store.write_prediction_hp(*first, *(np.zeros_like(a) for a in
                                            chunks[first]))  # resumed
    with PREDICTION_STORES[reader](path, "r") as store:
        assert sorted(store.hp_chunk_keys()) == sorted(chunks)
        for key, arrays in chunks.items():
            got = store.read_prediction_hp(*key)
            for g, want, dtype in zip(got, arrays, (np.int32, np.int32,
                                                    np.int16, np.int16)):
                assert g.dtype == dtype
                np.testing.assert_array_equal(g, want.astype(dtype))


def _polish_records(seed):
    rng = np.random.RandomState(seed)
    records = []
    for contig, start, end in (("ctg2", 900, 2100), ("ctg10", 0, 1100)):
        for chunk_id in rng.permutation(12):
            records.append(dict(
                region=(contig, start, end), chunk_id=int(chunk_id),
                image=rng.randint(0, 255, (1000, 10)),
                label=rng.randint(0, 5, 1000),
                position=rng.randint(0, 5000, 1000),
                index=rng.randint(0, 3, 1000),
                bases=rng.randint(0, 5, 1000),
                phred=rng.uniform(0, 255, 1000)))
    return records


@pytest.mark.parametrize("writer,reader", WAYS)
def test_polish_stores_read_both_ways(tmp_path, writer, reader):
    stores = {"port": polish_store, "jax": jpolish_store}
    records = _polish_records(6)
    images, predictions = str(tmp_path / "im.hdf"), str(tmp_path / "pr.hdf")
    with stores[writer].PolishImageStore(images, "w") as store:
        for r in records:
            name = f"{r['region'][0]}_{r['region'][1]}_{r['chunk_id']}"
            store.write_summary(r["region"], r["image"], r["label"],
                                r["position"], r["index"], r["chunk_id"],
                                name)
    with stores[writer].PolishPredictionStore(predictions, "w") as store:
        for r in records:
            store.write_prediction(*r["region"], r["chunk_id"],
                                   r["position"], r["index"], r["bases"],
                                   r["phred"])
    with stores[reader].PolishImageStore(images, "r") as store:
        names = store.summary_names()
        assert len(names) == len(records) and names == sorted(names)
        by_name = {f"{r['region'][0]}_{r['region'][1]}_{r['chunk_id']}": r
                   for r in records}
        for name in names:
            got, want = store.read_summary(name), by_name[name]
            assert (got["contig"], got["region_start"], got["region_end"],
                    got["chunk_id"]) == (*want["region"], want["chunk_id"])
            assert got["image"].dtype == np.uint8
            for key in ("image", "label", "position", "index"):
                np.testing.assert_array_equal(got[key], want[key])
    with stores[reader].PolishPredictionStore(predictions, "r") as store:
        other = stores[writer].PolishPredictionStore(predictions, "r")
        try:
            assert store.contigs() == other.contigs()
            for contig in store.contigs():
                got = list(store.chunk_groups(contig))
                want = list(other.chunk_groups(contig))
                assert [g[:3] for g in got] == [w[:3] for w in want]
                for (*_, records_a), (*_, records_b) in zip(got, want):
                    assert len(records_a) == len(records_b) == 12
                    for a, b in zip(records_a, records_b):
                        assert a[0] == b[0]
                        np.testing.assert_array_equal(a[1], b[1])
                        np.testing.assert_array_equal(a[2], b[2])
        finally:
            other.close()


def test_reference_style_files_read_as_jax_reads_them(tmp_path):
    """tests/test_datastore_compat.py's reference-layout files: candidates
    as (N, 1) vlen-str rows, frequencies uint8."""
    images, predictions = str(tmp_path / "ref.hdf5"), str(tmp_path /
                                                          "ref.hdf")
    write_reference_style_images(images)
    write_reference_style_predictions(predictions)
    with datastore.ImageStore(images) as ours, \
            jstore.ImageStore(images) as theirs:
        assert ours.summary_names() == theirs.summary_names() == [
            "chr1_0_100"]
        got = ours.read_summary("chr1_0_100")
        assert [w.candidates for w in got] == [["1T"], ["2AG"]]
        assert [_window_fields(w) for w in got] == [
            _window_fields(w) for w in theirs.read_summary("chr1_0_100")]
    with datastore.PredictionStore(predictions) as ours, \
            jstore.PredictionStore(predictions) as theirs:
        got, want = ours.read_batch("batch_0"), theirs.read_batch("batch_0")
        assert got[0].candidates == want[0].candidates == ["1T"]
        assert got[0].candidate_frequency == want[0].candidate_frequency
        np.testing.assert_array_equal(got[0].prediction_base,
                                      want[0].prediction_base)


BLOCKED = r'''
import sys
sys.modules["h5py"] = None            # import h5py now raises ImportError
sys.path.insert(0, {repo!r})
from pepper_tpu_torch.cli import main as cli, polish_main
from pepper_tpu_torch.io.datastore import ImageStore
from pepper_tpu_torch.polish.datastore import PolishPredictionStore

assert cli.main(["call_variant", "-b", {bam!r}, "-f", {fasta!r},
                 "-o", {out!r} + "/call", "--dry", "--device", "cpu",
                 "--ont_r9_guppy5_sup"]) == 0
assert polish_main.main(["polish", "-b", {bam!r}, "-f", {fasta!r},
                         "-o", {out!r} + "/polish", "--dry",
                         "--device", "cpu"]) == 0
for store in (ImageStore, PolishPredictionStore):
    try:
        store({out!r} + "/x.hdf", "w")
    except ImportError as exc:
        assert "make_images" in str(exc) and "call_variant" in str(exc)
    else:
        raise AssertionError("a store opened without h5py")
print("RAN WITHOUT H5PY")
'''


def test_call_variant_and_polish_run_without_h5py(tmp_path):
    from pepper_tpu.io.bam_writer import write_bam, write_fasta
    from simulate import random_reference, simulate_reads

    ref = random_reference(2500, seed=41)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}[ref[600]]
    records = simulate_reads(ref, [[(600, ref[600], alt)], []],
                             read_len=300, stride=20)
    bam, fasta = str(tmp_path / "s.bam"), str(tmp_path / "r.fa")
    write_bam(bam, [("chr5", len(ref))], records)
    write_fasta(fasta, {"chr5": ref})
    script = BLOCKED.format(repo=REPO, bam=bam, fasta=fasta,
                            out=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "RAN WITHOUT H5PY" in proc.stdout
    assert os.path.exists(tmp_path / "call" / "PEPPER_VARIANT_FULL.vcf.gz")
    assert os.path.exists(tmp_path / "polish" /
                          "consensus_pepper_polished.fa")
