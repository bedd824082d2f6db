"""The port's host utilities against the JAX package, on the CPU:
utils/{vcf_compare,pileup_text,merge_images,download_model}.py and
polish/{stitch_v2,legacy_variant_summary}.py, each on the inputs of the
JAX package's own tests (tests/test_utils_and_hyperband.py,
tests/test_merge_images.py, tests/test_align.py's stitch_v2 cases,
tests/test_legacy_variant_summary.py, tests/test_download_models.py).
Every output must equal JAX's."""

import os

import h5py
import numpy as np
import pytest

from pepper_tpu.io.bam import BamReader as JaxBamReader
from pepper_tpu.io.bam_writer import BamRecord, write_bam
from pepper_tpu.ops.pileup_ref import RegionalSummary as JaxRegionalSummary
from pepper_tpu.polish import legacy_variant_summary as jlegacy
from pepper_tpu.polish.stitch_v2 import alignment_stitch as j_stitch
from pepper_tpu.utils import download_model as jdownload
from pepper_tpu.utils import merge_images as jmerge
from pepper_tpu.utils import pileup_text as jtext
from pepper_tpu.utils import vcf_compare as jvcf
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.ops.pileup_ref import RegionalSummary
from pepper_tpu_torch.polish import legacy_variant_summary as legacy
from pepper_tpu_torch.polish.stitch_v2 import alignment_stitch
from pepper_tpu_torch.utils import download_model, merge_images, pileup_text
from pepper_tpu_torch.utils import vcf_compare

from simulate import random_reference
from test_download_models import _make_mirror
from test_legacy_variant_summary import REF, base_reads
from test_merge_images import write_store
from test_utils_and_hyperband import _write_vcf

# ---------------------------------------------------------------- VCFs


@pytest.fixture
def vcf_pair(tmp_path):
    """tests/test_utils_and_hyperband.py's two call sets."""
    a, b = str(tmp_path / "a.vcf"), str(tmp_path / "b.vcf")
    _write_vcf(a, [("chr1", 100, "A", "T", "0/1", "0.5"),
                   ("chr1", 200, "C", "G", "1/1", "0.9"),
                   ("chr1", 300, "CAA", "C", "0/1", "0.4")])
    _write_vcf(b, [("chr1", 100, "A", "T", "0/1", "0.5"),
                   ("chr1", 200, "C", "A", "1/1", "0.9"),
                   ("chr1", 400, "G", "GTT", "0/1", "0.3")])
    return a, b


def _record(r):
    return (r.contig, r.start, r.ref, tuple(r.alts), tuple(r.genotype))


def _sites(comparison):
    """Each list's records (or record pairs, for the mismatches)."""
    return {name: [tuple(map(_record, item)) if isinstance(item, tuple)
                   else _record(item) for item in getattr(comparison, name)]
            for name in comparison.summary()}


def test_compare_vcfs_matches_jax(vcf_pair):
    for pair in (vcf_pair, vcf_pair[::-1], (vcf_pair[0],) * 2):
        ours, theirs = vcf_compare.compare_vcfs(*pair), jvcf.compare_vcfs(
            *pair)
        assert ours.summary() == theirs.summary()
        assert _sites(ours) == _sites(theirs)


def test_vcf_statistics_and_histogram_match_jax(vcf_pair):
    for path in vcf_pair:
        ours, theirs = (vcf_compare.vcf_statistics(path),
                        jvcf.vcf_statistics(path))
        assert ours == theirs
        for bins in (10, 20):
            assert vcf_compare.vaf_histogram(ours["vafs"], bins=bins) == \
                jvcf.vaf_histogram(theirs["vafs"], bins=bins)
    assert vcf_compare.vaf_histogram([]) == jvcf.vaf_histogram([])


# ---------------------------------------------------------------- text


def test_render_matrix_matches_jax():
    image = np.zeros((4, 26), np.int32)
    image[0, 0] = 1
    image[1, 8] = -5
    for ref in ("ACGT", ""):
        assert pileup_text.render_matrix(image, ref) == \
            jtext.render_matrix(image, ref)


def test_render_reads_and_candidate_window_match_jax(tmp_path):
    ref = "ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"
    snp_seq = ref[:20] + "T" + ref[21:]
    reads = [BamRecord(f"m{i}", 0, 0, 60, "40M", ref, [30] * 40)
             for i in range(4)]
    reads += [BamRecord("s0", 0, 0, 60, "40M", snp_seq, [30] * 40),
              BamRecord("s1", 0, 0, 60, "40M", snp_seq, [30] * 40,
                        flag=0x10)]
    path = str(tmp_path / "r.bam")
    write_bam(path, [("c", 40)], sorted(reads, key=lambda r: r.pos))
    dumps = {}
    for name, reader, summary_class, module in (
            ("port", BamReader, RegionalSummary, pileup_text),
            ("jax", JaxBamReader, JaxRegionalSummary, jtext)):
        batch = reader(path).get_reads("c", 0, 39)
        summary = summary_class("c", 0, 39, ref)
        summary.generate_max_insert_summary(batch)
        windows = summary.generate_summary(
            batch, min_snp_baseq=1, min_indel_baseq=1,
            snp_freq_threshold=0.1, insert_freq_threshold=0.15,
            delete_freq_threshold=0.15, min_coverage_threshold=1,
            snp_candidate_freq_threshold=0.1,
            indel_candidate_freq_threshold=0.1,
            candidate_support_threshold=1, skip_indels=False,
            candidate_region_start=0, candidate_region_end=39)
        dumps[name] = (module.render_reads(batch, ref, 0, 39),
                       module.render_reads(batch, ref, 0, 39, max_reads=2),
                       [module.render_candidate_window(w) for w in windows])
    assert dumps["port"] == dumps["jax"]
    assert "CANDIDATE PILEUP" in dumps["port"][2][0]


# ---------------------------------------------------------------- merges


@pytest.fixture
def image_stores(tmp_path):
    """tests/test_merge_images.py's stores: three regions over two files
    (and a file that is not a store), then two files sharing a name."""
    d = tmp_path / "images"
    d.mkdir()
    write_store(str(d / "a.hdf5"), [("chr1_0_100", 3)])
    write_store(str(d / "b.hdf"), [("chr1_100_200", 2), ("chr1_200_300", 1)])
    (d / "notes.txt").write_text("ignored")
    same = tmp_path / "same"
    same.mkdir()
    write_store(str(same / "a.hdf5"), [("r1", 2)])
    write_store(str(same / "b.hdf5"), [("r1", 4)])
    return tmp_path, str(d), str(same)


def test_merge_image_index_matches_jax(image_stores):
    tmp, directory, _ = image_stores
    assert merge_images.image_files_in(directory) == \
        jmerge.image_files_in(directory)
    ours, theirs = str(tmp / "ours.hdf"), str(tmp / "theirs.hdf")
    total = merge_images.merge_image_index(directory, ours)
    assert total == jmerge.merge_image_index(directory, theirs) == 6
    for record_id in range(total):
        assert merge_images.read_indexed_record(ours, record_id) == \
            jmerge.read_indexed_record(theirs, record_id)
        assert merge_images.read_indexed_record(theirs, record_id) == \
            jmerge.read_indexed_record(theirs, record_id)


def _tree(path):
    with h5py.File(path, "r") as fh:
        out = {}
        fh.visititems(lambda name, node: out.setdefault(
            name, node[()].tolist() if isinstance(node, h5py.Dataset)
            else None))
        return out


@pytest.mark.parametrize("which", ["regions", "same_names"])
def test_merge_image_stores_matches_jax(image_stores, which):
    tmp, directory, same = image_stores
    source = directory if which == "regions" else same
    ours, theirs = str(tmp / "ours.hdf5"), str(tmp / "theirs.hdf5")
    assert merge_images.merge_image_stores(source, ours) == \
        jmerge.merge_image_stores(source, theirs)
    assert _tree(ours) == _tree(theirs)


# ---------------------------------------------------------------- stitch


@pytest.mark.parametrize("case", ["overlap", "gap", "three", "one"])
def test_alignment_stitch_matches_jax(case):
    """tests/test_align.py's overlap and gap cases, three chunks with both
    and a single chunk."""
    ref = random_reference(300, seed={"gap": 6}.get(case, 5))
    chunks = {
        "overlap": [("c", 0, 180, ref[0:180]), ("c", 150, 300, ref[150:300])],
        "gap": [("c", 0, 100, ref[0:100]), ("c", 150, 300, ref[150:300])],
        "three": [("c", 0, 120, ref[0:120]), ("c", 90, 200, ref[90:200]),
                  ("c", 240, 300, ref[240:300])],
        "one": [("c", 0, 300, ref)]}[case]
    ours = alignment_stitch(chunks)
    assert ours == j_stitch(chunks)
    if case == "overlap":
        assert ours[3] == ref


# ---------------------------------------------------------------- legacy


def _batches(tmp_path, reads, name):
    path = str(tmp_path / name)
    write_bam(path, [("chr1", 40)], sorted(reads, key=lambda r: r.pos))
    return (BamReader(path).get_reads("chr1", 0, 39),
            JaxBamReader(path).get_reads("chr1", 0, 39))


FIELDS = ("genomic_pos", "image", "ref_image", "labels",
          "bad_label_positions")


def _fields(summary):
    fields = {name: np.asarray(getattr(summary, name)).tolist()
              for name in FIELDS}
    fields["coverage"] = [summary.coverage[pos] for pos in range(40)]
    return fields


def test_legacy_pair_labels_match_jax():
    for a in "*ACGTN\0":
        for b in "*ACGTN\0":
            assert legacy.get_pair_label(a, b) == jlegacy.get_pair_label(a, b)
        assert legacy.get_reference_feature_index(a) == \
            jlegacy.get_reference_feature_index(a)


@pytest.mark.parametrize("truth", ["inference", "hom_ref", "variants"])
def test_legacy_variant_summary_and_chunkers_match_jax(tmp_path, truth):
    """tests/test_legacy_variant_summary.py's reads, summarized without
    truth and with its two truth pairs; both chunkers at 16/4."""
    ours_batch, theirs_batch = _batches(tmp_path, base_reads(), "reads.bam")
    if truth == "hom_ref":
        hp1 = BamRecord("hp1", 0, 0, 60, "40M", REF, [30] * 40)
        hp2 = BamRecord("hp2", 0, 0, 60, "40M", REF, [30] * 40)
    else:
        hp1_seq = REF[:5] + "G" + REF[6:11] + "C" + REF[11:]
        hp1 = BamRecord("hp1", 0, 0, 60, "11M1I29M", hp1_seq, [30] * 41)
        hp2 = BamRecord("hp2", 0, 0, 60, "20M2D18M", REF[:20] + REF[22:],
                        [30] * 38)
    ours_truth, theirs_truth = _batches(tmp_path, [hp1, hp2], "truth.bam")
    results = []
    for module, batch, truth_batch in ((legacy, ours_batch, ours_truth),
                                       (jlegacy, theirs_batch, theirs_truth)):
        summary = module.LegacyVariantSummary(REF, "chr1", 0, 39)
        if truth == "inference":
            summary.generate_summary(batch)
        else:
            summary.generate_train_summary(
                batch, truth_batch, truth_batch.names.index("hp1"),
                truth_batch.names.index("hp2"))
        chunked = [module.chunk_image(summary, chunk_size=16,
                                      chunk_overlap=4)]
        if truth != "inference":
            chunked.append(module.chunk_image_train(summary, chunk_size=16,
                                                    chunk_overlap=4))
        results.append((_fields(summary), [
            [np.asarray(part).tolist() for part in parts]
            for parts in chunked]))
    assert results[0] == results[1]
    assert len(results[0][0]["genomic_pos"]) == 42


# ---------------------------------------------------------------- models


def test_download_models_matches_jax(tmp_path):
    url = _make_mirror(tmp_path)
    ours = download_model.download_models(str(tmp_path / "ours"), url)
    theirs = jdownload.download_models(str(tmp_path / "theirs"), url)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # present models are kept and reported again, nothing left half written
    assert download_model.download_models(str(tmp_path / "ours"), url) == ours
    assert not any(p.endswith(".part") for p in os.listdir(tmp_path / "ours"))
    assert download_model.DEFAULT_DESCRIPTION_URL == \
        jdownload.DEFAULT_DESCRIPTION_URL


@pytest.mark.parametrize("cli", ["variant", "polish"])
def test_download_models_cli_and_offline_failure(tmp_path, capsys, cli):
    """Both CLIs fetch from a file:// mirror and print the count; a list
    that cannot be fetched returns 1 and writes no model."""
    from pepper_tpu_torch.cli import main, polish_main

    run = main.main if cli == "variant" else polish_main.main
    url = _make_mirror(tmp_path)
    out = tmp_path / "models"
    assert run(["download_models", "-o", str(out), "--description_url",
                url]) == 0
    assert "2 model(s)" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["PEPPER_POLISH.pkl",
                                       "PEPPER_VARIANT_ONT.pkl"]
    offline = tmp_path / "offline"
    assert run(["download_models", "-o", str(offline), "--description_url",
                f"file://{tmp_path}/does_not_exist.csv"]) == 1
    assert os.listdir(offline) == []
    with pytest.raises(OSError):
        download_model.download_models(
            str(offline), f"file://{tmp_path}/does_not_exist.csv")
