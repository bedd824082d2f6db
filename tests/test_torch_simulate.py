"""The port's copy of the read simulator (pepper_tpu_torch/utils/simulate.py)
against tests/simulate.py from the same seeds: references, variant lists,
reads field by field under each error model, the truth VCF's bytes, a
small mixed genome's files byte for byte, and the per-type scorer."""

import dataclasses
import gzip

import numpy as np
import pytest

import simulate as jax_sim
from pepper_tpu_torch.utils import simulate as port_sim


def _fields(records):
    return [dataclasses.asdict(r) for r in records]


def test_references_are_equal():
    assert (port_sim.random_reference(5000, seed=4)
            == jax_sim.random_reference(5000, seed=4))
    assert (port_sim.reference_with_homopolymers(20_000, 3)
            == jax_sim.reference_with_homopolymers(20_000, 3))
    assert (port_sim.reference_with_repeats(20_000, 5)
            == jax_sim.reference_with_repeats(20_000, 5))


@pytest.mark.parametrize("with_str", [False, True])
def test_mixed_variant_lists_are_equal(with_str):
    if with_str:
        ref, hp_runs, str_runs = jax_sim.reference_with_repeats(30_000, 9)
    else:
        ref, hp_runs = jax_sim.reference_with_homopolymers(30_000, 9)
        str_runs = ()
    ours = port_sim.make_mixed_variants(ref, hp_runs, 60, 80, 9,
                                        str_runs=str_runs)
    theirs = jax_sim.make_mixed_variants(ref, hp_runs, 60, 80, 9,
                                         str_runs=str_runs)
    assert ours == theirs
    assert {port_sim.variant_type(r, a) for _, r, a, _ in ours[0]} == {
        "SNP", "INS", "DEL"}


@pytest.mark.parametrize("kwargs", [
    dict(error_model="uniform", error_rate=0.03),
    dict(error_model="uniform", error_rate=0.0, strides=[40, 60]),
    dict(error_model="ont"),
    dict(error_model="ont", ont_params="str",
         dropout_regions=[(1000, 2500, 0.25)]),
], ids=["uniform", "uniform-strides", "ont", "ont_str-dropout"])
def test_reads_are_equal_field_by_field(kwargs):
    ref = jax_sim.random_reference(6000, seed=12)
    variants = [(700, ref[700], "A" if ref[700] != "A" else "C"),
                (1500, ref[1500], ref[1500] + "GT"),
                (3100, ref[3100:3104], ref[3100])]
    port_kwargs, jax_kwargs = dict(kwargs), dict(kwargs)
    if kwargs.get("ont_params") == "str":
        port_kwargs["ont_params"] = port_sim.ONT_STR_PARAMS
        jax_kwargs["ont_params"] = jax_sim.ONT_STR_PARAMS
    ours = port_sim.simulate_reads(ref, [variants, variants[:1]],
                                   read_len=800, stride=50, error_seed=5,
                                   **port_kwargs)
    theirs = jax_sim.simulate_reads(ref, [variants, variants[:1]],
                                    read_len=800, stride=50, error_seed=5,
                                    **jax_kwargs)
    assert len(ours) > 50 and _fields(ours) == _fields(theirs)


def test_ont_errors_and_tandem_copies_are_equal():
    seq = jax_sim.random_reference(2000, seed=2) + "ACACACACAC" + "TTTTTTT"
    cigar = [("M", 600), ("I", 3), ("M", 700), ("D", 5), ("M", 714)]
    for reverse in (False, True):
        ours = port_sim.apply_ont_errors(seq, cigar,
                                         np.random.RandomState(3), reverse,
                                         port_sim.ONT_STR_PARAMS)
        theirs = jax_sim.apply_ont_errors(seq, cigar,
                                          np.random.RandomState(3), reverse,
                                          jax_sim.ONT_STR_PARAMS)
        assert ours == theirs
    codes = np.frombuffer(seq.encode(), np.uint8)
    np.testing.assert_array_equal(port_sim._read_tandem_copies(codes),
                                  jax_sim._read_tandem_copies(codes))


def test_truth_vcf_bytes_are_equal(tmp_path):
    variants = [(99, "A", "T", "1|0"), (10, "ACG", "A", "1|1"),
                (500, "C", "CTT", "0|1")]
    port_sim.write_truth_vcf(str(tmp_path / "ours.vcf"), "chrT", 1000,
                             variants)
    jax_sim.write_truth_vcf(str(tmp_path / "theirs.vcf"), "chrT", 1000,
                            variants)
    assert ((tmp_path / "ours.vcf").read_bytes()
            == (tmp_path / "theirs.vcf").read_bytes())


@pytest.mark.parametrize("error_model", ["uniform", "ont_str"])
def test_mixed_genome_files_are_equal_byte_for_byte(tmp_path, error_model):
    kwargs = dict(read_len=1000, strides=(200, 200, 700),
                  error_model=error_model)
    ours = port_sim.build_mixed_genome(str(tmp_path / "ours"), "g", 30_000,
                                       40, 60, 21, **kwargs)
    theirs = jax_sim.build_mixed_genome(str(tmp_path / "theirs"), "g",
                                        30_000, 40, 60, 21, **kwargs)
    assert ours["variants"] == theirs["variants"]
    assert ours["noise"] == theirs["noise"] and ours["ref"] == theirs["ref"]
    for key in ("bam", "fasta", "truth", "bed"):
        with open(ours[key], "rb") as a, open(theirs[key], "rb") as b:
            assert a.read() == b.read(), key


def test_score_vcf_by_type_is_equal(tmp_path):
    variants = [(99, "A", "T", "1|0"), (200, "ACG", "A", "1|1"),
                (500, "C", "CTT", "0|1"), (700, "G", "C", "1|1")]
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
             "c\t100\t.\tA\tT\t30\tPASS\t.\tGT:GQ\t0/1:20",
             "c\t201\t.\tACG\tA\t30\tPASS\t.\tGT:GQ\t0/1:20",
             "c\t501\t.\tC\tCTT,CT\t30\tPASS\t.\tGT:GQ\t1/2:20",
             "c\t650\t.\tT\tTA\t30\tPASS\t.\tGT:GQ\t0/1:20",
             "c\t800\t.\tG\tA\t30\tPASS\t.\tGT:GQ\t0/0:20"]
    path = str(tmp_path / "calls.vcf.gz")
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    ours = port_sim.score_vcf_by_type(path, variants)
    assert ours == jax_sim.score_vcf_by_type(path, variants)
    assert ours["ALL"]["tp"] == 3 and ours["INS"]["fp"] == 1
