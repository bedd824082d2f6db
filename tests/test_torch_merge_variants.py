"""The port's merge_variants (decode/merge_variants.py) and VCF reader
(io/vcf_reader.py) against the JAX package's, on the CPU: on the inputs
of tests/test_merge_variants_scale.py's non-slow cases (fuzzed
multi-contig records sorted and shuffled, the snps+indels pair with a
duplicated position, contigs absent from the header) the merged
.vcf.gz and its .tbi are byte-equal, and read_vcf and
get_truth_haplotype_records give equal records."""

import gzip

import numpy as np
import pytest

from pepper_tpu.decode.merge_variants import \
    merge_vcf_records as j_merge_vcf_records
from pepper_tpu.io import vcf_reader as j_vcf_reader
from pepper_tpu_torch.cli import main as cli
from pepper_tpu_torch.decode.merge_variants import merge_vcf_records
from pepper_tpu_torch.io import vcf_reader

from test_merge_variants_scale import _random_records, _write_vcf

OUTPUT = "PEPPER_MARGIN_DEEPVARIANT_OUTPUT.vcf.gz"
FUZZ_CONTIGS = [("chr2", 5000), ("chr1", 5000), ("chr10", 5000)]


def _fuzz(order):
    """test_streamed_merge_matches_dict_fallback_fuzz's inputs (seed 17):
    PEPPER records, DV records on half their positions plus DV-only ones,
    unique DV positions; `order` sorts both, or shuffles DV, or both."""
    rng = np.random.RandomState(17)
    key_order = {name: i for i, (name, _) in enumerate(FUZZ_CONTIGS)}
    pepper = _random_records(rng, FUZZ_CONTIGS, 400, {True: "T", False: "G"})
    dv = [(c, p, r, "C", q + 1, f, g)
          for (c, p, r, _a, q, f, g) in pepper[::2]]
    dv += _random_records(rng, FUZZ_CONTIGS, 100, {True: "A", False: "C"})
    seen = set()
    dv = [r for r in dv
          if (r[0], r[1]) not in seen and not seen.add((r[0], r[1]))]

    def sort(records):
        return sorted(records, key=lambda r: (key_order[r[0]], r[1]))

    pepper, dv = sort(pepper), sort(dv)
    if order in ("dv_shuffled", "both_shuffled"):
        rng.shuffle(dv)
    if order == "both_shuffled":
        rng.shuffle(pepper)
    return FUZZ_CONTIGS, pepper, dv, None


CASES = {
    "fuzz_sorted": lambda: _fuzz("sorted"),
    "fuzz_dv_shuffled": lambda: _fuzz("dv_shuffled"),
    "fuzz_both_shuffled": lambda: _fuzz("both_shuffled"),
    # test_snps_indels_pair_last_wins
    "snps_indels_pair": lambda: (
        [("chr1", 1000)],
        [("chr1", 100, "A", "T", 10, "PASS", "0/1"),
         ("chr1", 100, "A", "G", 11, "PASS", "0/1"),
         ("chr1", 200, "C", "G", 12, "PASS", "1/1")],
        None,
        ([("chr1", 100, "A", "C", 50, "PASS", "1/1")],
         [("chr1", 100, "A", "ACC", 60, "PASS", "0/1")])),
    # test_unknown_contig_ordering
    "unknown_contigs": lambda: (
        [("chr1", 1000)],
        [("chr1", 10, "A", "T", 10, "PASS", "0/1"),
         ("ctgA", 5, "C", "G", 10, "PASS", "0/1"),
         ("ctgB", 7, "G", "A", 10, "PASS", "0/1")],
        [("ctgA", 5, "C", "GG", 77, "PASS", "1/1")], None),
}


def _write_inputs(tmp_path, case):
    contigs, pepper, dv, dv_pair = CASES[case]()

    class Options:
        vcf_pepper = str(tmp_path / "pepper.vcf")
        vcf_deepvariant = None
        vcf_deepvariant_snps = None
        vcf_deepvariant_indels = None
        output_dir = None

    _write_vcf(Options.vcf_pepper, contigs, pepper)
    if dv_pair is None:
        Options.vcf_deepvariant = str(tmp_path / "dv.vcf")
        _write_vcf(Options.vcf_deepvariant, contigs, dv)
    else:
        Options.vcf_deepvariant_snps = str(tmp_path / "dv_snps.vcf")
        Options.vcf_deepvariant_indels = str(tmp_path / "dv_indels.vcf")
        _write_vcf(Options.vcf_deepvariant_snps, contigs, dv_pair[0])
        _write_vcf(Options.vcf_deepvariant_indels, contigs, dv_pair[1])
    return Options


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_is_byte_equal_to_jax(tmp_path, case):
    options = _write_inputs(tmp_path, case)
    options.output_dir = str(tmp_path / "ours")
    ours = merge_vcf_records(options())
    options.output_dir = str(tmp_path / "theirs")
    theirs = j_merge_vcf_records(options())
    for suffix in ("", ".tbi"):
        with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    with gzip.open(ours, "rt") as f:
        body = [line for line in f if not line.startswith("#")]
    assert body and len(body) == len(CASES[case]()[1])


@pytest.mark.parametrize("case", ["fuzz_sorted", "snps_indels_pair"])
def test_merge_variants_cli_writes_the_library_bytes(tmp_path, case):
    """The CLI subcommand with the JAX CLI's arguments (-vp, -vd or -vds
    and -vdi, -o) writes what the library call writes."""
    options = _write_inputs(tmp_path, case)
    options.output_dir = str(tmp_path / "lib")
    library = merge_vcf_records(options())
    argv = ["merge_variants", "-vp", options.vcf_pepper,
            "-o", str(tmp_path / "cli")]
    if options.vcf_deepvariant:
        argv += ["-vd", options.vcf_deepvariant]
    else:
        argv += ["-vds", options.vcf_deepvariant_snps,
                 "-vdi", options.vcf_deepvariant_indels]
    assert cli.main(argv) == 0
    with open(library, "rb") as a, open(tmp_path / "cli" / OUTPUT,
                                        "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "bgzip"])
def test_read_vcf_and_truth_records_equal_jax(tmp_path, compress):
    _, pepper, _, _ = _fuzz("both_shuffled")
    path = str(tmp_path / "records.vcf")
    _write_vcf(path, FUZZ_CONTIGS, pepper)
    if compress:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as out:
            out.write(f.read())
        path += ".gz"
    for window in ((None, None, None), ("chr1", 1000, 3000),
                   ("chr10", 0, 5000)):
        ours = list(vcf_reader.read_vcf(path, *window))
        theirs = list(j_vcf_reader.read_vcf(path, *window))
        assert ours and [vars(r) for r in ours] == [vars(r) for r in theirs]
    hap = vcf_reader.get_truth_haplotype_records(path, "chr2", 0, 5000)
    j_hap = j_vcf_reader.get_truth_haplotype_records(path, "chr2", 0, 5000)
    assert hap[0] and [[vars(r) for r in h] for h in hap] == \
        [[vars(r) for r in h] for h in j_hap]
