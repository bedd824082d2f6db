"""The port's call_variant on the CPU against the JAX package's on the
test_e2e scene (3 kb, seed 11), same weights through params_from_jax.

The bar is the call set: the (pos, REF, ALT, GT, FILTER) records of all
three VCFs must be equal.  QUAL is left out because it is printed from
float32 probabilities that the two frameworks sum in different orders.
"""

import gzip

import jax
import numpy as np
import pytest

from pepper_tpu.io.bam import BamReader as JaxBamReader
from pepper_tpu.io.bam_writer import write_bam, write_fasta
from pepper_tpu.io.fasta import FastaReader as JaxFastaReader
from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.pipeline import call_variant as jcv
from pepper_tpu.pipeline.summarizer import \
    create_region_summary as jax_region_summary
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.cli import main as cli
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.models.checkpoint import load_params, save_params
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.pipeline import call_variant as cv
from pepper_tpu_torch.pipeline.summarizer import create_region_summary
from pepper_tpu_torch.presets import set_parameters

from simulate import random_reference, simulate_reads

CONTIG = "chr20"
VCFS = ("PEPPER_VARIANT_FULL", "PEPPER_VARIANT_OUTPUT_PEPPER",
        "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    ref = random_reference(3000, seed=11)

    def alt_base(pos):
        return {"A": "T", "T": "A", "C": "G", "G": "C"}[ref[pos]]

    het_snp = (500, ref[500], alt_base(500))
    hom_snp = (800, ref[800], alt_base(800))
    het_ins = (1100, ref[1100], ref[1100] + "GG"
               if ref[1100] != "G" else ref[1100] + "TT")
    het_del = (1400, ref[1400:1403], ref[1400])
    records = simulate_reads(ref, [[het_snp, hom_snp, het_ins, het_del],
                                   [hom_snp]], read_len=300, stride=20)
    bam, fasta = str(tmp / "sim.bam"), str(tmp / "ref.fa")
    write_bam(bam, [(CONTIG, len(ref))], records)
    write_fasta(fasta, {CONTIG: ref})
    params = jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(0), TransducerConfig(hidden=32, linear_size=64)))
    return dict(bam=bam, fasta=fasta, tmp=tmp, params=params)


def _options(cls, preset, sim, out_dir, **overrides):
    options = cls(bam=sim["bam"], fasta=sim["fasta"],
                  output_dir=str(out_dir), threads=1, sample_name="SAMPLE",
                  ont_r9_guppy5_sup=True, sub_command="call_variant",
                  region=CONTIG)
    for key, value in overrides.items():
        setattr(options, key, value)
    return preset(options)


def _records(out_dir, name):
    rows = []
    with gzip.open(f"{out_dir}/{name}.vcf.gz", "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            sample = dict(zip(fields[8].split(":"), fields[9].split(":")))
            rows.append((fields[0], int(fields[1]), fields[3], fields[4],
                         sample["GT"], fields[6]))
    return rows


def _assert_same_calls(ours, theirs):
    for name in VCFS:
        assert _records(ours, name) == _records(theirs, name), name


@pytest.fixture(scope="module")
def jax_model_run(sim):
    out = sim["tmp"] / "jax_model"
    jcv.call_variant(_options(JaxOptions, jax_set_parameters, sim, out),
                     params=sim["params"])
    return out


def test_model_calls_match_jax(sim, jax_model_run):
    out = sim["tmp"] / "torch_model"
    totals = cv.call_variant(_options(PepperOptions, set_parameters, sim, out),
                             params=sim["params"], device="cpu")
    assert totals[0] > 0
    assert _records(out, "PEPPER_VARIANT_FULL")
    _assert_same_calls(out, jax_model_run)


def test_dry_calls_match_jax(sim):
    ours, theirs = sim["tmp"] / "torch_dry", sim["tmp"] / "jax_dry"
    cv.call_variant(_options(PepperOptions, set_parameters, sim, ours,
                             dry=True), device="cpu")
    jcv.call_variant(_options(JaxOptions, jax_set_parameters, sim, theirs,
                              dry=True))
    _assert_same_calls(ours, theirs)


def test_windows_match_jax_byte_for_byte(sim):
    options = _options(PepperOptions, set_parameters, sim, sim["tmp"])
    joptions = _options(JaxOptions, jax_set_parameters, sim, sim["tmp"])
    seen = 0
    for start, end in ((0, 1500), (1500, 2999)):
        ours = create_region_summary(options, BamReader(sim["bam"]),
                                     FastaReader(sim["fasta"]), CONTIG,
                                     start, end)
        theirs = jax_region_summary(joptions, JaxBamReader(sim["bam"]),
                                    JaxFastaReader(sim["fasta"]), CONTIG,
                                    start, end)
        assert len(ours) == len(theirs)
        seen += len(ours)
        for a, b in zip(ours, theirs):
            assert (a.contig, a.position, a.depth, a.candidates,
                    a.candidate_frequency) == (b.contig, b.position,
                                               b.depth, b.candidates,
                                               b.candidate_frequency)
            assert a.image.dtype == b.image.dtype == np.int8
            assert a.image.tobytes() == b.image.tobytes()
    assert seen == 4   # the scene's four variant sites


def test_thread_pool_matches_sequential(sim):
    """threads > 1 (forked pool for windows and decode) emits the same
    records as one thread over the same intervals."""
    seq, par = sim["tmp"] / "torch_seq", sim["tmp"] / "torch_par"
    cv.call_variant(_options(PepperOptions, set_parameters, sim, seq,
                             region_size=1000), params=sim["params"],
                    device="cpu")
    cv.call_variant(_options(PepperOptions, set_parameters, sim, par,
                             region_size=1000, threads=3),
                    params=sim["params"], device="cpu")
    _assert_same_calls(par, seq)


def test_cli_call_variant_matches_library(sim, jax_model_run):
    model = str(sim["tmp"] / "model.npz")
    save_params(model, sim["params"], {"model_type": "lstm"})
    loaded, meta = load_params(model)
    assert meta == {"model_type": "lstm"}
    assert loaded["linear_1"]["w"].shape == sim["params"]["linear_1"]["w"].shape
    out = sim["tmp"] / "torch_cli"
    assert cli.main(["call_variant", "-b", sim["bam"], "-f", sim["fasta"],
                     "-m", model, "-o", str(out), "-s", "SAMPLE",
                     "-r", CONTIG, "--ont_r9_guppy5_sup",
                     "--compute_dtype", "float32", "--device", "cpu"]) == 0
    _assert_same_calls(out, jax_model_run)


@pytest.mark.parametrize("override,item", [
    ({"model_type": "no_cnn"}, "item 6"),
    ({"num_devices": 2}, "item 7"),
    ({"use_hp_info": True}, "item 9"),
])
def test_unported_options_raise(sim, override, item):
    options = _options(PepperOptions, set_parameters, sim,
                       sim["tmp"] / "unported", **override)
    with pytest.raises(NotImplementedError, match=item):
        cv.call_variant(options, params=sim["params"], device="cpu")


def test_num_devices_all_resolves_to_one(sim):
    options = _options(PepperOptions, set_parameters, sim, sim["tmp"],
                       num_devices=-1)
    cv.resolve_num_devices(options)
    assert options.num_devices == 1


@pytest.mark.parametrize("argv,error", [
    (["--sharded"], NotImplementedError),
    (["--use_hp_info"], NotImplementedError),
    (["--num_devices", "2"], NotImplementedError),
    # an unknown int8 mode is not accepted (argparse exits)
    (["--quantized", "--quantize_mode", "int4"], SystemExit),
])
def test_cli_unported_flags_raise(sim, argv, error):
    model = str(sim["tmp"] / "model_flags.npz")
    save_params(model, sim["params"])
    with pytest.raises(error):
        cli.main(["call_variant", "-b", sim["bam"], "-f", sim["fasta"],
                  "-m", model, "-o", str(sim["tmp"] / "flags"),
                  "--device", "cpu", *argv])


def _cli_call(sim, out, *argv):
    model = str(sim["tmp"] / "model_quantized.npz")
    save_params(model, sim["params"], {"model_type": "lstm"})
    return cli.main(["call_variant", "-b", sim["bam"], "-f", sim["fasta"],
                     "-m", model, "-o", str(out), "-s", "SAMPLE",
                     "-r", CONTIG, "--ont_r9_guppy5_sup", "--device", "cpu",
                     *argv])


@pytest.mark.parametrize("argv,mode", [
    (["--quantized"], "static"),
    (["--quantized", "--quantize_mode", "static_rec"], "static_rec")],
    ids=["static", "static_rec"])
def test_cli_quantized_calls_match_jax(sim, argv, mode):
    """int8 serving in float32: the JAX package's CPU fallback is its
    kernels' math there, so the call sets must be equal."""
    theirs = sim["tmp"] / f"jax_{mode}"
    jcv.call_variant(_options(JaxOptions, jax_set_parameters, sim, theirs,
                              quantized=True, quantize_mode=mode,
                              compute_dtype="float32"),
                     params=sim["params"])
    ours = sim["tmp"] / f"torch_{mode}"
    assert _cli_call(sim, ours, *argv, "--compute_dtype", "float32") == 0
    assert _records(ours, "PEPPER_VARIANT_FULL")
    _assert_same_calls(ours, theirs)


def test_cli_quantize_mode_dynamic_runs(sim):
    out = sim["tmp"] / "torch_dynamic"
    assert _cli_call(sim, out, "--quantized", "--quantize_mode",
                     "dynamic") == 0
    for name in VCFS:
        assert (out / f"{name}.vcf.gz").exists(), name
    assert _records(out, "PEPPER_VARIANT_FULL")


def test_cli_quantize_flags():
    parser = cli.build_parser()
    base = ["call_variant", "-b", "r.bam", "-f", "r.fa"]
    args = parser.parse_args(base)
    assert (args.quantized, args.quantize_mode) == (False, "static")
    args = parser.parse_args(base + ["--quantized", "--quantize_mode",
                                     "dynamic"])
    assert (args.quantized, args.quantize_mode) == (True, "dynamic")
    assert not parser.parse_args(base + ["--quantized",
                                         "--no_quantized"]).quantized
    options = cli.options_from_args(args)
    assert (options.quantized, options.quantize_mode) == (True, "dynamic")


def test_pkl_checkpoints_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        load_params(str(tmp_path / "model.pkl"))


def test_cli_version_and_backend_stat(capsys):
    assert cli.main(["version"]) == 0
    assert cli.main(["backend_stat"]) == 0
    out = capsys.readouterr().out
    assert "pepper_tpu_torch" in out and "cuda available" in out
