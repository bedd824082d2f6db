"""The port's call_variant on the CPU against the JAX package's on the
test_e2e scene (3 kb, seed 11), same weights through params_from_jax.

The bar is the call set: the (pos, REF, ALT, GT, FILTER) records of all
three VCFs must be equal.  QUAL is left out because it is printed from
float32 probabilities that the two frameworks sum in different orders.
"""

import gzip
import os

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

from simulate import random_reference, simulate_reads, write_truth_vcf
from test_torch_polish import one_intra_op_thread  # noqa: F401

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
    truth, bed = str(tmp / "truth.vcf"), str(tmp / "truth.bed")
    write_truth_vcf(truth, CONTIG, len(ref), [
        (*het_snp, "1|0"), (*hom_snp, "1|1"), (*het_ins, "1|0"),
        (*het_del, "1|0")])
    with open(bed, "w") as f:
        f.write(f"{CONTIG}\t0\t{len(ref)}\n")
    return dict(bam=bam, fasta=fasta, tmp=tmp, params=params, truth=truth,
                bed=bed)


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


def mode_params(override):
    """Seeded JAX params at the small width for a mode's classifier: the
    no_cnn family, or the HP transducer (48 features, 21 columns)."""
    if override.get("model_type") == "no_cnn":
        from pepper_tpu.models.alternates import (NoCnnConfig,
                                                  init_no_cnn_params)

        tree = init_no_cnn_params(jax.random.PRNGKey(5),
                                  NoCnnConfig(hidden=32))
    else:
        tree = init_transducer_params(jax.random.PRNGKey(5), TransducerConfig(
            image_features=48, window=21, hidden=32, linear_size=64))
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("override,item", [
    ({"model_type": "no_cnn"}, "item 6"),
    ({"num_devices": 2}, "item 7"),
    ({"use_hp_info": True}, "item 9"),
])
def test_unported_options_raise(sim, override, item):
    """Options the port refused until their ROADMAP item was ported, each
    now run and writing the JAX package's records: --model_type no_cnn
    (item 6), --use_hp_info (item 9) and --num_devices 2 (item 7: on the
    CPU it resolves to one device, as JAX on one CPU device; over the
    explicit list [cpu, cpu] the batches split in two)."""
    options = _options(PepperOptions, set_parameters, sim,
                       sim["tmp"] / f"ported_{item}", **override)
    if item == "item 7":
        totals = cv.call_variant(options, params=sim["params"], device="cpu")
        assert options.num_devices == 1
        two = _options(PepperOptions, set_parameters, sim,
                       sim["tmp"] / "ported_item_7_list", **override)
        assert cv.call_variant(two, params=sim["params"],
                               devices=["cpu", "cpu"]) == totals
        assert two.num_devices == 2
        theirs = sim["tmp"] / "jax_item_7"
        jax_totals = jcv.call_variant(_options(
            JaxOptions, jax_set_parameters, sim, theirs, num_devices=1),
            params=sim["params"])
        assert totals == jax_totals and totals[0] > 0
        _assert_same_calls(options.output_dir, theirs)
        _assert_same_calls(two.output_dir, theirs)
        return
    params = mode_params(override)
    totals = cv.call_variant(options, params=params, device="cpu")
    theirs = sim["tmp"] / f"jax_{item}"
    jax_totals = jcv.call_variant(_options(JaxOptions, jax_set_parameters,
                                           sim, theirs, **override),
                                  params=params)
    assert totals == jax_totals and totals[0] > 0
    _assert_same_calls(options.output_dir, theirs)


def test_num_devices_all_resolves_to_one(sim):
    """-1 resolves against the device's local count: 1 on the CPU."""
    options = _options(PepperOptions, set_parameters, sim, sim["tmp"],
                       num_devices=-1)
    cv.resolve_num_devices(options, "cpu")
    assert options.num_devices == 1


@pytest.mark.parametrize("argv,error", [
    (["--sharded"], NotImplementedError),
    (["--use_hp_info"], NotImplementedError),
    (["--num_devices", "2"], NotImplementedError),
    # an unknown int8 mode is not accepted (argparse exits)
    (["--quantized", "--quantize_mode", "int4"], SystemExit),
])
def test_cli_unported_flags_raise(sim, jax_model_run, argv, error):
    """Flags the CLI refuses; --use_hp_info, refused until item 9 was
    ported, now serves an HP checkpoint and writes the JAX package's
    records, and --sharded and --num_devices 2, refused until item 7 was,
    write the records of the JAX package's float32 call_variant (the
    sharded path through its HDF5 predictions and manifest)."""
    model = str(sim["tmp"] / "model_flags.npz")
    if argv[0] in ("--sharded", "--num_devices"):
        save_params(model, sim["params"])
        out = sim["tmp"] / f"cli_{argv[0][2:]}"
        assert cli.main(["call_variant", "-b", sim["bam"], "-f",
                         sim["fasta"], "-m", model, "-o", str(out), "-s",
                         "SAMPLE", "-r", CONTIG, "--ont_r9_guppy5_sup",
                         "--compute_dtype", "float32", "--device", "cpu",
                         *argv]) == 0
        assert _records(out, "PEPPER_VARIANT_FULL")
        _assert_same_calls(out, jax_model_run)
        if argv == ["--sharded"]:
            assert os.listdir(out / "predictions") == [
                "pepper_prediction_0.hdf"]
        return
    if argv == ["--use_hp_info"]:
        params = mode_params({"use_hp_info": True})
        save_params(model, params, {"model_type": "lstm"})
        out, theirs = sim["tmp"] / "cli_hp", sim["tmp"] / "jax_cli_hp"
        assert cli.main(["call_variant", "-b", sim["bam"], "-f",
                         sim["fasta"], "-m", model, "-o", str(out), "-s",
                         "SAMPLE", "-r", CONTIG, "--ont_r9_guppy5_sup",
                         "--compute_dtype", "float32", "--device", "cpu",
                         *argv]) == 0
        jcv.call_variant(_options(JaxOptions, jax_set_parameters, sim,
                                  theirs, use_hp_info=True), params=params)
        assert _records(out, "PEPPER_VARIANT_FULL")
        _assert_same_calls(out, theirs)
        return
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
    """Refused until item 13 was ported: a reference .pkl now loads as the
    JAX package loads it, bit for bit."""
    from pepper_tpu.models.checkpoint import load_params as j_load_params
    from test_torch_checkpoint_pkl import (assert_trees_equal,
                                           transducer_state_dict,
                                           write_checkpoint)

    path = write_checkpoint(tmp_path / "model.pkl", transducer_state_dict(1))
    params, meta = load_params(path)
    j_params, j_meta = j_load_params(path)
    assert_trees_equal(params, j_params)
    assert meta == j_meta


def _cli_stage_matches_jax(sim, jax_model_run, stage):
    """make_images -> run_inference -> find_candidates with `stage` through
    the port's CLI and the other two through the JAX package's stages."""
    from pepper_tpu.pipeline import stages as jstages

    base = sim["tmp"] / f"cli_stage_{stage}"
    images, predictions, out = (str(base / d) for d in
                                ("images", "predictions", "vcf"))
    model = str(sim["tmp"] / "model_stage.npz")
    save_params(model, sim["params"], {"model_type": "lstm"})

    def joptions():
        return _options(JaxOptions, jax_set_parameters, sim, out)

    common = ["-f", sim["fasta"], "-s", "SAMPLE", "--ont_r9_guppy5_sup"]
    if stage == "make_images":
        assert cli.main(["make_images", "-b", sim["bam"], "-r", CONTIG,
                         "-o", images, *common]) == 0
    else:
        jstages.make_images(joptions(), images)
    if stage == "run_inference":
        assert cli.main(["run_inference", "-i", images, "-o", predictions,
                         "-m", model, "--device", "cpu"]) == 0
    else:
        jstages.run_inference(joptions(), images, predictions,
                              params=sim["params"])
    if stage == "find_candidates":
        assert cli.main(["find_candidates", "-i", predictions, "-o", out,
                         *common]) == 0
    else:
        jstages.process_candidates(joptions(), predictions, out)
    assert _records(out, "PEPPER_VARIANT_FULL")
    _assert_same_calls(out, jax_model_run)


def _cli_train_matches_jax(sim, sub_command, capsys):
    """A training subcommand through the port's CLI on the CPU:
    make_train_images writes JAX's train images; train_model (1 epoch,
    the CLI's full width) writes an .npz both packages load, with JAX's
    metadata; test_model prints the JAX package's confusion matrix of the
    same model and images; run_hyperband (--max_iter 2 --eta 2) finds a
    best checkpoint."""
    from pepper_tpu.models.checkpoint import load_params as jax_load_params
    from pepper_tpu.pipeline import stages as jstages
    from pepper_tpu.train import trainer as jtrainer
    from pepper_tpu.train.data import load_image_dir

    base = sim["tmp"] / f"cli_{sub_command}"
    images, out = str(base / "images"), str(base / "out")
    truth = ["--truth_vcf", sim["truth"], "--region_bed", sim["bed"],
             "--random_draw_probability", "1.0"]
    joptions = _options(JaxOptions, jax_set_parameters, sim, images,
                        sub_command="make_train_images", train_mode=True,
                        truth_vcf=sim["truth"], region_bed=sim["bed"],
                        random_draw_probability=1.0)
    if sub_command == "make_train_images":
        assert cli.main(["make_train_images", "-b", sim["bam"], "-f",
                         sim["fasta"], "-o", images, "-r", CONTIG,
                         "--ont_r9_guppy5_sup", *truth]) == 0
        theirs = str(base / "jax_images")
        jstages.make_images(joptions, theirs)
        ours, expected = load_image_dir(images), load_image_dir(theirs)
        assert len(ours[0]) > 0 and set(ours[1]) >= {1, 2}
        for a, b in zip(ours, expected):
            np.testing.assert_array_equal(a, b)
        return
    jstages.make_images(joptions, images)
    if sub_command == "train_model":
        assert cli.main(["train_model", "-i", images, "-o", out,
                         "--epochs", "1", "--batch_size", "16",
                         "--device", "cpu"]) == 0
        params, meta = load_params(os.path.join(out,
                                                "pepper_model_final.npz"))
        j_params, j_meta = jax_load_params(
            os.path.join(out, "pepper_model_final.npz"))
        assert meta == j_meta and meta["model_type"] == "lstm"
        assert meta["hidden_size"] == 256 and meta["epochs"] == 1
        assert params["linear_1"]["w"].shape == (33 * 512, 512)
        return
    if sub_command == "test_model":
        model = str(base / "model.npz")
        save_params(model, sim["params"], {"model_type": "lstm"})
        capsys.readouterr()
        assert cli.main(["test_model", "-i", images, "-m", model,
                         "--batch_size", "16", "--device", "cpu"]) == 0
        printed = capsys.readouterr().err
        _, confusion, accuracy = jtrainer.test_model(
            JaxOptions(batch_size=16, model_path=model), images)
        assert f"ACCURACY: {accuracy:.4f}" in printed
        assert f"CONFUSION MATRIX:\n{confusion}" in printed
        return
    assert cli.main(["run_hyperband", "-i", images, "-o", out,
                     "--max_iter", "2", "--eta", "2", "--batch_size", "16",
                     "--device", "cpu"]) == 0
    assert any(f.endswith("_best.npz") for f in os.listdir(out))


def _cli_merge_matches_jax(sim, jax_model_run):
    """merge_variants through the CLI on the JAX run's PEPPER VCF and a
    DeepVariant-style VCF of half its records with other ALTs: the bytes
    of the JAX package's merge."""
    from pepper_tpu.decode.merge_variants import merge_vcf_records

    pepper = str(jax_model_run / "PEPPER_VARIANT_FULL.vcf.gz")
    dv = str(sim["tmp"] / "dv.vcf")
    with gzip.open(pepper, "rt") as f:
        lines = f.read().splitlines()
    header = [line for line in lines if line.startswith("#")]
    body = [line.split("\t") for line in lines if not line.startswith("#")]
    assert body
    with open(dv, "w") as out:
        out.write("\n".join(header) + "\n")
        for fields in body[::2]:
            out.write("\t".join(fields[:4] + ["TT"] + fields[5:]) + "\n")
    ours, theirs = sim["tmp"] / "merge_ours", sim["tmp"] / "merge_theirs"
    assert cli.main(["merge_variants", "-vp", pepper, "-vd", dv, "-o",
                     str(ours)]) == 0

    class Args:
        vcf_pepper, vcf_deepvariant = pepper, dv
        vcf_deepvariant_snps = vcf_deepvariant_indels = None
        output_dir = str(theirs)

    merge_vcf_records(Args())
    name = "PEPPER_MARGIN_DEEPVARIANT_OUTPUT.vcf.gz"
    for suffix in ("", ".tbi"):
        assert (ours / (name + suffix)).read_bytes() == \
            (theirs / (name + suffix)).read_bytes()
    with gzip.open(ours / name, "rt") as f:
        assert sum(line.rstrip().endswith(":DV") for line in f) == len(
            body[::2])


@pytest.mark.parametrize("sub_command,item", [
    ("make_images", "item 14"), ("run_inference", "item 14"),
    ("find_candidates", "item 14"), ("merge_variants", "item 16"),
    ("make_train_images", "item 11"), ("train_model", "item 11"),
    ("test_model", "item 11"), ("run_hyperband", "item 11"),
    ("download_models", "item 12")])
def test_cli_unported_subcommands_raise(sim, jax_model_run, sub_command,
                                        item, capsys, tmp_path):
    """The JAX CLI's other subcommands, each ported since it first raised
    naming its item, serve: each staged one (item 14) runs its stage
    through the CLI beside the JAX package's other stages, and the chain
    writes the JAX package's float32 call_variant records; merge_variants
    (item 16) writes the JAX merge's bytes; each training one (item 11)
    runs on the CPU against the JAX package's output on the same images
    (_cli_train_matches_jax); download_models (item 12) fetches the JAX
    CLI's files from a file:// mirror and fails as it does offline."""
    if item == "item 12":
        _cli_download_matches_jax(tmp_path, capsys)
        return
    if item == "item 16":
        _cli_merge_matches_jax(sim, jax_model_run)
        return
    if item == "item 14":
        _cli_stage_matches_jax(sim, jax_model_run, sub_command)
        return
    if item == "item 11":
        _cli_train_matches_jax(sim, sub_command, capsys)
        return
    raise AssertionError(f"no case for {sub_command} ({item})")


def _cli_download_matches_jax(tmp_path, capsys):
    from pepper_tpu.cli.main import main as jax_main

    from test_download_models import _make_mirror

    url = _make_mirror(tmp_path)
    printed = {}
    for name, main in (("port", cli.main), ("jax", jax_main)):
        capsys.readouterr()
        assert main(["download_models", "-o", str(tmp_path / name),
                     "--description_url", url]) == 0
        printed[name] = capsys.readouterr().out
        assert main(["download_models", "-o", str(tmp_path / "offline"),
                     "--description_url",
                     f"file://{tmp_path}/does_not_exist.csv"]) == 1
    assert "2 model(s)" in printed["port"] and "2 model(s)" in printed["jax"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == [
        "PEPPER_POLISH.pkl", "PEPPER_VARIANT_ONT.pkl"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert "download_models" in cli.build_parser().format_help()


def test_cli_version_and_backend_stat(capsys):
    assert cli.main(["version"]) == 0
    assert cli.main(["backend_stat"]) == 0
    out = capsys.readouterr().out
    assert "pepper_tpu_torch" in out and "cuda available" in out
