"""The port's staged subcommands (pipeline/stages.py; polish/pipeline.py's
make_polish_images, call_consensus and perform_stitch) against the
one-process runs and the JAX package's stages, on the CPU.

Bars: the staged variant chain make_images -> run_inference ->
find_candidates writes the records of the port's one-process
call_variant (float32: the staged runner's dtype, as the JAX package's)
and of the JAX package's staged chain, record for record in float32 and
--dry, the same call set up to the ALT order in static int8 (the
transducer's bars, tests/test_torch_call_variant.py); the staged polish
chain writes the bytes of the JAX package's polish().  The polish cases
run the model where the consensus is under test and --dry where the files
are.
"""

import gzip

import jax
import numpy as np
import pytest

from pepper_tpu.io.bam_writer import write_bam, write_fasta
from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.pipeline import stages as jstages
from pepper_tpu.polish import pipeline as jpipeline
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.cli import main as cli
from pepper_tpu_torch.cli import polish_main
from pepper_tpu_torch.models.checkpoint import save_params
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.pipeline import call_variant as cv
from pepper_tpu_torch.pipeline import stages
from pepper_tpu_torch.polish import pipeline
from pepper_tpu_torch.presets import set_parameters

from simulate import random_reference, simulate_reads
from test_torch_hp import hp_sim  # noqa: F401
from test_torch_polish import (_jax_fasta, one_intra_op_thread,  # noqa: F401
                               polish_sim)

CONTIG = "chr20"
VCFS = ("PEPPER_VARIANT_FULL", "PEPPER_VARIANT_OUTPUT_PEPPER",
        "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """test_torch_call_variant's scene: 3 kb, seed 11, a het and a hom
    SNP, an insertion and a deletion; a seeded H=32 transducer."""
    tmp = tmp_path_factory.mktemp("torch_stages")
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
    model = str(tmp / "model.npz")
    save_params(model, params, {"model_type": "lstm"})
    return dict(bam=bam, fasta=fasta, tmp=tmp, params=params, model=model)


def _options(cls, preset, sim, out_dir, **overrides):
    options = cls(bam=sim["bam"], fasta=sim["fasta"],
                  output_dir=str(out_dir), threads=1, sample_name="SAMPLE",
                  ont_r9_guppy5_sup=True, region=CONTIG, region_size=1000,
                  batch_size=64)
    for key, value in overrides.items():
        setattr(options, key, value)
    return preset(options)


def _records(out_dir, name="PEPPER_VARIANT_FULL"):
    rows = []
    with gzip.open(f"{out_dir}/{name}.vcf.gz", "rt") as f:
        for line in f:
            if not line.startswith("#"):
                fields = line.rstrip("\n").split("\t")
                sample = dict(zip(fields[8].split(":"), fields[9].split(":")))
                rows.append((fields[0], int(fields[1]), fields[3], fields[4],
                             sample["GT"], fields[6]))
    return rows


def _call_set(rows):
    """The calls up to the ALT order within a site."""
    calls = set()
    for contig, pos, ref, alt, gt, _ in rows:
        alleles = [ref] + alt.split(",")
        calls.add((contig, pos, ref, tuple(sorted(alleles[1:])),
                   tuple(sorted(alleles[int(i)] for i in
                                gt.replace("|", "/").split("/")
                                if i != "."))))
    return calls


MODES = {"float32": {}, "dry": {"dry": True},
         "static": {"quantized": True, "quantize_mode": "static"}}


def _staged(module, cls, preset, sim, base, threads, mode, **kwargs):
    """make_images -> run_inference -> find_candidates through `module`'s
    stage functions; returns the VCF directory."""
    def options(out):
        return _options(cls, preset, sim, out, threads=threads,
                        **MODES[mode])

    images, predictions, out = (base / d for d in ("images", "predictions",
                                                    "vcf"))
    module.make_images(options(images), str(images))
    module.run_inference(options(predictions), str(images), str(predictions),
                         params=None if mode == "dry" else sim["params"],
                         **kwargs)
    module.process_candidates(options(out), str(predictions), str(out))
    return out


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_staged_variant_run_matches_one_process_and_jax(sim, mode, threads):
    base = sim["tmp"] / f"{mode}_{threads}"
    ours = _staged(stages, PepperOptions, set_parameters, sim, base / "port",
                   threads, mode, device="cpu")
    theirs = _staged(jstages, JaxOptions, jax_set_parameters, sim,
                     base / "jax", threads, mode)
    one = base / "one_process"
    cv.call_variant(_options(PepperOptions, set_parameters, sim, one,
                             threads=threads, **MODES[mode]),
                    params=None if mode == "dry" else sim["params"],
                    device="cpu")
    # --dry outside train mode classifies every window hom-ref
    assert bool(_records(ours)) == (mode != "dry")
    for name in VCFS:
        if mode == "static":
            assert _call_set(_records(ours, name)) == _call_set(
                _records(theirs, name)) == _call_set(_records(one, name))
        else:
            assert _records(ours, name) == _records(theirs, name), name
            assert _records(ours, name) == _records(one, name), name


def test_staged_hp_run_matches_jax(hp_sim, tmp_path):
    """--use_hp_info through the stages: HP images (48x21) from HP-tagged
    reads, the HP transducer in run_inference, the JAX package's
    records."""
    sim = hp_sim

    def run(module, cls, preset, base, **kwargs):
        def options(out):
            return preset(cls(bam=sim["bam"], fasta=sim["fasta"],
                              output_dir=str(out), threads=1,
                              ont_r9_guppy5_sup=True, use_hp_info=True,
                              region="chrH", batch_size=16))
        images, predictions, out = (base / d for d in
                                    ("images", "predictions", "vcf"))
        module.make_images(options(images), str(images))
        module.run_inference(options(predictions), str(images),
                             str(predictions), params=sim["params"],
                             **kwargs)
        module.process_candidates(options(out), str(predictions), str(out))
        return out

    ours = run(stages, PepperOptions, set_parameters, tmp_path / "port",
               device="cpu")
    theirs = run(jstages, JaxOptions, jax_set_parameters, tmp_path / "jax")
    assert _records(ours)
    for name in VCFS:
        assert _records(ours, name) == _records(theirs, name), name


def test_staged_variant_cli_chain_matches_one_process(sim):
    """The three subcommands through the CLI, -t 2, write the records of
    the one-process CLI run in float32."""
    base = sim["tmp"] / "cli_chain"
    common = ["-f", sim["fasta"], "-s", "SAMPLE", "-t", "2",
              "--ont_r9_guppy5_sup"]
    region = ["-b", sim["bam"], "-r", CONTIG, "--region_size", "1000"]
    assert cli.main(["make_images", *region, *common,
                     "-o", str(base / "images")]) == 0
    assert cli.main(["run_inference", "-i", str(base / "images"),
                     "-o", str(base / "predictions"), "-m", sim["model"],
                     "-t", "2", "--batch_size", "64",
                     "--device", "cpu"]) == 0
    assert cli.main(["find_candidates", "-i", str(base / "predictions"),
                     "-o", str(base / "vcf"), *common]) == 0
    assert cli.main(["call_variant", *region, *common, "-m", sim["model"],
                     "-o", str(base / "one"), "--compute_dtype", "float32",
                     "--device", "cpu"]) == 0
    assert _records(base / "vcf")
    for name in VCFS:
        assert _records(base / "vcf", name) == _records(base / "one", name)


@pytest.mark.parametrize("mode,threads", [("dry", 1), ("dry", 2),
                                          ("dry", 3), ("float", 3)])
def test_staged_polish_matches_jax_polish_bytes(polish_sim, mode,
                                                threads):
    """make_polish_images -> call_consensus -> perform_stitch as library
    calls: the bytes of the JAX package's polish(); every image file is a
    worker's, read in file-name order (the worker count matters to the
    files alone, so it varies under --dry)."""
    base = polish_sim["tmp"] / f"staged_lib_{mode}_{threads}"
    options = PepperOptions(
        bam=polish_sim["bam"], fasta=polish_sim["fasta"],
        output_dir=str(base), threads=threads, dry=mode == "dry",
        batch_size=8, quantized=mode == "quantized")
    files = pipeline.make_polish_images(options, str(base / "images"))
    assert len(files if isinstance(files, list) else [files]) == threads
    pipeline.call_consensus(options, str(base / "images"),
                            str(base / "predictions"),
                            None if mode == "dry" else polish_sim["params"],
                            device="cpu")
    path = pipeline.perform_stitch(str(base / "predictions"),
                                   str(base / "consensus"))
    with open(path, "rb") as f:
        assert f.read() == _jax_fasta(polish_sim, mode)


def test_staged_polish_files_read_in_the_jax_stages(polish_sim):
    """The port's image files through the JAX package's call_consensus,
    and its prediction files through the JAX package's perform_stitch
    (--dry: the files, not the model, are under test)."""
    base = polish_sim["tmp"] / "staged_cross"
    options = PepperOptions(bam=polish_sim["bam"], fasta=polish_sim["fasta"],
                            threads=2, batch_size=8, dry=True)
    pipeline.make_polish_images(options, str(base / "images"))
    jpipeline.call_consensus(JaxOptions(batch_size=8, dry=True),
                             str(base / "images"),
                             str(base / "jax_predictions"), None)
    pipeline.call_consensus(options, str(base / "images"),
                            str(base / "predictions"), None, device="cpu")
    for predictions in ("jax_predictions", "predictions"):
        path = jpipeline.perform_stitch(str(base / predictions),
                                        str(base / f"{predictions}_fa"))
        with open(path, "rb") as f:
            assert f.read() == _jax_fasta(polish_sim, "dry"), predictions


def test_staged_polish_cli_chain_matches_polish(polish_sim):
    """The three polish subcommands through the CLI, -t 2, with the
    model."""
    base = polish_sim["tmp"] / "staged_cli_chain"
    common = ["-b", polish_sim["bam"], "-f", polish_sim["fasta"], "-t", "2",
              "--batch_size", "8"]
    assert polish_main.main(["make_images", *common,
                             "-o", str(base / "images")]) == 0
    assert polish_main.main(["call_consensus", *common,
                             "-i", str(base / "images"),
                             "-o", str(base / "predictions"),
                             "-m", polish_sim["model"], "--num_devices", "-1",
                             "--device", "cpu"]) == 0
    assert polish_main.main(["stitch", "-i", str(base / "predictions"),
                             "-o", str(base / "out/")]) == 0
    with open(base / "out" / "consensus_pepper_polished.fa", "rb") as f:
        assert f.read() == _jax_fasta(polish_sim, "float")
