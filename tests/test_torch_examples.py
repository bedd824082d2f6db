"""The port's simulated example runs (pepper_tpu_torch/examples/) on the
CPU: the in-memory training arrays equal what make_images and
make_polish_train_images store, the quickstart's dry pass writes the JAX
example's records, tiny acceptance and polish runs finish above a stated
floor, and the polish scorer equals the JAX example's."""

import gzip
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from pepper_tpu_torch.examples import (acceptance_run, chr_scale_run,
                                       hp_acceptance_run, polish_scale_run,
                                       simulated_quickstart)
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.pipeline.stages import image_arrays, make_images
from pepper_tpu_torch.polish.pipeline import (make_polish_train_images,
                                              polish_train_arrays)
from pepper_tpu_torch.polish.train import load_polish_images
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.train.data import load_image_dir
from pepper_tpu_torch.utils.simulate import build_mixed_genome

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the training steps are many small ops, and the
    other test workers keep every core busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example(name, monkeypatch):
    """A JAX package example script as a module, its compilation-cache
    setup a no-op (the tests write nothing under HOME)."""
    from pepper_tpu.utils import jax_setup

    monkeypatch.setattr(jax_setup, "_done", True)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _records(vcf_path):
    with gzip.open(vcf_path, "rt") as f:
        return [line for line in f if not line.startswith("#")]


@pytest.mark.parametrize("use_hp_info", [False, True], ids=["variant", "hp"])
def test_image_arrays_equal_what_make_images_stores(tmp_path, use_hp_info):
    """12 intervals over 11 workers: worker 10's file sorts before worker
    2's, and within a worker chrA_55000_* before chrA_5000_*."""
    genome = build_mixed_genome(str(tmp_path), "g", 60_000, 120, 200, 17,
                                read_len=1500)
    options = set_parameters(PepperOptions(
        bam=genome["bam"], fasta=genome["fasta"], ont_r9_guppy5_sup=True,
        sub_command="make_train_images", train_mode=True,
        truth_vcf=genome["truth"], region_bed=genome["bed"],
        random_draw_probability=1.0, region="chrA", threads=11,
        region_size=5000, use_hp_info=use_hp_info))
    make_images(options, str(tmp_path / "images"))
    stored = load_image_dir(str(tmp_path / "images"))
    ours = image_arrays(options)
    assert len(stored[0]) > 100
    assert ours[0].shape[1:] == ((21, 48) if use_hp_info else (33, 26))
    for got, expected in zip(ours, stored):
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)
    assert set(np.unique(ours[1])) == {0, 1, 2}


def test_polish_train_arrays_equal_what_the_store_holds(tmp_path):
    scene = polish_scale_run.build_polish_scene(str(tmp_path), "s", 12_000,
                                                seed=3)
    options = PepperOptions(bam=scene["bam"], fasta=scene["fasta"])
    make_polish_train_images(options, scene["truth_bam"],
                             str(tmp_path / "pimgs"))
    stored = load_polish_images(str(tmp_path / "pimgs"))
    ours = polish_train_arrays(options, scene["truth_bam"])
    assert len(stored[0]) > 10
    for got, expected in zip(ours, stored):
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


def test_quickstart_dry_pass_recovers_the_truth_as_jax(tmp_path,
                                                       monkeypatch):
    jax_quickstart = _jax_example("simulated_quickstart", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["quickstart", str(tmp_path / "jax")])
    jax_quickstart.main()
    result = simulated_quickstart.run(str(tmp_path / "port"), device="cpu",
                                      epochs=20)
    name = "PEPPER_VARIANT_FULL.vcf.gz"
    ours = _records(tmp_path / "port" / "calls_dry" / name)
    assert ours == _records(tmp_path / "jax" / "calls_dry" / name)
    dry = result["dry"]["scores"]["ALL"]
    assert dry["n"] == 10 and dry["tp"] == 10 and dry["fp"] == 0
    assert dry["gt_ok"] == 10
    # the model trained on the second genome finds every variant
    trained = result["trained"]["scores"]["ALL"]
    assert trained["tp"] == 10 and trained["fp"] == 0


def test_tiny_acceptance_run_scores_above_its_floor(tmp_path, capsys):
    result = acceptance_run.run(0.05, 1, "uniform", device="cpu",
                                train_mb=0.1, epochs=10,
                                base=str(tmp_path))
    err = capsys.readouterr().err
    assert ("INFO: TYPE    N      RECALL   PRECISION  GT-CONCORDANCE  "
            "(TP/FP/FN)") in err
    for kind in ("SNP", "INS", "DEL", "ALL"):
        assert f"INFO: {kind:<6} {result['stats'][kind]['n']:<6} " in err
    # floor: this CPU run reads recall 35/35, precision 35/36 (8 epochs:
    # recall 33/35, precision 1.0)
    assert result["stats"]["ALL"]["n"] == 35
    assert result["stats"]["ALL"]["recall"] >= 0.9
    assert result["stats"]["ALL"]["precision"] >= 0.95
    assert result["train_accuracy"] >= 90.0


def test_tiny_polish_scale_run_improves_the_draft(tmp_path, capsys):
    result = polish_scale_run.run(0.01, 1, "ont", False, device="cpu",
                                  train_mb=0.01, epochs=1,
                                  base=str(tmp_path))
    err = capsys.readouterr().err
    polished, draft = result["polished"], result["draft"]
    assert (f"POLISHED: {polished['errors']:,} errors / "
            f"{polished['bases']:,} bases (identity "
            f"{polished['identity']:.6f}, QV {polished['qv']:.1f})") in err
    assert "POLISH WALL: " in err
    # floor: the draft's ~41 errors in 10 kb at least 30% fewer (the CPU
    # run: 41 -> 20)
    assert draft["errors"] > 20
    assert polished["errors"] <= 0.7 * draft["errors"]
    assert polished["qv"] > draft["qv"]


@pytest.mark.parametrize("error_model", ["ont", "uniform"])
def test_build_polish_scene_writes_the_jax_files(tmp_path, monkeypatch,
                                                 error_model):
    """The polish scene from the same seed: the reads, truth and draft
    files byte for byte, and the same draft and true sequences."""
    jax_polish = _jax_example("polish_scale_run", monkeypatch)
    scenes = []
    for side, module in (("jax", jax_polish), ("port", polish_scale_run)):
        base = tmp_path / side
        base.mkdir()
        scenes.append(module.build_polish_scene(str(base), "t", 12_000, 31,
                                                error_model=error_model))
    theirs, ours = scenes
    for key in ("bam", "truth_bam", "fasta"):
        assert (pathlib.Path(ours[key]).read_bytes()
                == pathlib.Path(theirs[key]).read_bytes()), key
    assert ours["draft"] == theirs["draft"]
    assert ours["truth"] == theirs["truth"] != ours["draft"]


def test_chunked_error_count_and_qv_equal_jax(monkeypatch):
    jax_polish = _jax_example("polish_scale_run", monkeypatch)
    rng = np.random.RandomState(11)
    truth = "".join("ACGT"[i] for i in rng.randint(0, 4, 9000))
    other = list(truth)
    for pos in sorted(rng.choice(8900, 40, replace=False), reverse=True):
        kind = pos % 3
        if kind == 0:
            other[pos] = "ACGT"[("ACGT".index(other[pos]) + 1) % 4]
        elif kind == 1:
            other.insert(pos, "T")
        else:
            del other[pos]
    other = "".join(other)
    for a, b in ((truth, other), (truth, truth), (truth, other[:6000]),
                 (truth, "")):
        ours = polish_scale_run.chunked_error_count(a, b)
        assert ours == jax_polish.chunked_error_count(a, b)
    assert polish_scale_run.chunked_error_count(truth, truth)[0] == 0
    assert 30 <= polish_scale_run.chunked_error_count(truth, other)[0] <= 50
    for errors, total in ((0, 1000), (41, 9995), (7, 0), (3, 1_000_000)):
        assert polish_scale_run.qv(errors, total) == jax_polish.qv(errors,
                                                                   total)


@pytest.mark.parametrize("module,argv,expected", [
    (acceptance_run, ["1.5", "3", "ont", "--device", "cpu"],
     ((1.5, 3, "ont"), {"device": "cpu"})),
    (acceptance_run, [], ((2.0, None, "uniform"), {"device": None})),
    (chr_scale_run, ["20", "2", "ont", "20"],
     ((20.0, 2, "ont", 20.0), {"device": None})),
    (chr_scale_run, ["--device", "cpu"],
     ((20.0, None, "uniform", 36.0), {"device": "cpu"})),
    (hp_acceptance_run, ["2", "4", "ont_str", "30", "--device", "cpu"],
     ((2.0, 4, "ont_str", 30.0), {"device": "cpu"})),
    (hp_acceptance_run, [], ((2.0, None, "uniform", 36.0),
                             {"device": None})),
    (polish_scale_run, ["2", "8", "ont", "static"],
     ((2.0, 8, "ont", True), {"device": None})),
    (polish_scale_run, ["--device", "cpu"],
     ((10.0, None, "ont", False), {"device": "cpu"})),
], ids=["acceptance", "acceptance-defaults", "chr", "chr-defaults", "hp",
        "hp-defaults", "polish", "polish-defaults"])
def test_main_reads_the_jax_arguments_in_order(module, argv, expected,
                                               monkeypatch):
    """Each main takes the JAX script's positional arguments, in its order
    and with its defaults (threads: the host's cores), plus --device."""
    seen = []
    monkeypatch.setattr(module, "run", lambda *a, **k: seen.append((a, k)))
    monkeypatch.setattr("os.cpu_count", lambda: None)
    module.main(argv)
    args, kwargs = expected
    cores = {acceptance_run: 8, chr_scale_run: 8, hp_acceptance_run: 8,
             polish_scale_run: 4}[module]
    assert seen == [(tuple(cores if a is None else a for a in args),
                     kwargs)]
