"""The port's variant-side training (pepper_tpu_torch/train/, the
summarizer's train mode) against the JAX package's, on the CPU.

  * train images: the train-mode windows of tests/test_cli_and_train.py's
    scene are record-equal to JAX's, with random_draw_probability 1.0 and
    0.33 under one np.random.seed, and the port's store reads back through
    JAX's load_image_dir with JAX's arrays; the HP twin of
    tests/test_hp_training.py;
  * train_model lowers the loss, its .npz loads in both packages and
    gives JAX's InferenceRunner probabilities within 2e-4, test_model
    gives JAX's confusion on it, --retrain_model_path resumes and refuses
    another family; the families train and infer;
  * Hyperband equals JAX's; the resume state round-trips.

Small widths (hidden 16-32, linear 32-64) and few steps.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from pepper_tpu.infer.runner import InferenceRunner as JaxRunner
from pepper_tpu.io.bam import BamReader as JaxBamReader
from pepper_tpu.io.bam_writer import write_bam, write_fasta
from pepper_tpu.io.fasta import FastaReader as JaxFastaReader
from pepper_tpu.models.checkpoint import load_params as jax_load_params
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.pipeline import stages as jstages
from pepper_tpu.pipeline.regions import \
    get_chromosome_list as jax_chromosome_list
from pepper_tpu.pipeline.summarizer import \
    create_region_summary as jax_region_summary
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu.train import hyperband as jhyperband
from pepper_tpu.train import trainer as jtrainer
from pepper_tpu.train.data import load_image_dir as jax_load_image_dir
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.models.checkpoint import load_params
from pepper_tpu_torch.models.transducer import TransducerConfig
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.pipeline import stages
from pepper_tpu_torch.pipeline.regions import get_chromosome_list
from pepper_tpu_torch.pipeline.summarizer import create_region_summary
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.train import hyperband, resume, step, trainer
from pepper_tpu_torch.train.data import load_image_dir

from simulate import random_reference, simulate_reads, write_truth_vcf
from test_torch_polish import one_intra_op_thread  # noqa: F401

CONTIG = "chr20"
SMALL = dict(hidden=32, linear_size=64)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """tests/test_cli_and_train.py's scene."""
    tmp = tmp_path_factory.mktemp("torch_train")
    ref = random_reference(3000, seed=13)

    def alt_base(pos):
        return {"A": "T", "T": "A", "C": "G", "G": "C"}[ref[pos]]

    het_snp = (600, ref[600], alt_base(600))
    hom_snp = (900, ref[900], alt_base(900))
    records = simulate_reads(ref, [[het_snp, hom_snp], [hom_snp]],
                             read_len=300, stride=20)
    paths = {name: str(tmp / name) for name in
             ("sim.bam", "ref.fa", "truth.vcf", "truth.bed")}
    write_bam(paths["sim.bam"], [(CONTIG, len(ref))], records)
    write_fasta(paths["ref.fa"], {CONTIG: ref})
    write_truth_vcf(paths["truth.vcf"], CONTIG, len(ref), [
        (het_snp[0], het_snp[1], het_snp[2], "1|0"),
        (hom_snp[0], hom_snp[1], hom_snp[2], "1|1")])
    with open(paths["truth.bed"], "w") as f:
        f.write(f"{CONTIG}\t0\t{len(ref)}\n")
    return dict(tmp=tmp, bam=paths["sim.bam"], fasta=paths["ref.fa"],
                truth=paths["truth.vcf"], bed=paths["truth.bed"],
                region=CONTIG)


def train_options(cls, preset, scene, draw, **overrides):
    options = cls(bam=scene["bam"], fasta=scene["fasta"],
                  ont_r9_guppy5_sup=True, sub_command="make_train_images",
                  train_mode=True, truth_vcf=scene["truth"],
                  region_bed=scene["bed"], random_draw_probability=draw,
                  region=scene["region"], threads=1, **overrides)
    return preset(options)


def window_records(windows):
    return [(w.contig, w.position, w.depth, list(w.candidates),
             list(w.candidate_frequency), w.image.tobytes(), w.base_label,
             w.type_label) for w in windows]


def assert_train_images_match(scene, tmp, draw, name, **overrides):
    """Record-equal windows and store arrays, each package under the same
    np.random.seed."""
    options = train_options(PepperOptions, set_parameters, scene, draw,
                            **overrides)
    j_options = train_options(JaxOptions, jax_set_parameters, scene, draw,
                              **overrides)
    chr_list, bed_list = get_chromosome_list(
        options.region, FastaReader(scene["fasta"]), BamReader(scene["bam"]),
        options.region_bed)
    j_chr_list, j_bed_list = jax_chromosome_list(
        options.region, JaxFastaReader(scene["fasta"]),
        JaxBamReader(scene["bam"]), options.region_bed)
    assert chr_list == j_chr_list and bed_list == j_bed_list
    length = FastaReader(scene["fasta"]).get_chromosome_sequence_length(
        scene["region"])
    np.random.seed(17)
    ours = create_region_summary(options, BamReader(scene["bam"]),
                                 FastaReader(scene["fasta"]),
                                 scene["region"], 0, length - 1, bed_list)
    np.random.seed(17)
    theirs = jax_region_summary(j_options, JaxBamReader(scene["bam"]),
                                JaxFastaReader(scene["fasta"]),
                                scene["region"], 0, length - 1, j_bed_list)
    assert window_records(ours) == window_records(theirs)
    labels = {w.type_label for w in ours}

    np.random.seed(23)
    stages.make_images(options, str(tmp / f"{name}_ours"))
    np.random.seed(23)
    jstages.make_images(j_options, str(tmp / f"{name}_theirs"))
    theirs = jax_load_image_dir(str(tmp / f"{name}_theirs"))
    for arrays in (jax_load_image_dir(str(tmp / f"{name}_ours")),
                   load_image_dir(str(tmp / f"{name}_ours"))):
        for a, b in zip(arrays, theirs):
            np.testing.assert_array_equal(a, b)
    return theirs, labels


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """tests/test_trained_e2e.py's genome at 8 kb, whose noise reads give
    hom-ref (type 0) windows for the draw to thin."""
    from test_trained_e2e import build_genome

    scene = build_genome(tmp_path_factory.mktemp("torch_genome"), seed=7,
                         n_snps=16, n_noise=16, length=8000)
    return dict(scene, region=CONTIG)


@pytest.mark.parametrize("draw", [1.0, 0.33])
@pytest.mark.parametrize("scene_name", ["cli", "genome"])
def test_train_images_match_jax(sim, genome, scene_name, draw, tmp_path):
    scene = sim if scene_name == "cli" else genome
    (images, type_labels, _), labels = assert_train_images_match(
        scene, tmp_path, draw, "images")
    assert images.shape[1:] == (33, 26) and len(images) == len(type_labels)
    if scene_name == "cli":     # its two SNPs; no hom-ref candidate
        assert labels == {1, 2} and len(images) == 2
    elif draw == 1.0:
        assert labels == {0, 1, 2}
    else:
        assert 0 < int(np.sum(type_labels == 0)) < 16


@pytest.fixture(scope="module")
def image_dir(genome):
    directory = os.path.join(os.path.dirname(genome["bam"]), "train_images")
    stages.make_images(train_options(PepperOptions, set_parameters, genome,
                                     1.0), directory)
    return directory


@pytest.fixture(scope="module")
def trained(image_dir):
    out_dir = os.path.join(os.path.dirname(image_dir), "train_out")
    model_path, accuracy = trainer.train_model(
        PepperOptions(batch_size=16), image_dir, out_dir, epochs=8,
        learning_rate=1e-3, weight_decay=1e-5, step_size=4, batch_size=16,
        holdout_fraction=0.3, seed=0, config=TransducerConfig(**SMALL),
        device="cpu")
    return out_dir, model_path, accuracy


def test_train_model_lowers_the_loss_and_writes_jax_checkpoints(trained):
    out_dir, model_path, accuracy = trained
    with open(os.path.join(out_dir, "train_loss.csv")) as f:
        losses = [float(line.split(",")[2]) for line in f]
    assert losses[-1] < losses[0]
    names = set(os.listdir(out_dir))
    assert {"pepper_model_final.npz", "pepper_model_best.npz",
            "pepper_model_step_4.npz", "test_loss.csv",
            "confusion_matrix.txt", "train_loss.csv", "resume"} <= names
    assert resume.latest_step(os.path.join(out_dir, "resume")) == \
        4 * (len(losses) // 4)
    for name in ("pepper_model_step_4.npz", "pepper_model_final.npz"):
        params, meta = load_params(os.path.join(out_dir, name))
        j_params, j_meta = jax_load_params(os.path.join(out_dir, name))
        assert meta == j_meta
        assert meta["hidden_size"] == 32 and meta["model_type"] == "lstm"
        assert meta["gru_layers"] == 1 and "accuracy" in meta
        assert ("step" in meta) == ("step" in name)
        for (path, a), (_, b) in zip(step.leaves(params),
                                     step.leaves(j_params)):
            assert a.dtype == np.float32, path
            np.testing.assert_array_equal(a, b)
    assert meta["accuracy"] == pytest.approx(accuracy)


def test_trained_npz_gives_jax_probabilities(trained, image_dir):
    _, model_path, _ = trained
    images = load_image_dir(image_dir)[0][:24]
    ours = InferenceRunner(load_params(model_path)[0], batch_size=8,
                           device="cpu").predict_images(images)
    theirs = JaxRunner(jax_load_params(model_path)[0],
                       batch_size=8).predict_images(images)
    np.testing.assert_allclose(ours, theirs, atol=2e-4)


def test_test_model_matches_jax(trained, image_dir):
    _, model_path, _ = trained
    loss, confusion, accuracy = trainer.test_model(
        PepperOptions(batch_size=16, model_path=model_path), image_dir,
        device="cpu")
    j_loss, j_confusion, j_accuracy = jtrainer.test_model(
        JaxOptions(batch_size=16, model_path=model_path), image_dir)
    np.testing.assert_array_equal(confusion, j_confusion)
    assert loss == pytest.approx(j_loss, rel=1e-5)
    assert accuracy == j_accuracy


def test_retrain_resumes_and_refuses_another_family(trained, image_dir,
                                                     tmp_path):
    _, model_path, _ = trained
    options = PepperOptions(batch_size=16)
    out = str(tmp_path / "retrain")
    path, accuracy = trainer.train_model(
        options, image_dir, out, epochs=1, step_size=10_000,
        retrain_model_path=model_path, config=TransducerConfig(**SMALL),
        device="cpu")
    with open(os.path.join(out, "train_loss.csv")) as f:
        first = float(f.readline().split(",")[2])
    with open(os.path.join(os.path.dirname(model_path),
                           "train_loss.csv")) as f:
        fresh = float(f.readline().split(",")[2])
    assert first < fresh      # it starts from the trained weights
    with pytest.raises(ValueError, match="model_type"):
        trainer.train_model(options, image_dir, str(tmp_path / "refused"),
                            epochs=1, retrain_model_path=model_path,
                            model_type="no_cnn", device="cpu")


def test_hp_train_images_and_training(tmp_path):
    """The twin of tests/test_hp_training.py: HP train windows equal to
    JAX's; the 48x21 transducer trains on them (the loss falls) and its
    checkpoint gives JAX's probabilities.  Its held-out accuracy (16
    windows) swings with the seed in both packages (JAX: 81.25% at seed 0,
    56.25% at seeds 1 and 2), so it is not the bar here; chip_smoke.py
    holds the full-width transducer to >= 90% on a 40 kb genome."""
    ref = random_reference(6000, seed=44)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}
    rng = np.random.RandomState(44)
    positions = sorted(rng.choice(np.arange(300, 5700, 40), size=40,
                                  replace=False))
    variants = [(int(p), ref[p], alt[ref[p]],
                 "1|1" if i % 3 == 0 else "1|0")
                for i, p in enumerate(positions)]
    hap1 = [(p, r, a) for p, r, a, _ in variants]
    hap2 = [(p, r, a) for p, r, a, g in variants if g == "1|1"]
    noise = [(int(p), ref[p], alt[ref[p]])
             for p in sorted(rng.choice(np.arange(320, 5680, 40), size=40,
                                        replace=False))
             if p not in {v[0] for v in variants}]
    records = simulate_reads(ref, [hap1, hap2, noise], read_len=300,
                             strides=[25, 25, 80])
    scene = dict(bam=str(tmp_path / "hp.bam"), fasta=str(tmp_path / "hp.fa"),
                 truth=str(tmp_path / "hp.vcf"), bed=str(tmp_path / "hp.bed"),
                 region="chrT")
    write_bam(scene["bam"], [("chrT", len(ref))], records)
    write_fasta(scene["fasta"], {"chrT": ref})
    write_truth_vcf(scene["truth"], "chrT", len(ref), variants)
    with open(scene["bed"], "w") as f:
        f.write(f"chrT\t0\t{len(ref)}\n")
    (images, type_labels, _), _ = assert_train_images_match(
        scene, tmp_path, 1.0, "hp", use_hp_info=True)
    assert images.shape[1:] == (21, 48)
    assert set(np.unique(type_labels)) >= {0, 1}

    out_dir = str(tmp_path / "hp_run")
    model_path, _ = trainer.train_on_arrays(
        PepperOptions(batch_size=16, use_hp_info=True), images, type_labels,
        out_dir, epochs=25, learning_rate=3e-4, step_size=10_000,
        batch_size=16, holdout_fraction=0.2, seed=0,
        config=TransducerConfig(image_features=48, window=21, **SMALL),
        device="cpu")
    with open(os.path.join(out_dir, "train_loss.csv")) as f:
        losses = [float(line.split(",")[2]) for line in f]
    per_epoch = len(losses) // 25
    assert sum(losses[-per_epoch:]) < sum(losses[:per_epoch]) / 2
    ours = InferenceRunner(load_params(model_path)[0], batch_size=16,
                           window=21, features=48,
                           device="cpu").predict_images(images[:32])
    theirs = JaxRunner(jax_load_params(model_path)[0], batch_size=16,
                       window=21, features=48).predict_images(images[:32])
    np.testing.assert_allclose(ours, theirs, atol=2e-4)


def write_labeled_images(n=96, seed=0):
    """tests/test_model_registry.py's toy task: the type label is written
    into channel 0."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n).astype(np.int32)
    images = rng.integers(-5, 5, (n, 33, 26)).astype(np.float32)
    images[:, :, 0] = labels[:, None] * 40.0 - 40.0
    return images, labels


@pytest.mark.parametrize("model_type", ["no_cnn", "transformer"])
def test_family_trains_and_infers(model_type, tmp_path):
    """The twin of tests/test_model_registry.py's: the family trains from
    the arrays, its checkpoint names it, serves through the runner, and
    the JAX package's runner gives the same probabilities."""
    images, labels = write_labeled_images()
    lr, epochs = ((1e-3, 8) if model_type == "transformer" else (3e-3, 6))
    model_path, accuracy = trainer.train_on_arrays(
        PepperOptions(batch_size=24), images, labels,
        str(tmp_path / model_type), epochs=epochs, learning_rate=lr,
        step_size=10_000, batch_size=24, holdout_fraction=0.25, seed=0,
        model_type=model_type, device="cpu")
    params, meta = load_params(model_path)
    assert meta["model_type"] == model_type
    if model_type == "no_cnn":
        assert accuracy > 60.0
    else:
        # BatchNorm running stats calibrated into the checkpoint
        assert np.abs(params["bn1"]["mean"]).sum() > 0
        assert accuracy > 35.0
    probe = np.zeros((5, 33, 26), np.float32)
    probe[:, :, 0] = 40.0
    probs = InferenceRunner(params, batch_size=16, model_type=model_type,
                            device="cpu").predict_images(probe)
    assert probs.shape == (5, 3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-4)
    theirs = JaxRunner(jax_load_params(model_path)[0], batch_size=16,
                       model_type=model_type).predict_images(probe)
    np.testing.assert_allclose(probs, theirs, atol=2e-4)


def test_hyperband_matches_jax():
    """The same brackets, results and best as JAX's Hyperband on a
    deterministic try_params."""

    def try_params(n_iterations, config):
        accuracy = 80 - abs(np.log10(config["learning_rate"]) + 3) \
            + 0.1 * n_iterations
        return {"loss": -accuracy, "accuracy": accuracy, "checkpoint": ""}

    ours = hyperband.Hyperband(try_params, max_iter=9, eta=3, seed=1)
    theirs = jhyperband.Hyperband(try_params, max_iter=9, eta=3, seed=1)
    assert ours.run() == theirs.run()
    assert ours.results == theirs.results and len(ours.results) > 5
    rng, j_rng = np.random.RandomState(4), np.random.RandomState(4)
    assert [hyperband.sample_config(rng) for _ in range(5)] == \
        [jhyperband.sample_config(j_rng) for _ in range(5)]


def test_resume_state_round_trips(tmp_path):
    """A step from the restored state (params and Adam's moments) equals
    a step from the live one: the counterpart of
    tests/test_orbax_checkpoint.py."""
    config = TransducerConfig(image_features=8, window=5, hidden=16,
                              linear_size=32)
    from pepper_tpu_torch.models.transducer import init_transducer_params

    tree = init_transducer_params(torch.Generator().manual_seed(0), config)
    rng = np.random.RandomState(0)
    images = rng.randint(-20, 21, (6, 5, 8)).astype(np.float32)
    labels = rng.randint(0, 3, 6).astype(np.int32)
    mask = np.ones(6, np.float32)

    def make(params):
        optimizer = torch.optim.Adam(
            [leaf for _, leaf in step.leaves(params)], lr=1e-3,
            weight_decay=1e-4)
        return optimizer, step.make_train_step(optimizer, dropout_rate=0.0)

    live = trainer.trainable_params(tree, "cpu")
    optimizer, train_step = make(live)
    train_step(live, images, labels, None, mask)
    directory = str(tmp_path / "resume")
    resume.save_train_state(directory, 10, live, optimizer, {"epoch": 1})
    resume.save_train_state(directory, 20, live, optimizer, {"epoch": 2})
    assert resume.latest_step(directory) == 20
    assert sorted(os.listdir(directory)) == ["step_10", "step_20"]

    restored_step, state = resume.restore_train_state(directory)
    assert restored_step == 20 and state["meta"] == {"epoch": 2}
    restored = trainer.trainable_params(state["params"], "cpu")
    restored_optimizer, restored_step_fn = make(restored)
    restored_optimizer.load_state_dict(state["optimizer"])
    train_step(live, images, labels, None, mask)
    restored_step_fn(restored, images, labels, None, mask)
    for (path, a), (_, b) in zip(step.leaves(live), step.leaves(restored)):
        assert torch.equal(a, b), path
    with pytest.raises(FileNotFoundError):
        resume.restore_train_state(str(tmp_path / "none"))


@pytest.mark.slow
def test_train_then_call(tmp_path):
    """The twin of tests/test_trained_e2e.py: train the port on a 40 kb
    genome's labeled windows, then call the unseen 6 kb genome with the
    trained model and recover every variant."""
    from test_trained_e2e import build_genome

    from pepper_tpu_torch.pipeline.call_variant import call_variant

    train_genome = build_genome(tmp_path, seed=101, n_snps=150,
                                n_noise=250, length=40000)
    test_genome = build_genome(tmp_path, seed=202, n_snps=8, length=6000)
    image_dir = str(tmp_path / "train_images")
    stages.make_images(set_parameters(PepperOptions(
        bam=train_genome["bam"], fasta=train_genome["fasta"],
        ont_r9_guppy5_sup=True, sub_command="make_train_images",
        train_mode=True, truth_vcf=train_genome["truth"],
        region_bed=train_genome["bed"], random_draw_probability=1.0,
        region=CONTIG, threads=1)), image_dir)
    out_dir = str(tmp_path / "train_run")
    _, accuracy = trainer.train_model(
        PepperOptions(batch_size=32), image_dir, out_dir, epochs=30,
        learning_rate=3e-4, step_size=10_000, batch_size=32,
        holdout_fraction=0.15, seed=0,
        config=TransducerConfig(hidden=64, linear_size=128), device="cpu")
    assert accuracy >= 90.0, f"training failed to converge: {accuracy}"

    params, _ = load_params(os.path.join(out_dir, "pepper_model_best.npz"))
    call_variant(set_parameters(PepperOptions(
        bam=test_genome["bam"], fasta=test_genome["fasta"],
        output_dir=str(tmp_path / "calls"), ont_r9_guppy5_sup=True,
        sub_command="call_variant", region=CONTIG, threads=1,
        batch_size=128)), params=params, device="cpu")
    with gzip.open(str(tmp_path / "calls" / "PEPPER_VARIANT_FULL.vcf.gz"),
                   "rt") as f:
        called = {}
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip().split("\t")
            sample = dict(zip(fields[8].split(":"), fields[9].split(":")))
            called[int(fields[1]) - 1] = (fields[3], fields[4],
                                          sample["GT"])
    truth = {p for p, _, _, _ in test_genome["variants"]}
    recovered = genotype_correct = 0
    for pos, ref_allele, alt_allele, genotype in test_genome["variants"]:
        if called.get(pos, (None, None))[:2] == (ref_allele, alt_allele):
            recovered += 1
            expected = "1/1" if genotype == "1|1" else "0/1"
            genotype_correct += called[pos][2] == expected
    assert recovered == len(test_genome["variants"])
    assert genotype_correct >= recovered - 1
    assert [p for p, (_, _, gt) in called.items()
            if gt != "0/0" and p not in truth] == []
