"""The port's polish training (polish/train.py, the polish pipeline's train
images, the polish CLI's training subcommands) against the JAX package, on
the CPU.

Inputs are made with numpy from a seed or with build_polish_dataset
(tests/test_polish_train_e2e.py); parameters come from JAX's
init_polish_params and reach the port through params_from_jax (JAX's PRNG
cannot be reproduced).
Bars:

  * remove_conflicting_regions, summarize_interval_train and the stored
    train images: equal to JAX's;
  * one TBPTT step (19 window updates, lr 1e-4, weight decay 1e-4) at B=5
    with pad rows: each window's loss within rtol 1e-5, params within
    atol 1e-5 of JAX's jitted step;
  * one eval step: loss within rtol 1e-5, confusion equal;
  * a device list ["cpu", "cpu"] against one device at a batch of 5
    padded to 6: params within 2e-4 (tests/test_multihost.py's bar);
  * the trainer: JAX's holdout, batch order, checkpoint names and
    metadata; its .npz polishes to the JAX package's polish() bytes.
"""

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pepper_tpu.io.bam import BamReader as JaxBamReader
from pepper_tpu.io.fasta import FastaReader as JaxFastaReader
from pepper_tpu.models.checkpoint import load_params as jax_load_params
from pepper_tpu.models.polish_gru import init_polish_params
from pepper_tpu.models.polish_gru import polish_forward as j_polish_forward
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.polish import pipeline as jpipeline
from pepper_tpu.polish import train as jtrain
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.models.checkpoint import load_params
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.polish import pipeline, train
from pepper_tpu_torch.train.step import leaves
from pepper_tpu_torch.train.trainer import trainable_params

from test_polish_train_e2e import build_polish_dataset, identity
from test_torch_polish import one_intra_op_thread  # noqa: F401

LR = WD = 1e-4


def _jax_params(seed):
    return jax.tree_util.tree_map(np.asarray, init_polish_params(
        jax.random.PRNGKey(seed)))


def _batch(n_real, n_pad, seed, high=255):
    """n_real seeded chunks (counts 0..high-1, labels 0..4) and n_pad zero
    rows, as pad_to_multiple pads, with the {0,1} mask."""
    rng = np.random.RandomState(seed)
    images = np.zeros((n_real + n_pad, 1000, 10), np.float32)
    labels = np.zeros((n_real + n_pad, 1000), np.int32)
    images[:n_real] = rng.randint(0, high, (n_real, 1000, 10))
    labels[:n_real] = rng.randint(0, 5, (n_real, 1000))
    mask = np.zeros(n_real + n_pad, np.float32)
    mask[:n_real] = 1.0
    return images, labels, mask


def _port_step(params, devices=None):
    tree = trainable_params(params, "cpu")
    optimizer = torch.optim.Adam([leaf for _, leaf in leaves(tree)], lr=LR,
                                 weight_decay=WD)
    return tree, train.make_tbptt_step(optimizer, devices=devices)


def _host(tree):
    return {"/".join(path): leaf.detach().numpy().copy()
            for path, leaf in leaves(tree)}


# ---------------------------------------------------------------- images


REGION_CASES = [
    ([[0, 2000, "a", True], [1800, 4000, "b", True]], 0, 4000),
    ([[0, 2000, "a", True], [100, 2100, "b", True]], 0, 4000),
    ([[0, 6000, "long", True], [100, 1500, "short", True]], 0, 6000),
    ([[0, 500, "tiny", True]], 0, 4000),
]


def _random_regions(seed):
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, 8000, rng.randint(2, 9))
    return ([[int(s), int(s + rng.randint(200, 5000)), i, True]
             for i, s in enumerate(starts)], 500, 9000)


@pytest.mark.parametrize("case", REGION_CASES + [
    _random_regions(seed) for seed in range(6)],
    ids=[f"e2e{i}" for i in range(4)] + [f"random{s}" for s in range(6)])
def test_remove_conflicting_regions_matches_jax(case):
    regions, start, end = case
    ours = pipeline.remove_conflicting_regions(copy.deepcopy(regions), start,
                                               end)
    theirs = jpipeline.remove_conflicting_regions(copy.deepcopy(regions),
                                                  start, end)
    assert ours == theirs


@pytest.fixture(scope="module")
def train_scene(tmp_path_factory):
    """tests/test_polish_train_e2e.py's scene at 3 kb: a draft with
    scattered errors, reads of the truth, one full-length truth read."""
    tmp = tmp_path_factory.mktemp("torch_polish_train")
    return dict(build_polish_dataset(tmp, "train", 3000, seed=5), tmp=tmp)


def test_summarize_interval_train_matches_jax(train_scene):
    handlers = {
        "port": (BamReader(train_scene["bam"]),
                 BamReader(train_scene["truth_bam"]),
                 FastaReader(train_scene["fasta"])),
        "jax": (JaxBamReader(train_scene["bam"]),
                JaxBamReader(train_scene["truth_bam"]),
                JaxFastaReader(train_scene["fasta"]))}
    fasta = handlers["port"][2]
    intervals = pipeline.build_polish_intervals(
        pipeline.get_polish_chromosome_list(None, fasta,
                                            handlers["port"][0]), fasta)
    assert len(intervals) == 3
    chunks = 0
    for contig, start, end in intervals:
        ours = pipeline.summarize_interval_train(
            *handlers["port"], contig, start, end)
        theirs = jpipeline.summarize_interval_train(
            *handlers["jax"], contig, start, end)
        assert [len(part) for part in ours] == [len(part) for part in theirs]
        for a, b in zip(ours[:3], theirs[:3]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert list(ours[3]) == list(theirs[3])
        chunks += len(ours[0])
    assert chunks > 0


def _train_images(scene, by, out):
    """The scene's train images written by the port or by JAX into `out`,
    read back by JAX's loader."""
    if by == "port":
        pipeline.make_polish_train_images(
            PepperOptions(bam=scene["bam"], fasta=scene["fasta"]),
            scene["truth_bam"], out)
    else:
        jpipeline.make_polish_train_images(
            JaxOptions(bam=scene["bam"], fasta=scene["fasta"]),
            scene["truth_bam"], out)
    return jtrain.load_polish_images(out)


def test_make_polish_train_images_reads_back_as_jax(train_scene):
    tmp = train_scene["tmp"]
    ours = _train_images(train_scene, "port", str(tmp / "port_images"))
    theirs = _train_images(train_scene, "jax", str(tmp / "jax_images"))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[1].max() >= 1 and len(ours[0]) >= 3
    # and through the port's own loader
    for a, b in zip(train.load_polish_images(str(tmp / "port_images")),
                    theirs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- steps


def _jax_windows(params, images, labels, mask):
    """JAX's TBPTT step window by window from its own pieces (the body of
    its lax.scan): each window's loss, and the params after."""
    optimizer = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    opt_state = optimizer.init(params)
    hidden = jnp.zeros((len(images), 2, 128), images.dtype)

    def window_loss(params, window, label_chunk, hidden):
        logits, hidden_out = j_polish_forward(params, window, hidden)
        loss = jtrain.weighted_cross_entropy_mean(
            logits.reshape(-1, logits.shape[-1]), label_chunk.reshape(-1),
            jtrain.CLASS_WEIGHTS, mask=jnp.repeat(mask, label_chunk.shape[1]))
        return loss, hidden_out

    grad_fn = jax.jit(jax.value_and_grad(window_loss, has_aux=True))
    losses = []
    for start in range(0, 901, 50):
        (loss, hidden), grads = grad_fn(
            params, images[:, start:start + 100],
            labels[:, start:start + 100], hidden)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params


# (dtype, the image counts' bound): in float32, counts up to 254 saturate
# the random-weight GRU's gates, where s * (1 - s) keeps few bits of 1 - s,
# and a window's gradient parts from JAX's by up to 0.5% at some elements
# (1 of 3840 of encoder/w_ih_b ends 1.2e-5 apart); in float64 the same
# step agrees to 1e-13, and in float32 on counts up to 40 (phase 10's
# domain) to 1.4e-6.  Both are held to the same bars.
STEP_CASES = {"float32": 41, "float64": 255}


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_case(request):
    """One step's inputs at B=5 (3 chunks, 2 pad rows) and JAX's result:
    its jitted step and its window-by-window losses."""
    dtype = request.param
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                        _jax_params(0))
        images, labels, mask = _batch(3, 2, seed=1, high=STEP_CASES[dtype])
        images, mask = images.astype(dtype), mask.astype(dtype)
        optimizer = optax.chain(optax.add_decayed_weights(WD),
                                optax.adam(LR))
        j_params, _, j_total = jtrain.make_tbptt_step(optimizer)(
            params, optimizer.init(params), images, labels, mask)
        losses, loop_params = _jax_windows(params, images, labels, mask)
        # the loop is JAX's step
        np.testing.assert_allclose(sum(losses), float(j_total), rtol=1e-6)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6),
            loop_params, j_params)
    flat = {f"{group}/{key}": np.asarray(value)
            for group, node in j_params.items()
            for key, value in node.items()}
    return dict(params=params, batch=(images, labels, mask), losses=losses,
                total=float(j_total), final=flat, dtype=dtype)


def test_tbptt_step_matches_jax(step_case):
    tree, step = _port_step(step_case["params"])
    losses = []
    total = step(tree, *step_case["batch"], losses_out=losses)
    assert len(losses) == 19
    np.testing.assert_allclose(losses, step_case["losses"], rtol=1e-5)
    np.testing.assert_allclose(total, step_case["total"], rtol=1e-5)
    ours = _host(tree)
    assert sorted(ours) == sorted(step_case["final"])
    for key, value in ours.items():
        np.testing.assert_allclose(value, step_case["final"][key], atol=1e-5,
                                   err_msg=key)
    # the step moved the params (19 Adam updates of up to lr each)
    moved = max(np.abs(ours[k] - step_case["params"][k.split("/")[0]][
        k.split("/")[1]]).max() for k in ours)
    assert moved > 10 * LR


def test_weighted_cross_entropy_mean_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 7, 5).astype(np.float32)
    labels = rng.randint(0, 5, (4, 7)).astype(np.int32)
    mask = np.array([1, 1, 0, 1], np.float32)
    for weights, j_weights in ((train.CLASS_WEIGHTS, jtrain.CLASS_WEIGHTS),
                               (train.TEST_CLASS_WEIGHTS,
                                jtrain.TEST_CLASS_WEIGHTS)):
        ours = train.weighted_cross_entropy_mean(
            torch.from_numpy(logits), torch.from_numpy(labels), weights,
            mask=torch.from_numpy(mask))
        theirs = jtrain.weighted_cross_entropy_mean(
            logits.reshape(-1, 5), labels.reshape(-1), j_weights,
            mask=jnp.repeat(mask, 7))
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    # every row masked: the 1e-9 floor, not a division by zero
    zero = train.weighted_cross_entropy_mean(
        torch.from_numpy(logits), torch.from_numpy(labels),
        train.CLASS_WEIGHTS, mask=torch.zeros(4))
    assert float(zero) == 0.0


def test_polish_eval_step_matches_jax():
    params = _jax_params(2)
    images, labels, mask = _batch(3, 2, seed=4)
    loss, confusion = train.make_polish_eval_step()(
        trainable_params(params, "cpu"), images, labels, mask)
    j_loss, j_confusion = jtrain.make_polish_eval_step()(params, images,
                                                         labels, mask)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(confusion, np.asarray(j_confusion))
    assert confusion.sum() == 3 * 1000


def test_device_list_step_equals_one_device(step_case):
    """A batch of 5 padded to 6 over ["cpu", "cpu"]: 3 real rows on the
    first device, 2 and a pad row on the second; each device's loss
    divides by the global weight sum, so the summed gradients are one
    device's (a mean of per-device means would weight the rows 1/3 and
    1/2)."""
    dtype = step_case["dtype"]
    images, labels, mask = _batch(5, 1, seed=5, high=STEP_CASES[dtype])
    images, mask = images.astype(dtype), mask.astype(dtype)
    one, step = _port_step(step_case["params"])
    one_losses = []
    step(one, images, labels, mask, losses_out=one_losses)
    two, step = _port_step(step_case["params"], devices=["cpu", "cpu"])
    two_losses = []
    step(two, images, labels, mask, losses_out=two_losses)
    np.testing.assert_allclose(two_losses, one_losses, rtol=1e-5)
    for key, value in _host(two).items():
        np.testing.assert_allclose(value, _host(one)[key], atol=2e-4,
                                   err_msg=key)


# ---------------------------------------------------------------- trainer


class _Recorder:
    """Stands in for a package's TBPTT and eval steps: records the chunk
    ids (column 0 of feature 0) of each batch's real rows, in order (the
    JAX package pads each batch to its mesh's 8 CPU devices, the port on
    the CPU to one device)."""

    def __init__(self):
        self.train, self.eval = [], []

    @staticmethod
    def _ids(images, mask):
        images, mask = np.asarray(images), np.asarray(mask)
        n = int(mask.sum())
        assert (mask[:n] == 1).all() and not mask[n:].any()
        return images[:n, 0, 0].astype(int).tolist()

    def jax_tbptt(self, optimizer, mesh=None):
        def step(params, opt_state, images, labels, mask):
            self.train.append(self._ids(images, mask))
            return params, opt_state, 0.0
        return step

    def port_tbptt(self, optimizer, devices=None):
        def step(params, images, labels, mask, losses_out=None):
            self.train.append(self._ids(images, mask))
            return 0.0
        return step

    def eval_step(self, *args, **kwargs):
        def step(params, images, labels, mask):
            self.eval.append(self._ids(images, mask))
            return 0.0, np.eye(5, dtype=np.int64)
        return step


@pytest.mark.parametrize("n_chunks,batch_size,holdout,seed",
                         [(23, 4, 0.2, 0), (9, 16, 0.15, 7), (1, 4, 0.2, 3)])
def test_trainer_holdout_batches_and_files_match_jax(monkeypatch, tmp_path,
                                                     n_chunks, batch_size,
                                                     holdout, seed):
    """The same seed holds out the same chunks and feeds the same batches
    in the same order, the pad rows masked out; the checkpoints have
    JAX's names and metadata and load in JAX's load_params."""
    images = np.zeros((n_chunks, 1000, 10), np.float32)
    images[:, 0, 0] = np.arange(n_chunks)
    labels = np.zeros((n_chunks, 1000), np.int32)
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    from pepper_tpu.polish.datastore import PolishImageStore

    with PolishImageStore(str(image_dir / "x.hdf5"), "w") as store:
        for i in range(n_chunks):
            store.write_summary(("ctg", 0, 1000), images[i], labels[i],
                                np.arange(1000), np.zeros(1000, np.int64),
                                i, f"ctg_{i:03d}")
    kwargs = dict(epochs=2, learning_rate=1e-3, batch_size=batch_size,
                  holdout_fraction=holdout, seed=seed)
    runs = {}
    for name, module, tbptt in (("jax", jtrain, "jax_tbptt"),
                                ("port", train, "port_tbptt")):
        recorder = _Recorder()
        monkeypatch.setattr(module, "make_tbptt_step",
                            getattr(recorder, tbptt))
        monkeypatch.setattr(module, "make_polish_eval_step",
                            recorder.eval_step)
        out = tmp_path / name
        extra = {"device": "cpu"} if name == "port" else {}
        final = module.train_polish_model(
            JaxOptions() if name == "jax" else PepperOptions(),
            str(image_dir), str(out), **kwargs, **extra)
        assert final == str(out / "polish_model_final.npz")
        runs[name] = (recorder, sorted(os.listdir(out)))
    assert runs["port"][0].train == runs["jax"][0].train
    assert runs["port"][0].eval == runs["jax"][0].eval
    assert runs["port"][1] == runs["jax"][1] == [
        "polish_epoch_1_checkpoint.npz", "polish_epoch_2_checkpoint.npz",
        "polish_model_final.npz"]
    for name in runs["port"][1]:
        ours, ours_meta = jax_load_params(str(tmp_path / "port" / name))
        theirs, theirs_meta = jax_load_params(str(tmp_path / "jax" / name))
        assert ours_meta == theirs_meta
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(theirs)
        assert [a.shape for a in jax.tree_util.tree_leaves(ours)] == \
            [b.shape for b in jax.tree_util.tree_leaves(theirs)]


@pytest.fixture(scope="module")
def trained(train_scene):
    """A reduced run of the port's trainer on the scene's train images
    (2 epochs, lr 1e-3, batch 8): the run's directory and its epoch
    losses."""
    import io
    import contextlib

    tmp = train_scene["tmp"]
    images, labels = _train_images(train_scene, "port",
                                   str(tmp / "trained_images"))
    out = str(tmp / "trained")
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        train.train_polish_on_arrays(
            PepperOptions(), images, labels, out, epochs=2,
            learning_rate=1e-3, batch_size=8, holdout_fraction=0.15,
            device="cpu")
    losses = [float(x) for x in re.findall(r"TRAIN LOSS: ([\d.]+)",
                                           log.getvalue())]
    return dict(out=out, losses=losses, chunks=len(images))


def test_reduced_training_run_lowers_the_loss(trained):
    assert len(trained["losses"]) == 2
    assert trained["losses"][1] < trained["losses"][0]
    assert sorted(os.listdir(trained["out"])) == [
        "polish_epoch_1_checkpoint.npz", "polish_epoch_2_checkpoint.npz",
        "polish_model_final.npz"]
    _, meta = load_params(os.path.join(trained["out"],
                                       "polish_model_final.npz"))
    assert meta == {"epochs": 2, "hidden_size": 128, "gru_layers": 1}


def test_port_trained_model_polishes_as_jax(trained, train_scene):
    """The port-trained .npz in the JAX package's polish() and in the
    port's: the same FASTA bytes."""
    model = os.path.join(trained["out"], "polish_model_final.npz")
    params, _ = jax_load_params(model)
    outputs = {}
    for name, options, run in (
            ("jax", JaxOptions, jpipeline.polish),
            ("port", PepperOptions,
             lambda o, p: pipeline.polish(o, p, device="cpu"))):
        path = run(options(
            bam=train_scene["bam"], fasta=train_scene["fasta"],
            output_dir=str(train_scene["tmp"] / f"polished_{name}"),
            threads=1, batch_size=8), params)
        with open(path, "rb") as f:
            outputs[name] = f.read()
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"].split(b"\n")[1]) > 2000


@pytest.mark.slow
def test_polish_train_and_apply_port(tmp_path):
    """The port's twin of tests/test_polish_train_e2e.py's
    test_polish_train_and_apply: train images, 6 epochs of TBPTT on a 14
    kb draft, and the unseen 6 kb draft polished to >= 0.995 identity."""
    scene = build_polish_dataset(tmp_path, "train", 14000, seed=5)
    test = build_polish_dataset(tmp_path, "test", 6000, seed=9)
    image_dir = str(tmp_path / "train_imgs")
    pipeline.make_polish_train_images(
        PepperOptions(bam=scene["bam"], fasta=scene["fasta"], threads=1),
        scene["truth_bam"], image_dir)
    model_path = train.train_polish_model(
        PepperOptions(), image_dir, str(tmp_path / "polish_run"), epochs=6,
        learning_rate=1e-3, batch_size=8, holdout_fraction=0.15,
        device="cpu")
    params, _ = load_params(model_path)
    fasta_path = pipeline.polish(PepperOptions(
        bam=test["bam"], fasta=test["fasta"],
        output_dir=str(tmp_path / "polish_out"), threads=1, batch_size=8),
        params, device="cpu")
    with open(fasta_path) as f:
        polished = "".join(f.read().strip().split("\n")[1:])
    draft_identity = identity(test["draft"], test["truth"])
    polished_identity = identity(polished, test["truth"])
    assert polished_identity > draft_identity
    assert polished_identity >= 0.995, (draft_identity, polished_identity)
