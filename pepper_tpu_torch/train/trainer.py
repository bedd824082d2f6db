"""Training loop for the window classifier, the port of the JAX package's
train/trainer.py.

Reference semantics (pepper_variant/.../models/train_distributed.py:107-228):
Adam + L2, CrossEntropyLoss(sum) over 3 type classes, eval every step_size
steps with a confusion matrix, checkpoints each eval, ReduceLROnPlateau on
accuracy (mode=max, patience=2).  Data parallel over a device list and
over the processes of a gloo group (train/step.py); .npz checkpoints in
the JAX package's layout, train_loss.csv/test_loss.csv/confusion matrix
logs, and a torch resume state (train/resume.py).

`train_model` and `test_model` keep the JAX package's signatures and read
HDF5 image stores; `train_on_arrays` and `test_on_arrays` take the arrays
themselves (no h5py).
"""

from __future__ import annotations

import os
import sys
from datetime import datetime

import numpy as np
import torch

from ..device import resolve_device
from ..models.checkpoint import load_params, save_params
from ..models.params import map_params, params_from_jax
from ..models.transducer import TransducerConfig, init_transducer_params
from ..options import ImageOptionsHP
from ..parallel.dist import process_count, process_index
from ..parallel.mesh import host_batch_rows, pad_to_multiple
from .data import batch_iterator, load_image_dir
from .step import leaves, make_eval_step, make_train_step

# BatchNorm running statistics: no gradient, no weight decay
FROZEN = ("mean", "var")


def _log(message: str) -> None:
    timestamp = datetime.now().strftime("%m-%d-%Y %H:%M:%S")
    sys.stderr.write(f"[{timestamp}] INFO: {message}\n")
    sys.stderr.flush()


class PlateauScheduler:
    """ReduceLROnPlateau('max', patience=2) equivalent
    (train_distributed.py:108)."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 2,
                 min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = -np.inf
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric > self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.bad_epochs = 0
        return self.lr


def _pad_batch(images, labels, n_devices):
    padded_images, n = pad_to_multiple(images.astype(np.float32), n_devices)
    padded_labels, _ = pad_to_multiple(labels, n_devices)
    mask = np.zeros(len(padded_labels), np.float32)
    mask[:n] = 1.0
    return padded_images, padded_labels, mask


def evaluate(params, images, labels, eval_step, batch_size: int,
             n_devices: int, shard_fn=None):
    total_loss = 0.0
    confusion = np.zeros((3, 3), np.int64)
    for start in range(0, len(images), batch_size):
        padded_images, padded_labels, mask = _pad_batch(
            images[start:start + batch_size],
            labels[start:start + batch_size], n_devices)
        if shard_fn is not None:
            padded_images, padded_labels, mask = shard_fn(
                padded_images, padded_labels, mask)
        loss, conf = eval_step(params, padded_images, padded_labels, mask)
        total_loss += float(loss)
        confusion += np.asarray(conf)
    accuracy = (100.0 * np.trace(confusion) / max(1, confusion.sum()))
    return total_loss, confusion, accuracy


def training_devices(device=None, devices=None) -> list:
    """The devices this process trains on: the caller's list, else every
    local GPU on cuda (as the JAX package's get_mesh() spans
    jax.devices()), else [device].  Raises where CUDA is asked for and
    missing."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        resolve_device(devices[0])
        return devices
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _process_rows(padded_images, padded_labels, mask):
    """This process's rows of a padded global batch."""
    count = process_count()
    if count == 1:
        return padded_images, padded_labels, mask
    index = process_index()
    return (host_batch_rows(padded_images, index, count),
            host_batch_rows(padded_labels, index, count),
            host_batch_rows(mask, index, count))


def _host(params):
    return map_params(lambda p: p.detach().cpu().numpy(), params)


def train_model(options, image_dir: str, output_dir: str, *, epochs: int = 10,
                learning_rate: float = 1e-4, weight_decay: float = 0.0,
                step_size: int = 100, batch_size: int | None = None,
                retrain_model_path: str | None = None,
                test_file: str | None = None, holdout_fraction: float = 0.1,
                seed: int = 0, config: TransducerConfig | None = None,
                model_type: str = "lstm", device=None, devices=None):
    """Train on the labeled image stores under image_dir (the JAX
    package's train_model); returns (final .npz path, accuracy)."""
    images, type_labels, _ = load_image_dir(image_dir)
    test_images = test_labels = None
    if test_file:
        test_images, test_labels, _ = load_image_dir(test_file)
    return train_on_arrays(
        options, images, type_labels, output_dir, test_images=test_images,
        test_labels=test_labels, epochs=epochs, learning_rate=learning_rate,
        weight_decay=weight_decay, step_size=step_size,
        batch_size=batch_size, retrain_model_path=retrain_model_path,
        holdout_fraction=holdout_fraction, seed=seed, config=config,
        model_type=model_type, device=device, devices=devices)


def train_on_arrays(options, images, type_labels, output_dir: str, *,
                    test_images=None, test_labels=None, epochs: int = 10,
                    learning_rate: float = 1e-4, weight_decay: float = 0.0,
                    step_size: int = 100, batch_size: int | None = None,
                    retrain_model_path: str | None = None,
                    holdout_fraction: float = 0.1, seed: int = 0,
                    config: TransducerConfig | None = None,
                    model_type: str = "lstm", device=None, devices=None):
    """train_model on in-memory windows (N, T, F) and type labels (N,);
    without test arrays a seeded holdout_fraction of them is held out."""
    devices = training_devices(device, devices)
    home = devices[0]
    os.makedirs(output_dir, exist_ok=True)
    _log(f"TOTAL TRAINING EXAMPLES: {len(images)}")

    if test_images is None:
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(images))
        n_test = max(1, int(len(images) * holdout_fraction))
        test_index, train_index = order[:n_test], order[n_test:]
        test_images, test_labels = images[test_index], type_labels[test_index]
        images, type_labels = images[train_index], type_labels[train_index]

    batch_size = batch_size or options.batch_size
    # every process holds every row and takes its contiguous share of each
    # padded global batch (the DistributedSampler role); the gradients are
    # summed over the gloo group in the step
    index, count = process_index(), process_count()
    n_devices = count * len(devices)
    if count > 1:
        _log(f"MULTI-PROCESS TRAINING: process {index}/{count}, "
             f"{n_devices} global devices")

    if config is None:
        if options.use_hp_info:
            config = TransducerConfig(
                image_features=ImageOptionsHP.IMAGE_HEIGHT,
                window=ImageOptionsHP.CANDIDATE_WINDOW_SIZE + 1)
        else:
            config = TransducerConfig()

    family = None
    if model_type != "lstm":
        from ..models.registry import make_family

        family = make_family(model_type,
                             image_features=config.image_features,
                             window=config.window)

    generator = torch.Generator().manual_seed(seed)
    if retrain_model_path:
        params, retrain_meta = load_params(retrain_model_path)
        if retrain_meta.get("model_type", "lstm") != model_type:
            raise ValueError(
                f"checkpoint {retrain_model_path} is model_type "
                f"{retrain_meta.get('model_type', 'lstm')!r}, not "
                f"{model_type!r}")
        _log(f"RETRAINING FROM: {retrain_model_path}")
    elif model_type == "lstm":
        params = init_transducer_params(generator, config)
    else:
        params = family.init(generator)
        _log(f"MODEL FAMILY: {model_type}")
    params = trainable_params(params, home)

    scheduler = PlateauScheduler(learning_rate,
                                 min_lr=learning_rate * 0.75)
    # torch Adam(weight_decay) adds the L2 term to the gradient BEFORE the
    # moments (train_distributed.py:107), as the JAX package's
    # add_decayed_weights + adam; the BatchNorm running statistics are
    # not among its parameters
    optimizer = torch.optim.Adam(
        [leaf for _, leaf in leaves(params) if leaf.requires_grad],
        lr=learning_rate, weight_decay=weight_decay)
    logits_fn = None if model_type == "lstm" else family.logits
    train_step = make_train_step(optimizer, devices=devices,
                                 logits_fn=logits_fn)
    eval_step = make_eval_step(devices=devices, logits_fn=logits_fn)

    # families with BatchNorm (transformer) carry no running-stat state:
    # fold calibration-batch statistics into the params before every
    # eval/checkpoint so inference-mode normalization sees realistic stats
    calib_images = test_images[:min(len(test_images), 256)].astype(
        np.float32)

    def snapshot(train_params):
        if family is not None and family.calibrate is not None:
            with torch.no_grad():
                return family.calibrate(train_params, calib_images)
        return train_params

    class _NullLog:
        def write(self, *_):
            pass

        def close(self):
            pass

    # only rank 0 writes logs/checkpoints (every rank still computes the
    # eval: its sums run over the group)
    if index == 0:
        train_log = open(os.path.join(output_dir, "train_loss.csv"), "w")
        test_log = open(os.path.join(output_dir, "test_loss.csv"), "w")
        confusion_log = open(
            os.path.join(output_dir, "confusion_matrix.txt"), "w")
    else:
        train_log = test_log = confusion_log = _NullLog()

    def meta(**fields):
        return {**fields, "hidden_size": config.hidden, "gru_layers": 1,
                "model_type": model_type}

    data_rng = np.random.RandomState(seed + 1)
    dropout_generator = torch.Generator(device=home).manual_seed(seed + 2)
    global_step = 0
    best_accuracy = -1.0
    try:
        for epoch in range(epochs):
            epoch_loss = 0.0
            for batch_images, batch_labels in batch_iterator(
                    images, type_labels, batch_size, data_rng,
                    drop_last=False):
                padded_images, padded_labels, mask = _process_rows(
                    *_pad_batch(batch_images, batch_labels, n_devices))
                metrics = train_step(params, padded_images, padded_labels,
                                     dropout_generator, mask)
                loss = metrics["loss"]
                epoch_loss += loss
                global_step += 1
                train_log.write(f"{epoch},{global_step},{loss}\n")

                if global_step % step_size == 0:
                    eval_params = snapshot(params)
                    test_loss, confusion, accuracy = evaluate(
                        eval_params, test_images, test_labels, eval_step,
                        batch_size, n_devices, shard_fn=_process_rows)
                    test_log.write(f"{epoch},{global_step},{test_loss},"
                                   f"{accuracy}\n")
                    confusion_log.write(f"step {global_step}\n{confusion}\n")
                    # deterministic given the (summed) accuracy, so every
                    # rank applies the same LR without coordination
                    new_lr = scheduler.step(accuracy)
                    for group in optimizer.param_groups:
                        group["lr"] = new_lr
                    _log(f"STEP {global_step} TEST LOSS: {test_loss:.3f} "
                         f"ACCURACY: {accuracy:.3f} LR: {new_lr:g}")
                    host_params = _host(eval_params)
                    step_meta = meta(epochs=epoch, step=global_step,
                                     accuracy=float(accuracy))
                    if index == 0:
                        save_params(os.path.join(
                            output_dir,
                            f"pepper_model_step_{global_step}.npz"),
                            host_params, step_meta)
                        # crash-safe full train state (params + optimizer)
                        from .resume import save_train_state

                        save_train_state(os.path.join(output_dir, "resume"),
                                         global_step, params, optimizer,
                                         {"epoch": epoch,
                                          "accuracy": float(accuracy)})
                    if accuracy > best_accuracy:
                        best_accuracy = accuracy
                        if index == 0:
                            save_params(os.path.join(
                                output_dir, "pepper_model_best.npz"),
                                host_params, step_meta)
            _log(f"EPOCH {epoch} TRAIN LOSS: {epoch_loss:.3f}")

        # final eval + checkpoint
        eval_params = snapshot(params)
        test_loss, confusion, accuracy = evaluate(
            eval_params, test_images, test_labels, eval_step, batch_size,
            n_devices, shard_fn=_process_rows)
        _log(f"FINAL ACCURACY: {accuracy:.3f}")
        confusion_log.write(f"final\n{confusion}\n")
        host_params = _host(eval_params)
        final_meta = meta(epochs=epochs, accuracy=float(accuracy))
        if index == 0:
            save_params(os.path.join(output_dir, "pepper_model_final.npz"),
                        host_params, final_meta)
            if accuracy > best_accuracy:
                save_params(os.path.join(output_dir,
                                         "pepper_model_best.npz"),
                            host_params, final_meta)
    finally:
        train_log.close()
        test_log.close()
        confusion_log.close()
    return os.path.join(output_dir, "pepper_model_final.npz"), accuracy


def trainable_params(tree, device) -> dict:
    """A parameter tree (numpy arrays or tensors) as fresh float leaves on
    `device` that require grad, but for the BatchNorm running statistics
    (FROZEN), which take none."""
    def leaf(key, value):
        value = (value.detach().to(device).clone()
                 if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.array(value)).to(device))
        return value.requires_grad_(key not in FROZEN)

    return {key: (trainable_params(value, device) if isinstance(value, dict)
                  else leaf(key, value))
            for key, value in tree.items()}


def test_model(options, image_dir: str, device=None, devices=None):
    """Standalone evaluation of options.model_path on the labeled image
    stores under image_dir (TestModule.py:12 / models/test.py:35-108)."""
    images, type_labels, _ = load_image_dir(image_dir)
    params, meta = load_params(options.model_path)
    return test_on_arrays(options, images, type_labels, params, meta,
                          device=device, devices=devices)


def test_on_arrays(options, images, type_labels, params, meta, device=None,
                   devices=None):
    """test_model on in-memory windows and labels with a parameter tree
    (numpy arrays, as load_params gives) and its metadata; returns (loss,
    confusion, accuracy)."""
    devices = training_devices(device, devices)
    params = params_from_jax(params, devices[0])
    n_devices = process_count() * len(devices)
    model_type = meta.get("model_type", "lstm")
    logits_fn = None
    if model_type != "lstm":
        from ..models.registry import make_family

        logits_fn = make_family(
            model_type, image_features=images.shape[2],
            window=images.shape[1]).logits
        _log(f"MODEL FAMILY: {model_type}")
    eval_step = make_eval_step(devices=devices, logits_fn=logits_fn)
    loss, confusion, accuracy = evaluate(params, images, type_labels,
                                         eval_step, options.batch_size,
                                         n_devices, shard_fn=_process_rows)
    _log(f"TEST LOSS: {loss:.4f}")
    _log(f"ACCURACY: {accuracy:.4f}")
    _log(f"CONFUSION MATRIX:\n{confusion}")
    return loss, confusion, accuracy
