"""Polish-model training: truncated backprop through time over sliding
windows, the port of the JAX package's polish/train.py.

Reference semantics (pepper/modules/python/models/train.py:124-166): for
each 1000-column chunk, windows of 100 sliding by 50; per window: forward
with the carried hidden, weighted CrossEntropyLoss (mean), backward,
optimizer step, then hidden.detach().  Where the JAX package runs the 19
windows as one lax.scan in one jit, here they run as a Python loop of
eager steps, each one torch.optim.Adam(lr, weight_decay) update (optax's
add_decayed_weights + adam).

Data parallel over a device list and over the processes of a gloo group
(train/step.py's rules): each device's rows run forward and backward on
its own view of the parameters and the gradients are summed onto the
first device, then over the processes (parallel/dist.py:all_reduce_sum).
The JAX loss is one weighted mean over the global padded batch, so each
device's loss is its weighted NLL sum over the GLOBAL weight sum, which
depends only on the labels and the mask and is known before the forward;
the summed gradients are then the global mean's.

The training forward and backward run the eager recurrence
(polish_forward(allow_kernel=False), models/rnn.py's gru_scan, the
counterpart of lax.scan): no kernel has a backward.  The eval runs under
torch.inference_mode() with allow_kernel=True: on cuda the fused GRU
kernel (ops/gru_kernel.py:gru_direction_fused, float32) over the whole
1000-column chunk, on the CPU the same gru_scan.

`train_polish_model`, `test_polish_model` and `run_polish_hyperband` keep
the JAX package's signatures and read HDF5 image stores;
`train_polish_on_arrays` and `test_polish_on_arrays` take the arrays
themselves (no h5py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.checkpoint import load_params, save_params
from ..models.params import params_from_jax
from ..models.polish_gru import init_polish_params, polish_forward
from ..options import PolishImageOptions
from ..parallel.dist import all_reduce_sum, process_count, process_index
from ..parallel.mesh import make_global_batch, pad_to_multiple
from ..pipeline.regions import log_info
from ..train.step import _devices, _on_device, leaves
from ..train.trainer import (_host, _process_rows, trainable_params,
                             training_devices)
from .consensus import STARTS, TRAIN_WINDOW

CLASS_WEIGHTS = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0])
TEST_CLASS_WEIGHTS = torch.tensor([0.3, 1.0, 1.0, 1.0, 1.0])
NUM_CLASSES = PolishImageOptions.TOTAL_LABELS
HIDDEN = PolishImageOptions.HIDDEN_SIZE


def weighted_cross_entropy_mean(logits, labels, class_weights, mask=None,
                                weight_sum=None):
    """torch.nn.CrossEntropyLoss(weight=w) semantics: per-example weighted
    NLL averaged by the SUM OF WEIGHTS of the targets.  logits (..., C),
    labels (...), mask (B,) over the leading axis.  `weight_sum` replaces
    max(1e-9, the weights' sum): a device's rows divide by the global
    batch's sum."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    weights = class_weights.to(logits)[labels.long()]
    if mask is not None:
        weights = weights * mask.reshape(-1, *([1] * (labels.dim() - 1)))
    if weight_sum is None:
        weight_sum = torch.clamp(weights.sum(), min=1e-9)
    return (nll * weights).sum() / weight_sum


def _global_weight_sums(labels, mask, class_weights, windows):
    """The weight sums of the global padded batch for each (start, stop)
    column window: this process's rows summed here, then over the gloo
    group, in float64; each at least 1e-9."""
    weights = (class_weights.double().numpy()[labels]
               * mask.astype(np.float64)[:, None])
    sums = np.array([weights[:, a:b].sum() for a, b in windows])
    (sums,) = all_reduce_sum([sums])
    return np.maximum(1e-9, sums)


def make_tbptt_step(optimizer: torch.optim.Optimizer, devices=None):
    """Returns step(params, images (B, 1000, F), labels (B, 1000), mask
    (B,), losses_out=None) -> the sum of the 19 window losses (each also
    appended to `losses_out`, a list, where one is given).

    params: the tree whose leaves `optimizer` holds (on devices[0]).
    images, labels, mask: this process's rows of the padded global batch
    as host arrays, split here over `devices` (default: params' device);
    images in the params' dtype.  Each window: the forward on the params
    as the last window left them with the carried hidden (detached), the
    weighted mean over the global batch, the backward, the gradients
    summed over the devices and processes, one optimizer step; its
    hidden_out is carried."""
    def step(params, images, labels, mask, losses_out=None):
        targets = _devices(devices, params)
        home = targets[0]
        sums = _global_weight_sums(
            labels, mask, CLASS_WEIGHTS,
            [(s, s + TRAIN_WINDOW) for s in STARTS])
        xs = make_global_batch(images, targets)
        ys = make_global_batch(labels, targets)
        ms = make_global_batch(mask, targets)
        hiddens = [torch.zeros((len(x), 2, HIDDEN), dtype=x.dtype,
                               device=x.device) for x in xs]
        trainable = [leaf for _, leaf in leaves(params)]
        losses = []
        for window, start in enumerate(STARTS):
            cols = slice(start, start + TRAIN_WINDOW)
            grads = None
            loss = torch.zeros((), dtype=torch.float64, device=home)
            for i, (x, y, m) in enumerate(zip(xs, ys, ms)):
                replica = _on_device(params, x.device, grad=True)
                logits, hidden_out = polish_forward(
                    replica, x[:, cols], hiddens[i].detach(),
                    allow_kernel=False)
                shard_loss = weighted_cross_entropy_mean(
                    logits, y[:, cols], CLASS_WEIGHTS, mask=m,
                    weight_sum=float(sums[window]))
                shard = torch.autograd.grad(
                    shard_loss, [leaf for _, leaf in leaves(replica)])
                shard = [g.to(home) for g in shard]
                grads = shard if grads is None else [
                    a + b for a, b in zip(grads, shard)]
                loss += shard_loss.detach().double().to(home)
                hiddens[i] = hidden_out.detach()
            if process_count() > 1:
                summed = all_reduce_sum(
                    [g.cpu().numpy() for g in grads] + [loss.cpu().numpy()])
                grads = [torch.from_numpy(g).to(home) for g in summed[:-1]]
                loss = torch.from_numpy(summed[-1])
            for leaf, grad in zip(trainable, grads):
                leaf.grad = grad
            optimizer.step()
            losses.append(loss.to(home))
        losses = torch.stack(losses).cpu()
        if losses_out is not None:
            losses_out.extend(losses.tolist())
        return float(losses.sum())

    return step


def make_polish_eval_step(devices=None, num_classes=NUM_CLASSES):
    """Returns step(params, images, labels, mask) -> (loss, confusion):
    one forward over the whole chunk from a zero hidden, the
    TEST_CLASS_WEIGHTS mean over the global padded batch and the
    (num_classes, num_classes) int64 confusion of its real rows
    (confusion[label, pred] += mask), summed over the devices and the
    processes.  Arguments as the TBPTT step's."""

    def step(params, images, labels, mask):
        targets = _devices(devices, params)
        (weight_sum,) = _global_weight_sums(
            labels, mask, TEST_CLASS_WEIGHTS, [(0, labels.shape[1])])
        parts = []
        with torch.inference_mode():
            for x, y, m in zip(make_global_batch(images, targets),
                               make_global_batch(labels, targets),
                               make_global_batch(mask, targets)):
                hidden = torch.zeros((len(x), 2, HIDDEN), dtype=x.dtype,
                                     device=x.device)
                logits, _ = polish_forward(_on_device(params, x.device), x,
                                           hidden, allow_kernel=True)
                loss = weighted_cross_entropy_mean(
                    logits, y, TEST_CLASS_WEIGHTS, mask=m,
                    weight_sum=float(weight_sum))
                confusion = torch.zeros((num_classes, num_classes),
                                        dtype=torch.int64, device=x.device)
                rows = m.long()[:, None].expand(y.shape)
                confusion.index_put_((y.long().reshape(-1),
                                      logits.argmax(dim=-1).reshape(-1)),
                                     rows.reshape(-1), accumulate=True)
                parts.append((loss, confusion))
        loss = sum(float(part[0]) for part in parts)
        confusion = sum(part[1].cpu().numpy() for part in parts)
        loss, confusion = all_reduce_sum([np.float64(loss), confusion])
        return float(loss), confusion

    return step


def load_polish_images(image_dir: str):
    """Every chunk of the polish image stores under image_dir: (images
    float32 (N, 1000, 10), labels int32 (N, 1000)); needs h5py."""
    from .datastore import PolishImageStore

    images, labels = [], []
    files = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)
                   if f.endswith((".hdf", ".hdf5", ".h5")))
    for path in files:
        with PolishImageStore(path, "r") as store:
            for name in store.summary_names():
                record = store.read_summary(name)
                images.append(record["image"].astype(np.float32))
                labels.append(record["label"].astype(np.int32))
    if not images:
        raise ValueError(f"no polish training images under {image_dir}")
    return np.stack(images), np.stack(labels)


def _padded_batch(images, labels, n_devices):
    """A batch padded to a multiple of the global device count, with its
    {0,1} row mask, as this process's rows."""
    padded_images, n = pad_to_multiple(images.astype(np.float32), n_devices)
    padded_labels, _ = pad_to_multiple(labels.astype(np.int32), n_devices)
    mask = np.zeros(len(padded_labels), np.float32)
    mask[:n] = 1.0
    return _process_rows(padded_images, padded_labels, mask)


def _evaluate(eval_step, params, images, labels, batch_size, n_devices):
    total_loss = 0.0
    confusion = np.zeros((NUM_CLASSES, NUM_CLASSES), np.int64)
    for start in range(0, len(images), batch_size):
        loss, conf = eval_step(params, *_padded_batch(
            images[start:start + batch_size],
            labels[start:start + batch_size], n_devices))
        total_loss += float(loss)
        confusion += np.asarray(conf)
    accuracy = 100.0 * np.trace(confusion) / max(1, confusion.sum())
    return total_loss, confusion, float(accuracy)


def evaluate_polish_model(params, images, labels, *, batch_size: int = 16,
                          device=None, devices=None):
    """Loss/confusion/accuracy of a polish checkpoint (a tree of numpy
    arrays or tensors) over labeled chunks — the reference's pepper
    test_models.py / models/test.py role (weighted CE with
    TEST_CLASS_WEIGHTS, 5-class confusion matrix, accuracy =
    trace/sum)."""
    devices = training_devices(device, devices)
    params = params_from_jax(params, devices[0])
    loss, confusion, accuracy = _evaluate(
        make_polish_eval_step(devices=devices), params, images, labels,
        batch_size, process_count() * len(devices))
    return {"loss": loss, "confusion": confusion, "accuracy": accuracy}


def test_polish_on_arrays(options, images, labels, params, *,
                          batch_size: int = 16, device=None, devices=None):
    """test_polish_model on in-memory chunks and labels with a parameter
    tree (as load_params gives it); logs and returns its result."""
    result = evaluate_polish_model(params, images, labels,
                                   batch_size=batch_size, device=device,
                                   devices=devices)
    log_info(f"TEST LOSS: {result['loss']:.4f} "
             f"ACCURACY: {result['accuracy']:.2f}")
    log_info("CONFUSION MATRIX (rows=truth *ACGT, cols=pred):\n"
             + str(result["confusion"]))
    return result


def test_polish_model(options, image_dir: str, model_path: str, *,
                      batch_size: int = 16, device=None, devices=None):
    """CLI entry: evaluate one checkpoint on an image directory."""
    images, labels = load_polish_images(image_dir)
    params, _ = load_params(model_path)
    return test_polish_on_arrays(options, images, labels, params,
                                 batch_size=batch_size, device=device,
                                 devices=devices)


def run_polish_hyperband(options, image_dir: str, output_dir: str, *,
                         max_iter: int = 27, eta: int = 3, seed: int = 0,
                         batch_size: int = 16, device=None, devices=None):
    """Hyperband lr/l2 search over the polish TBPTT trainer — the
    reference's pepper run_hyperband.py:20-168 role, sharing the variant
    package's successive-halving engine (train/hyperband.py)."""
    from ..train.hyperband import Hyperband

    os.makedirs(output_dir, exist_ok=True)
    images, labels = load_polish_images(image_dir)

    def try_params(n_iterations, config):
        run_dir = os.path.join(output_dir, f"hb_{config['_id']}")
        checkpoint = train_polish_on_arrays(
            options, images, labels, run_dir, epochs=int(n_iterations),
            learning_rate=config["learning_rate"],
            weight_decay=config["weight_decay"], batch_size=batch_size,
            seed=seed, device=device, devices=devices)
        params, _ = load_params(checkpoint)
        result = evaluate_polish_model(params, images, labels,
                                       batch_size=batch_size, device=device,
                                       devices=devices)
        return {"loss": result["loss"], "accuracy": result["accuracy"],
                "checkpoint": checkpoint}

    best = Hyperband(try_params, max_iter=max_iter, eta=eta,
                     seed=seed).run()
    log_info(f"HYPERBAND BEST: acc={best['accuracy']:.3f} "
             f"config={best['config']} checkpoint={best['checkpoint']}")
    return best


def train_polish_model(options, image_dir: str, output_dir: str, *,
                       epochs: int = 10, learning_rate: float = 1e-4,
                       weight_decay: float = 0.0, batch_size: int = 16,
                       holdout_fraction: float = 0.2, seed: int = 0,
                       device=None, devices=None):
    """Train on the polish image stores under image_dir (the JAX
    package's train_polish_model); returns the final .npz path."""
    images, labels = load_polish_images(image_dir)
    return train_polish_on_arrays(
        options, images, labels, output_dir, epochs=epochs,
        learning_rate=learning_rate, weight_decay=weight_decay,
        batch_size=batch_size, holdout_fraction=holdout_fraction, seed=seed,
        device=device, devices=devices)


def train_polish_on_arrays(options, images, labels, output_dir: str, *,
                           epochs: int = 10, learning_rate: float = 1e-4,
                           weight_decay: float = 0.0, batch_size: int = 16,
                           holdout_fraction: float = 0.2, seed: int = 0,
                           device=None, devices=None):
    """train_polish_model on in-memory chunks (N, 1000, 10) and labels
    (N, 1000).  A seeded holdout_fraction is held out (at least one
    chunk); the params start from a torch.Generator seeded with `seed`.
    Only rank 0 writes the checkpoints."""
    devices = training_devices(device, devices)
    home = devices[0]
    os.makedirs(output_dir, exist_ok=True)
    log_info(f"TOTAL TRAINING CHUNKS: {len(images)}")

    rng = np.random.RandomState(seed)
    order = rng.permutation(len(images))
    n_test = max(1, int(len(images) * holdout_fraction))
    test_idx, train_idx = order[:n_test], order[n_test:]
    if len(train_idx) == 0:
        train_idx = test_idx

    # every process holds every chunk and takes its contiguous share of
    # each padded global batch; the gradients are summed over the group
    index, count = process_index(), process_count()
    n_devices = count * len(devices)
    if count > 1:
        log_info(f"MULTI-HOST POLISH TRAINING: host {index}/{count}, "
                 f"{n_devices} global devices")

    params = trainable_params(
        init_polish_params(torch.Generator().manual_seed(seed)), home)
    optimizer = torch.optim.Adam([leaf for _, leaf in leaves(params)],
                                 lr=learning_rate, weight_decay=weight_decay)
    tbptt_step = make_tbptt_step(optimizer, devices=devices)
    eval_step = make_polish_eval_step(devices=devices)

    def meta(**fields):
        return {**fields, "hidden_size": HIDDEN, "gru_layers": 1}

    for epoch in range(epochs):
        epoch_loss = 0.0
        perm = rng.permutation(train_idx)
        for start in range(0, len(perm), batch_size):
            batch = perm[start:start + batch_size]
            epoch_loss += tbptt_step(params, *_padded_batch(
                images[batch], labels[batch], n_devices))
        test_loss, _, accuracy = _evaluate(
            eval_step, params, images[test_idx], labels[test_idx],
            batch_size, n_devices)
        log_info(f"EPOCH {epoch + 1} TRAIN LOSS: {epoch_loss:.4f} "
                 f"TEST LOSS: {test_loss:.4f} ACCURACY: {accuracy:.2f}")
        if index == 0:
            save_params(os.path.join(
                output_dir, f"polish_epoch_{epoch + 1}_checkpoint.npz"),
                _host(params),
                meta(epochs=epoch + 1, accuracy=float(accuracy)))
    final_path = os.path.join(output_dir, "polish_model_final.npz")
    if index == 0:
        save_params(final_path, _host(params), meta(epochs=epochs))
    return final_path
