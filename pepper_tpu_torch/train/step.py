"""Data-parallel training and eval steps for the window classifier, the
counterpart of the JAX package's train/step.py.

Semantics follow the reference trainer (pepper_variant/.../models/
train_distributed.py:107-168): Adam, CrossEntropyLoss with sum reduction
over the 3 type classes, periodic confusion-matrix eval.  Where the JAX
package jits one step over a mesh, here each device of a list runs the
forward and backward of its rows on its own view of the parameters; the
gradients are summed onto the first device, then over the processes of
the gloo group (parallel/dist.py:all_reduce_sum), and one optimizer step
follows.  The loss is a sum over the global padded batch (a {0,1} mask
keeps pad rows out), so its gradient is the sum of the per-device
gradients: summed, not averaged, two processes take the step one takes.

The training forward and backward run the eager recurrence (models/rnn.py's
lstm_scan through bilstm(allow_kernel=False)), the counterpart of JAX's
lax.scan: no kernel has a backward.  Evaluation is inference under
torch.inference_mode(): transducer_logits(train=False) runs the fused LSTM
kernel on cuda (ops/lstm_kernel.py:lstm_direction_fused, float32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.transducer import transducer_logits
from ..parallel.dist import all_reduce_sum, process_count, process_index
from ..parallel.mesh import make_global_batch


def cross_entropy_sum(logits, labels, mask=None):
    """torch.nn.CrossEntropyLoss(reduction='sum') with a {0,1} row mask."""
    logp = torch.log_softmax(logits, dim=-1)
    per_example = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is not None:
        per_example = per_example * mask
    return per_example.sum()


class GlobalDropout:
    """Dropout draws over the global padded batch.  Every rank seeds one
    generator alike and draws each mask at the global batch's size (the
    counterpart of JAX's step key over the global mesh); each device's
    forward takes its own rows of it, so how the rows are split over
    devices and processes does not change the masks."""

    def __init__(self, generator: torch.Generator, global_rows: int):
        self.generator = generator
        self.global_rows = global_rows
        self.rows = (0, global_rows)
        self._draws = []
        self._next = 0

    def select(self, start: int, stop: int) -> None:
        """The global rows of the next forward, whose draws start again
        from the step's first mask."""
        self.rows = (start, stop)
        self._next = 0

    def uniform(self, shape, device):
        start, stop = self.rows
        if shape[0] != stop - start:
            raise ValueError(f"a dropout draw of {shape[0]} rows for the "
                             f"rows {start}:{stop}")
        if self._next == len(self._draws):
            self._draws.append(torch.rand(
                (self.global_rows, *shape[1:]), generator=self.generator,
                device=self.generator.device))
        draw = self._draws[self._next]
        self._next += 1
        return draw[start:stop].to(device)


def leaves(params, prefix=()):
    """(path, tensor) of every leaf of a parameter tree, in key order."""
    for key, value in params.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def tree_device(params) -> torch.device:
    return next(leaves(params))[1].device


def _on_device(params, device, grad=False):
    """The tree itself where it lives on `device`, else a copy there; with
    `grad`, the copy's leaves require grad as the originals do."""
    if tree_device(params) == torch.device(device):
        return params
    return {key: (_on_device(value, device, grad) if isinstance(value, dict)
                  else value.detach().to(device).requires_grad_(
                      grad and value.requires_grad))
            for key, value in params.items()}


def _devices(devices, params):
    return ([torch.device(d) for d in devices] if devices
            else [tree_device(params)])


def make_train_step(optimizer: torch.optim.Optimizer, devices=None,
                    dropout_rate=0.2, logits_fn=None):
    """Returns step(params, images, labels, generator, mask) -> metrics.

    params: the tree whose leaves `optimizer` holds (on devices[0]).
    images, labels, mask: this process's rows of the padded global batch
    as host arrays, split here over `devices` (default: params' device).
    generator: a torch.Generator for the dropout draws, or None.
    logits_fn(params, x, train, generator) selects the model family
    (models/registry.py); default is the live LSTM transducer."""

    def logits_of(params, x, generator):
        if logits_fn is None:
            return transducer_logits(params, x, train=True,
                                     dropout_rate=dropout_rate,
                                     generator=generator)
        return logits_fn(params, x, True, generator)

    def step(params, images, labels, generator, mask):
        targets = _devices(devices, params)
        home = targets[0]
        xs = make_global_batch(images, targets)
        ys = make_global_batch(labels, targets)
        ms = make_global_batch(mask, targets)
        local_rows = len(images)
        start = process_index() * local_rows
        drops = (None if generator is None else
                 GlobalDropout(generator, local_rows * process_count()))
        trainable = [leaf for _, leaf in leaves(params)
                     if leaf.requires_grad]
        grads = None
        totals = torch.zeros(3, dtype=torch.float64, device=home)
        for x, y, m in zip(xs, ys, ms):
            replica = _on_device(params, x.device, grad=True)
            if drops is not None:
                drops.select(start, start + len(x))
            start += len(x)
            logits = logits_of(replica, x, drops)
            loss = cross_entropy_sum(logits, y, m)
            replica_leaves = [leaf for _, leaf in leaves(replica)
                              if leaf.requires_grad]
            shard = torch.autograd.grad(loss, replica_leaves,
                                        allow_unused=True)
            # an unused leaf takes a zero gradient, as JAX's grad gives it
            # (Adam then still applies its weight decay)
            shard = [torch.zeros_like(leaf) if g is None else g
                     for g, leaf in zip(shard, replica_leaves)]
            shard = [g.to(home) for g in shard]
            grads = shard if grads is None else [
                a + b for a, b in zip(grads, shard)]
            correct = ((logits.argmax(dim=-1) == y) * m).sum()
            totals += torch.stack([loss.detach(), correct.detach(),
                                   m.sum()]).double().to(home)
        if process_count() > 1:
            summed = all_reduce_sum(
                [g.cpu().numpy() for g in grads] + [totals.cpu().numpy()])
            grads = [torch.from_numpy(g).to(home) for g in summed[:-1]]
            totals = torch.from_numpy(summed[-1])
        for leaf, grad in zip(trainable, grads):
            leaf.grad = grad
        optimizer.step()
        loss, correct, count = totals.tolist()
        return {"loss": loss, "correct": correct, "count": count}

    return step


def make_eval_step(num_classes=3, devices=None, logits_fn=None):
    """Returns step(params, images, labels, mask) -> (loss, confusion):
    the masked cross-entropy sum and the (num_classes, num_classes) int64
    confusion matrix (confusion[label, pred] += mask, torchnet's
    ConfusionMeter in the reference evaluator, models/test.py:35-108),
    summed over the devices and the processes.  Arguments as the train
    step's."""

    def logits_of(params, x):
        if logits_fn is None:
            return transducer_logits(params, x, train=False)
        return logits_fn(params, x, False, None)

    def step(params, images, labels, mask):
        targets = _devices(devices, params)
        parts = []
        with torch.inference_mode():
            for x, y, m in zip(make_global_batch(images, targets),
                               make_global_batch(labels, targets),
                               make_global_batch(mask, targets)):
                logits = logits_of(_on_device(params, x.device), x)
                loss = cross_entropy_sum(logits.float(), y, m)
                confusion = torch.zeros((num_classes, num_classes),
                                        dtype=torch.int64, device=x.device)
                confusion.index_put_((y.long(), logits.argmax(dim=-1)),
                                     m.long(), accumulate=True)
                parts.append((loss, confusion))
        loss = sum(float(part[0]) for part in parts)
        confusion = sum(part[1].cpu().numpy() for part in parts)
        loss, confusion = all_reduce_sum([np.float64(loss), confusion])
        return float(loss), confusion

    return step
