"""The port's train and eval steps (pepper_tpu_torch/train/step.py) and
its PlateauScheduler against the JAX package's, on the CPU.

The same params (JAX's init, through params_from_jax) and the same seeded
batch, with one padded row masked out, go through three optimizer steps
on both sides: optax's add_decayed_weights + adam against torch's
Adam(weight_decay), dropout 0, at the trainer's default learning rate
(1e-4; near g = 0 Adam moves a parameter by lr/eps = 1e4 times a
gradient's rounding).  Bars: the loss rtol 1e-5; each gradient
leaf within 2e-4 of its largest magnitude (the transducer's bar); the
params after the three steps atol 1e-5.  Covered: the lstm transducer
(26x33), the HP transducer (48x21), no_cnn and the transformer, at small
widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pepper_tpu.models import alternates as jalt
from pepper_tpu.models.transducer import TransducerConfig as JaxConfig
from pepper_tpu.models.transducer import init_transducer_params
from pepper_tpu.models.transducer import transducer_logits as j_logits
from pepper_tpu.train import step as jstep
from pepper_tpu.train.trainer import PlateauScheduler as JaxScheduler
from pepper_tpu_torch.models import alternates
from pepper_tpu_torch.train import step
from pepper_tpu_torch.train.trainer import PlateauScheduler, trainable_params

from test_torch_polish import one_intra_op_thread  # noqa: F401

LR, WD, STEPS = 1e-4, 1e-4, 3


def flat(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def decay_mask(tree):
    """The JAX trainer's mask: no weight decay on BatchNorm statistics."""
    return {k: (decay_mask(v) if isinstance(v, dict)
                else k not in ("mean", "var")) for k, v in tree.items()}


def batch(n, window, features, seed=0, pad=2):
    rng = np.random.RandomState(seed)
    images = rng.randint(-40, 41, (n, window, features)).astype(np.float32)
    labels = rng.randint(0, 3, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0.0
    return images, labels, mask


def jax_steps(params, images, labels, mask, logits_fn=None):
    """STEPS optax steps; returns (losses, grads before each step, params
    after the last)."""
    optimizer = optax.chain(optax.add_decayed_weights(WD, mask=decay_mask),
                            optax.adam(LR))
    opt_state = optimizer.init(params)
    train_step = jstep.make_train_step(optimizer, dropout_rate=0.0,
                                       logits_fn=logits_fn)

    def loss_fn(p):
        if logits_fn is None:
            logits = j_logits(p, images, train=True, dropout_rate=0.0,
                              rng=jax.random.PRNGKey(0))
        else:
            logits = logits_fn(p, images, True, None)
        return jstep.cross_entropy_sum(logits, jnp.asarray(labels),
                                       jnp.asarray(mask))

    grad_fn = jax.jit(jax.grad(loss_fn))
    losses, grads = [], []
    for _ in range(STEPS):
        grads.append(flat(grad_fn(params)))
        params, opt_state, metrics = train_step(
            params, opt_state, images, labels, jax.random.PRNGKey(1), mask)
        losses.append(float(metrics["loss"]))
    return losses, grads, flat(params)


def port_steps(tree, images, labels, mask, logits_fn=None, devices=None):
    params = trainable_params(tree, "cpu")
    optimizer = torch.optim.Adam(
        [leaf for _, leaf in step.leaves(params) if leaf.requires_grad],
        lr=LR, weight_decay=WD)
    train_step = step.make_train_step(optimizer, devices=devices,
                                      dropout_rate=0.0, logits_fn=logits_fn)
    losses, grads = [], []
    for _ in range(STEPS):
        metrics = train_step(params, images, labels, None, mask)
        losses.append(metrics["loss"])
        grads.append({path: leaf.grad.numpy().copy()
                      for path, leaf in step.leaves(params)
                      if leaf.requires_grad})
    return losses, grads, {path: leaf.detach().numpy()
                           for path, leaf in step.leaves(params)}


def assert_steps_match(ours, theirs):
    losses, grads, params = ours
    j_losses, j_grads, j_params = theirs
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for grad, j_grad in zip(grads, j_grads):
        for path, value in grad.items():
            bar = 2e-4 * max(np.abs(j_grad[path]).max(), 1e-30)
            assert np.abs(value - j_grad[path]).max() <= bar, path
    assert sorted(params) == sorted(j_params)
    for path, value in params.items():
        np.testing.assert_allclose(value, j_params[path], atol=1e-5,
                                   err_msg=str(path))


def small_transducer(hp=False):
    config = (JaxConfig(image_features=48, window=21, hidden=16,
                        linear_size=32) if hp else
              JaxConfig(hidden=16, linear_size=32))
    params = jax.tree_util.tree_map(np.asarray, init_transducer_params(
        jax.random.PRNGKey(3), config))
    return params, config


@pytest.mark.parametrize("hp", [False, True], ids=["lstm", "hp"])
def test_train_step_matches_jax_transducer(hp):
    params, config = small_transducer(hp)
    images, labels, mask = batch(12, config.window, config.image_features)
    assert_steps_match(port_steps(params, images, labels, mask),
                       jax_steps(params, images, labels, mask))


def _family(name):
    if name == "no_cnn":
        config = jalt.NoCnnConfig(hidden=16)
        params = jalt.init_no_cnn_params(jax.random.PRNGKey(5), config)
        return (params, config,
                lambda p, x, train, rng: jalt.no_cnn_logits(p, x),
                lambda p, x, train, g: alternates.no_cnn_logits(p, x))
    config = jalt.TransformerConfig(num_layers=2, ffn_size=64)
    port_config = alternates.TransformerConfig(num_layers=2, ffn_size=64)
    params = jalt.init_transformer_params(jax.random.PRNGKey(5), config)
    # dropout 0 on both sides: the family's train forward without draws
    return (params, config,
            lambda p, x, train, rng: jalt.transformer_logits(
                p, x, config=config, train=train, rng=None),
            lambda p, x, train, g: alternates.transformer_logits(
                p, x, config=port_config, train=train, generator=None))


@pytest.mark.parametrize("name", ["no_cnn", "transformer"])
def test_train_step_matches_jax_family(name):
    params, config, j_fn, fn = _family(name)
    params = jax.tree_util.tree_map(np.asarray, params)
    images, labels, mask = batch(12, config.window, config.image_features,
                                 seed=1)
    ours = port_steps(params, images, labels, mask, logits_fn=fn)
    assert_steps_match(ours, jax_steps(params, images, labels, mask,
                                       logits_fn=j_fn))
    if name == "transformer":
        # the BatchNorm statistics take no step
        for key in ("mean", "var"):
            np.testing.assert_array_equal(ours[2][("bn1", key)],
                                          params["bn1"][key])


def test_eval_step_matches_jax():
    params, config = small_transducer()
    images, labels, mask = batch(20, config.window, config.image_features,
                                 seed=2, pad=3)
    loss, confusion = step.make_eval_step()(
        trainable_params(params, "cpu"), images, labels, mask)
    j_loss, j_confusion = jstep.make_eval_step()(params, images, labels,
                                                 mask)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(confusion, np.asarray(j_confusion))
    assert confusion.sum() == 17 and confusion.dtype == np.int64


def test_two_devices_give_one_device_step():
    """One process over devices ["cpu", "cpu"]: each half of the batch on
    its own entry, the gradients summed, the one-device params within
    2e-4 (tests/test_multihost.py's bar), with dropout drawn over the
    global batch so both splits see the same masks."""
    params, config = small_transducer()
    images, labels, mask = batch(12, config.window, config.image_features,
                                 seed=4)
    runs = []
    for devices in (None, ["cpu", "cpu"]):
        tree = trainable_params(params, "cpu")
        optimizer = torch.optim.Adam(
            [leaf for _, leaf in step.leaves(tree)], lr=LR, weight_decay=WD)
        train_step = step.make_train_step(optimizer, devices=devices)
        generator = torch.Generator().manual_seed(7)
        for _ in range(STEPS):
            train_step(tree, images, labels, generator, mask)
        runs.append({p: leaf.detach().numpy() for p, leaf in step.leaves(tree)})
    for path, value in runs[0].items():
        np.testing.assert_allclose(runs[1][path], value, atol=2e-4,
                                   err_msg=str(path))


def test_global_dropout_hands_each_forward_its_rows():
    generator = torch.Generator().manual_seed(0)
    drops = step.GlobalDropout(generator, 6)
    drops.select(0, 6)
    whole = [drops.uniform((6, 4), "cpu"), drops.uniform((6, 2), "cpu")]
    drops.select(2, 5)
    part = [drops.uniform((3, 4), "cpu"), drops.uniform((3, 2), "cpu")]
    for a, b in zip(whole, part):
        np.testing.assert_array_equal(a[2:5].numpy(), b.numpy())
    with pytest.raises(ValueError, match="rows 2:5"):
        drops.uniform((4, 4), "cpu")


def test_plateau_scheduler_matches_jax():
    accuracies = [50.0, 60.0, 59.0, 58.0, 57.0, 61.0, 61.0, 61.0, 61.0,
                  70.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0]
    ours = PlateauScheduler(1e-3, min_lr=1e-3 * 0.75)
    theirs = JaxScheduler(1e-3, min_lr=1e-3 * 0.75)
    lrs = [ours.step(a) for a in accuracies]
    assert lrs == [theirs.step(a) for a in accuracies]
    assert lrs[-1] == 1e-3 * 0.75 and lrs[0] == 1e-3
    free = PlateauScheduler(1.0)
    assert [free.step(a) for a in (1, 1, 1, 1, 1, 1, 1)][-1] == \
        pytest.approx(0.01)


def test_cross_entropy_sum_matches_torch():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    labels = torch.tensor([0, 2, 1, 1, 0])
    expected = torch.nn.functional.cross_entropy(logits, labels,
                                                 reduction="sum")
    assert torch.allclose(step.cross_entropy_sum(logits, labels), expected)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0])
    kept = torch.nn.functional.cross_entropy(logits[mask > 0],
                                             labels[mask > 0],
                                             reduction="sum")
    assert torch.allclose(step.cross_entropy_sum(logits, labels, mask), kept)


def test_kernel_check_refuses_inputs_that_require_grad():
    """cuda_build.check_contiguous, which every kernel wrapper runs before
    a launch, raises for an input that requires grad while grad mode is
    on (a ctypes launch would return a tensor with no grad_fn)."""
    from pepper_tpu_torch.ops.cuda_build import check_contiguous

    w = torch.zeros(4, requires_grad=True)
    x = torch.zeros(4)
    check_contiguous((x,), x.device, "k")
    with pytest.raises(RuntimeError, match="k has no backward"):
        check_contiguous((x, w), x.device, "k")
    with torch.no_grad():
        check_contiguous((x, w), x.device, "k")
    with torch.inference_mode():
        check_contiguous((x, w), x.device, "k")
    with pytest.raises(RuntimeError, match="no backward"):
        check_contiguous((w * 2,), x.device, "k")


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("name", ["no_cnn", "transformer"])
def test_family_apply_matches_jax(name, train):
    """no_cnn_apply and transformer_apply: logits in train mode (the
    transformer without dropout draws), float32 probabilities otherwise,
    JAX's within 2e-4."""
    params, config, _, _ = _family(name)
    params = jax.tree_util.tree_map(np.asarray, params)
    x = batch(6, config.window, config.image_features, seed=3)[0]
    tparams = trainable_params(params, "cpu")
    with torch.no_grad():
        if name == "no_cnn":
            ours = alternates.no_cnn_apply(tparams, torch.from_numpy(x),
                                           train=train)
            theirs = jalt.no_cnn_apply(params, jnp.asarray(x), train=train)
        else:
            port_config = alternates.TransformerConfig(num_layers=2,
                                                       ffn_size=64)
            ours = alternates.transformer_apply(
                tparams, torch.from_numpy(x), config=port_config,
                train=train)
            theirs = jalt.transformer_apply(params, jnp.asarray(x),
                                            config=config, train=train)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-4,
                               rtol=2e-4)
    if not train:
        np.testing.assert_allclose(ours.sum(dim=1).numpy(), 1.0, atol=1e-5)
