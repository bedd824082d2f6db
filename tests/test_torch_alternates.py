"""The no_cnn and transformer families (models/alternates.py, the registry)
and the unfused biLSTM over the recurrence kernel (bilstm_pallas, reached
through models/rnn.py's bilstm) against the JAX package, on the CPU, at both image shapes (26x33 and HP's 48x21).

Bars: float32 probabilities within 2e-4 of JAX's family.infer (the
transducer's bar), bfloat16 within 1e-2; BatchNorm calibration within
1e-6 of the float64 statistics (see its test); state-dict conversion bit
for bit; call_variant's records equal to
JAX's; bilstm through lstm_recurrence's twin within 1e-5 of JAX's bilstm
(the float32 kernel bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import alternates as jalt
from pepper_tpu.models import registry as jregistry
from pepper_tpu.models import rnn as jrnn
from pepper_tpu.models import transducer as jtrans
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.pipeline import call_variant as jcv
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.cli import main as cli
from pepper_tpu_torch.models import alternates, registry, rnn, transducer
from pepper_tpu_torch.models.checkpoint import save_params
from pepper_tpu_torch.models.params import params_from_jax
from pepper_tpu_torch.ops import lstm_kernel

from test_torch_call_variant import (CONTIG, _assert_same_calls, _options,  # noqa: F401
                                     _records, sim)
from test_torch_checkpoint_pkl import (_linear_state, _rnn_state,
                                       _uniform, assert_trees_equal)

SHAPES = [(26, 33), (48, 21)]
SHAPE_IDS = ["variant", "hp"]


def _family_params(name, features, window, seed=0):
    family = jregistry.make_family(name, features, window)
    return family, jax.tree_util.tree_map(
        np.array, family.init(jax.random.PRNGKey(seed)))


def _windows(n, window, features, seed):
    return np.random.RandomState(seed).randint(
        -100, 100, (n, window, features)).astype(np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-4),
                                        ("bfloat16", 1e-2)])
@pytest.mark.parametrize("features,window", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("name", ["no_cnn", "transformer"])
def test_family_infer_matches_jax(name, features, window, dtype, atol):
    jfamily, params = _family_params(name, features, window)
    x = _windows(6, window, features, 1)
    expected = jfamily.infer(jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(x), getattr(jnp, dtype))
    family = registry.make_family(name, features, window)
    actual = family.infer(params_from_jax(params, "cpu"),
                          torch.from_numpy(x), getattr(torch, dtype))
    assert actual.dtype == torch.float32 and actual.shape == (6, 3)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["no_cnn", "transformer"])
def test_family_init_shapes_match_jax(name):
    _, params = _family_params(name, 48, 21)
    ours = registry.make_family(name, 48, 21).init(
        torch.Generator().manual_seed(0))

    def shapes(tree):
        return {key: shapes(value) if isinstance(value, dict)
                else tuple(value.shape) for key, value in tree.items()}

    assert shapes(ours) == shapes(params)


def test_transformer_train_logits_match_jax():
    """Train mode without a generator: BatchNorm from the batch's own
    statistics, no dropout."""
    jfamily, params = _family_params("transformer", 26, 33, seed=3)
    x = _windows(5, 33, 26, 4) / 32.0
    expected = jfamily.logits(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x), True, None)
    actual = registry.make_family("transformer").logits(
        params_from_jax(params, "cpu"), torch.from_numpy(x), True, None)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=2e-4, atol=2e-4)
    dropped = registry.make_family("transformer").logits(
        params_from_jax(params, "cpu"), torch.from_numpy(x), True,
        torch.Generator().manual_seed(0))
    assert dropped.shape == (5, 3) and not torch.equal(dropped, actual)


def _exact_batchnorm_stats(params, x):
    """The calibration's statistics in float64: the bar's yardstick."""
    tree = {key: torch.from_numpy(np.asarray(params[key], np.float64))
            for key in ("conv1", "conv2")}
    out = torch.nn.functional.conv2d(
        torch.from_numpy(x.astype(np.float64))[:, None], tree["conv1"],
        padding=1)
    stats = {"bn1": (out.mean((0, 2, 3)), out.var((0, 2, 3), correction=0))}
    bn1 = {key: torch.from_numpy(np.asarray(params["bn1"][key], np.float64))
           for key in ("gamma", "beta")}
    scale = bn1["gamma"] / torch.sqrt(stats["bn1"][1] + 1e-5)
    out = torch.relu((out - stats["bn1"][0][:, None, None]) * scale[:, None,
                                                                    None]
                     + bn1["beta"][:, None, None])
    out = torch.nn.functional.conv2d(out, tree["conv2"], padding=1)
    stats["bn2"] = (out.mean((0, 2, 3)), out.var((0, 2, 3), correction=0))
    return stats


@pytest.mark.parametrize("features,window", SHAPES, ids=SHAPE_IDS)
def test_transformer_calibrate_batchnorm_matches_jax(features, window):
    """Running statistics of int8-range windows (conv outputs ~1e3): the
    port's within 1e-6 (relative) of the float64 statistics, and JAX's
    float32 ones within their own error of those (measured up to 2e-6
    relative on these inputs, so the two are held to 5e-6 of each other);
    gamma and beta pass through unchanged."""
    _, params = _family_params("transformer", features, window, seed=5)
    x = _windows(16, window, features, 6)
    expected = jalt.transformer_calibrate_batchnorm(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    actual = registry.make_family("transformer", features, window).calibrate(
        params_from_jax(params, "cpu"), x)
    exact = _exact_batchnorm_stats(params, x)
    for bn in ("bn1", "bn2"):
        for index, key in enumerate(("mean", "var")):
            np.testing.assert_allclose(actual[bn][key].numpy(),
                                       exact[bn][index].numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(actual[bn][key].numpy(),
                                       np.asarray(expected[bn][key]),
                                       rtol=5e-6, atol=1e-6)
        for key in ("gamma", "beta"):
            np.testing.assert_array_equal(actual[bn][key].numpy(),
                                          np.asarray(expected[bn][key]))
    assert actual["layers"].keys() == params["layers"].keys()


def _no_cnn_state(seed, features=26, window=33, hidden=16):
    rng = np.random.RandomState(seed)
    state = {**_rnn_state(rng, "encoder", 4, features, hidden),
             **_rnn_state(rng, "decoder", 4, features, hidden)}
    sizes = (2 * hidden * window, 256, 128, 64, 32, 16)
    for i in range(5):
        state.update(_linear_state(rng, f"linear_{i + 1}", sizes[i],
                                   sizes[i + 1]))
    state.update(_linear_state(rng, "output_layer", 16, 3))
    return {"module." + key: value for key, value in state.items()}


def _transformer_state(seed, features=26, window=33, layers=2, ffn=32):
    rng = np.random.RandomState(seed)
    D = 4 * features
    state = {"conv1.weight": _uniform(rng, (4, 1, 3, 3), 9),
             "conv2.weight": _uniform(rng, (4, 4, 3, 3), 36)}
    for bn in ("bn1", "bn2"):
        state[f"{bn}.weight"] = _uniform(rng, (4,), 1)
        state[f"{bn}.bias"] = _uniform(rng, (4,), 1)
        state[f"{bn}.running_mean"] = _uniform(rng, (4,), 1)
        state[f"{bn}.running_var"] = rng.uniform(0.5, 2, 4).astype(np.float32)
    for i in range(layers):
        pre = f"encoder.layers.{i}"
        state[f"{pre}.self_attn.in_proj_weight"] = _uniform(rng, (3 * D, D),
                                                            D)
        state[f"{pre}.self_attn.in_proj_bias"] = _uniform(rng, (3 * D,), D)
        state.update(_linear_state(rng, f"{pre}.self_attn.out_proj", D, D))
        state.update(_linear_state(rng, f"{pre}.linear1", D, ffn))
        state.update(_linear_state(rng, f"{pre}.linear2", ffn, D))
        for norm in ("norm1", "norm2"):
            state[f"{pre}.{norm}.weight"] = _uniform(rng, (D,), 1)
            state[f"{pre}.{norm}.bias"] = _uniform(rng, (D,), 1)
    sizes = (D * window, 128, 64, 32, 16, 8)
    for i in range(5):
        state.update(_linear_state(rng, f"linear_{i + 1}", sizes[i],
                                   sizes[i + 1]))
    state.update(_linear_state(rng, "output_layer", 8, 3))
    return state


@pytest.mark.parametrize("values", ["numpy", "tensor"])
def test_params_from_state_dict_bit_equal(values):
    for convert, state in (("no_cnn_params_from_state_dict",
                            _no_cnn_state(7)),
                           ("transformer_params_from_state_dict",
                            _transformer_state(8))):
        if values == "tensor":
            state = {key: torch.from_numpy(value)
                     for key, value in state.items()}
        ours = getattr(alternates, convert)(state)
        assert_trees_equal(ours, getattr(jalt, convert)(state))
    assert sorted(ours["layers"]) == ["0", "1"]


def test_converted_transformer_infers_as_jax():
    """A converted checkpoint (two layers, running stats that are not the
    init's) through the registry in float32."""
    params = jalt.transformer_params_from_state_dict(_transformer_state(9))
    x = _windows(4, 33, 26, 10)
    expected = jregistry.make_family("transformer").infer(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    actual = registry.make_family("transformer").infer(
        params_from_jax(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["no_cnn", "transformer"])
def test_cli_model_type_matches_jax_calls(sim, name):  # noqa: F811
    """call_variant with a checkpoint whose metadata names the family (the
    CLI sets --model_type from it) writes the JAX package's records."""
    _, params = _family_params(name, 26, 33, seed=11)
    model = str(sim["tmp"] / f"model_{name}.npz")
    save_params(model, params, {"model_type": name})
    out, theirs = sim["tmp"] / f"cli_{name}", sim["tmp"] / f"jax_{name}"
    assert cli.main(["call_variant", "-b", sim["bam"], "-f", sim["fasta"],
                     "-m", model, "-o", str(out), "-s", "SAMPLE",
                     "-r", CONTIG, "--ont_r9_guppy5_sup",
                     "--compute_dtype", "float32", "--device", "cpu"]) == 0
    jcv.call_variant(_options(JaxOptions, jax_set_parameters, sim, theirs,
                              model_type=name), params=params)
    assert _records(out, "PEPPER_VARIANT_FULL")
    _assert_same_calls(out, theirs)


def test_quantized_other_families_raise_value_error():
    from pepper_tpu_torch.infer.runner import InferenceRunner

    _, params = _family_params("no_cnn", 26, 33)
    with pytest.raises(ValueError, match="lstm family"):
        InferenceRunner(params, quantized=True, model_type="no_cnn",
                        device="cpu")


# ---------------------------------------------------------------- bilstm


@pytest.mark.parametrize("batch,hidden,timesteps,features",
                         [(16, 64, 33, 26), (8, 32, 21, 48)])
def test_bilstm_kernel_path_matches_jax(monkeypatch, batch, hidden,
                                        timesteps, features):
    """PEPPER_LSTM_KERNEL=1 takes bilstm_pallas (lstm_recurrence, on the
    CPU its twin); =0 and the CPU's auto take the eager scans."""
    params = jrnn.init_lstm_params(jax.random.PRNGKey(0), features, hidden)
    x = np.random.RandomState(1).randn(batch, timesteps, features).astype(
        np.float32)
    expected = np.asarray(jrnn.bilstm(jnp.asarray(x), params,
                                      allow_kernel=False))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    before = lstm_kernel.lstm_recurrence.launches
    monkeypatch.setenv("PEPPER_LSTM_KERNEL", "1")
    assert lstm_kernel.use_pallas_lstm("cpu")
    actual = rnn.bilstm(torch.from_numpy(x), tparams)
    assert actual.shape == (batch, timesteps, 2 * hidden)
    np.testing.assert_allclose(actual.numpy(), expected, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        lstm_kernel.bilstm_pallas(torch.from_numpy(x), tparams).numpy(),
        actual.numpy(), rtol=0, atol=0)
    monkeypatch.setenv("PEPPER_LSTM_KERNEL", "auto")
    assert not lstm_kernel.use_pallas_lstm("cpu")
    assert lstm_kernel.use_pallas_lstm("cuda")
    monkeypatch.setenv("PEPPER_LSTM_KERNEL", "0")
    assert not lstm_kernel.use_pallas_lstm("cuda")
    # the twins run on the CPU: no launch is counted
    assert lstm_kernel.lstm_recurrence.launches == before


def test_transducer_train_path_takes_eager_bilstm(monkeypatch):
    """transducer_logits(train=True) runs the eager bilstm whatever
    PEPPER_LSTM_KERNEL says (no kernel and no twin), equal to JAX's train
    path without dropout at the HP shape in float32 at the transducer's
    bar; inference keeps the fused path."""
    params = jax.tree_util.tree_map(np.array, jtrans.init_transducer_params(
        jax.random.PRNGKey(4), jtrans.TransducerConfig(
            image_features=48, window=21, hidden=32, linear_size=64)))
    x = _windows(6, 21, 48, 5) / 16.0
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    expected = np.asarray(jtrans.transducer_logits(jparams, jnp.asarray(x),
                                                   train=True))
    tparams = params_from_jax(params, "cpu")
    monkeypatch.setenv("PEPPER_LSTM_KERNEL", "1")
    monkeypatch.setattr(lstm_kernel, "bilstm_pallas", None)
    actual = transducer.transducer_logits(tparams, torch.from_numpy(x),
                                          train=True)
    np.testing.assert_allclose(actual.numpy(), expected, rtol=2e-4,
                               atol=2e-4)
    fused = transducer.transducer_logits(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(fused.numpy(), actual.numpy(), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------- the polish ResNet and Seq2Seq


def _trained_bn(model, run):
    """A reference module with BatchNorm statistics of one train-mode
    pass (tests/test_alternate_models.py), in eval mode."""
    model.train()
    with torch.no_grad():
        run(model)(torch.randn(4, 1, 16, 20))
    return model.eval()


def _resnet_module():
    from test_alternate_models import TorchResNet

    torch.manual_seed(3)
    return _trained_bn(TorchResNet(), lambda m: m)


def _seq2seq_module():
    from test_alternate_models import TorchSeq2Seq

    torch.manual_seed(4)
    return _trained_bn(TorchSeq2Seq(), lambda m: m.encode)


def _assert_same_tree(ours, theirs, exact=True):
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert np.shape(a) == np.shape(b)
        if exact:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resnet_and_seq2seq_converters_bit_equal():
    for module, convert in (
            (_resnet_module(), "resnet_params_from_state_dict"),
            (_seq2seq_module(), "seq2seq_params_from_state_dict")):
        state = module.state_dict()
        _assert_same_tree(getattr(alternates, convert)(state),
                          getattr(jalt, convert)(state))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_apply_matches_jax_and_torch(train):
    model = _resnet_module()
    params = jalt.resnet_params_from_state_dict(model.state_dict())
    x = np.random.default_rng(2).normal(size=(2, 1, 16, 20)).astype(
        np.float32)
    ours = alternates.resnet_apply(params_from_jax(params, "cpu"),
                                   torch.from_numpy(x), train=train)
    theirs = jalt.resnet_apply(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(x), train=train)
    assert ours.shape == (2, 1, 16, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)
    if not train:
        with torch.no_grad():
            np.testing.assert_allclose(
                ours.numpy(), model(torch.from_numpy(x)).numpy(), atol=2e-5)


def test_seq2seq_encode_and_decode_step_match_jax_and_torch():
    model = _seq2seq_module()
    params = jalt.seq2seq_params_from_state_dict(model.state_dict())
    tree = params_from_jax(params, "cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 1, 16, 20)).astype(np.float32)
    ctx, hidden = alternates.seq2seq_encode(tree, torch.from_numpy(images))
    j_ctx, j_hidden = jalt.seq2seq_encode(jtree, jnp.asarray(images))
    with torch.no_grad():
        t_ctx, t_hidden = model.encode(torch.from_numpy(images))
    for ours, theirs, reference in ((ctx, j_ctx, t_ctx),
                                    (hidden[0], j_hidden[0], t_hidden[0]),
                                    (hidden[1], j_hidden[1], t_hidden[1])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=2e-5)
        np.testing.assert_allclose(ours.numpy(), reference.numpy(),
                                   atol=2e-5)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=2)]
    logits, h2, attn = alternates.seq2seq_decode_step(
        tree, torch.from_numpy(onehot), ctx, hidden)
    j_logits, j_h2, j_attn = jalt.seq2seq_decode_step(
        jtree, jnp.asarray(onehot), j_ctx, j_hidden)
    with torch.no_grad():
        t_logits, t_h2 = model.decode_step(torch.from_numpy(onehot), t_ctx,
                                           t_hidden)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=2e-5)
    np.testing.assert_allclose(logits.numpy(), t_logits.numpy(), atol=2e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(j_attn), atol=2e-5)
    for d in (0, 1):
        np.testing.assert_allclose(h2[d].numpy(), np.asarray(j_h2[d]),
                                   atol=2e-5)
        np.testing.assert_allclose(h2[d].numpy(), t_h2[d].numpy(), atol=2e-5)
    assert attn.shape == (2, 1, 16)


def test_resnet_and_seq2seq_init_shapes_match_jax():
    _assert_same_tree(
        alternates.init_resnet_params(torch.Generator().manual_seed(0)),
        jalt.init_resnet_params(jax.random.PRNGKey(0)), exact=False)
    config = alternates.Seq2SeqConfig(hidden=16)
    params = alternates.init_seq2seq_params(torch.Generator().manual_seed(0),
                                            config)
    _assert_same_tree(params, jalt.init_seq2seq_params(
        jax.random.PRNGKey(0), jalt.Seq2SeqConfig(hidden=16)), exact=False)
    ctx, hidden = alternates.seq2seq_encode(params, torch.zeros(2, 1, 12, 20))
    assert ctx.shape == (2, 12, 16)
    logits, hidden, _ = alternates.seq2seq_decode_step(
        params, torch.eye(5)[[0, 3]], ctx, hidden)
    assert logits.shape == (2, 5)


def test_attention_softmax_runs_in_float32_for_bfloat16():
    """The attention softmax takes at least float32, as the transformer's
    does: bfloat16 scores give the float32 weights rounded once."""
    rng = np.random.default_rng(5)
    output = torch.from_numpy(rng.normal(size=(2, 1, 8)).astype(np.float32))
    context = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32))
    linear = {"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(
        np.float32)), "b": torch.zeros(8)}
    _, attn = alternates._attention(
        output.bfloat16(), context.bfloat16(),
        {k: v.bfloat16() for k, v in linear.items()})
    scores = torch.einsum("bod,bid->boi", output.bfloat16(),
                          context.bfloat16()).float()
    assert attn.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        attn.float().numpy(),
        torch.softmax(scores, dim=-1).bfloat16().float().numpy())
