"""The port's int8 serving (models/quantize.py and the int8 kernels'
twins) against the JAX package.

Inputs are made with numpy from a seed and fed to both.  On the CPU the
JAX package's quantized modes run lax.scan fallbacks whose bf16 math is not
its TPU kernels' (the static fallback keeps W_hh in f32, the dynamic one
carries bf16 state); the port follows the kernels, so it is held to the
JAX kernels run in interpret mode.  Bars:

  * quantizers: equal to JAX's leaf for leaf, bit for bit;
  * int8 codes: within 1 of JAX's everywhere and at least 99.9% equal
    (99.5% when the recurrence is int8 too: it feeds its own codes back,
    so a summation-order difference at a rounding tie can flip a code;
    the JAX suite's own bar, tests/test_quantize_static.py:116-120);
  * float outputs: atol 1e-5 (f32, summation order) and 2e-2 (bf16, one
    rounding of h may fall on either side);
  * probabilities: atol 2e-4 (f32) and 1e-2 (bf16, and the dynamic mode,
    whose recurrence is always bf16), argmax equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import quantize as jq
from pepper_tpu.models import rnn as jrnn
from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.ops import lstm_kernel as jk
from pepper_tpu_torch.models import quantize
from pepper_tpu_torch.models.transducer import params_from_jax
from pepper_tpu_torch.ops import lstm_kernel
from pepper_tpu_torch.ops.int8_matmul import int8_matmul

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CODE_BARS = {False: 0.999, True: 0.995}    # equal share, by rec_int8
H = 32


def _jax_params(seed, **config):
    config = {"hidden": H, "linear_size": 64, **config}
    return jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(seed), TransducerConfig(**config)))


def _windows(n, seed):
    return np.random.RandomState(seed).randint(
        -125, 126, (n, 33, 26)).astype(np.int8)


def _torch(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _assert_tree_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key, value in theirs.items():
        if isinstance(value, dict):
            _assert_tree_equal(ours[key], value)
        elif value is None:
            assert ours[key] is None, key
        else:
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)


# ---------------------------------------------------------------- quantizers


@pytest.mark.parametrize("rec_int8", [False, True])
def test_quantize_params_static_matches_jax(rec_int8):
    params = _jax_params(0)
    tree = quantize.quantize_params_static(params, rec_int8=rec_int8)
    _assert_tree_equal(tree, jq.quantize_params_static(params,
                                                       rec_int8=rec_int8))
    assert tree["linear_1"]["as"].shape == (64,)
    assert tree["decoder"]["w_ih_f"].dtype == np.int8
    assert (tree["encoder"]["w_hh_f"].dtype == np.int8) == rec_int8


def test_quantize_params_matches_jax():
    params = _jax_params(1)
    q, s = quantize.quantize_params(params)
    jq_, js = jq.quantize_params(params)
    _assert_tree_equal(q, jq_)
    _assert_tree_equal(s, js)
    # w_hh stays float although the "w" prefix would match it
    assert q["encoder"]["w_hh_f"].dtype == np.float32
    assert s["encoder"]["w_hh_f"] is None
    assert q["encoder"]["w_ih_f"].dtype == np.int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_params_matches_jax(dtype):
    jdtype, tdtype, _ = DTYPES[dtype]
    q, s = jq.quantize_params(_jax_params(2))
    ours = quantize.dequantize_params(q, s, tdtype)
    theirs = jq.dequantize_params(q, s, jdtype)
    for layer, node in theirs.items():
        for key, value in node.items():
            assert ours[layer][key].dtype == tdtype
            np.testing.assert_array_equal(
                ours[layer][key].float().numpy(),
                np.asarray(value, np.float32), err_msg=f"{layer}/{key}")


@pytest.mark.parametrize("M,K,N", [(5, 26, 3), (16, 512, 64),
                                   (4, 33 * 64, 64)])
def test_int8_matmul_is_exact(M, K, N):
    rng = np.random.RandomState(M)
    a = rng.randint(-127, 128, (M, K)).astype(np.int8)
    b = rng.randint(-127, 128, (K, N)).astype(np.int8)
    out = int8_matmul(_torch(a), _torch(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(TypeError):
        int8_matmul(_torch(a).float(), _torch(b))


# ---------------------------------------------------------------- kernels


def _static_inputs(seed, T, B, x_int8, rec_int8, n_parts):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(H)
    if x_int8:
        feats = [H] * n_parts
        xs = [rng.randint(-127, 128, (T, B, f)).astype(np.int8)
              for f in feats]
        w_q, w_scale = jq._quantize_cols(
            rng.uniform(-s, s, (sum(feats), 4 * H)))
        ws = np.split(w_q, np.cumsum(feats)[:-1])
        acc_scale = (w_scale / 127.0).reshape(-1)
    else:
        feats = [26] if n_parts == 1 else [10, 16]
        xs = [rng.randint(-125, 126, (T, B, f)).astype(np.float32)
              for f in feats]
        ws = [rng.uniform(-s, s, (f, 4 * H)).astype(np.float32)
              for f in feats]
        acc_scale = None
    w_hh = rng.uniform(-s, s, (H, 4 * H)).astype(np.float32)
    rec_scale = None
    if rec_int8:
        w_hh, r_scale = jq._quantize_cols(w_hh)
        rec_scale = (r_scale / 127.0).reshape(-1)
    b = rng.uniform(-2 * s, 2 * s, 4 * H).astype(np.float32)
    return xs, ws, b, w_hh, acc_scale, rec_scale


def _run_static_pair(dtype, x_int8, rec_int8, n_parts, reverse, out_int8,
                     T=33, B=8):
    jdtype, tdtype, _ = DTYPES[dtype]
    xs, ws, b, w_hh, acc_scale, rec_scale = _static_inputs(
        T * 3 + n_parts, T, B, x_int8, rec_int8, n_parts)

    def cast_j(a):
        return jnp.asarray(a) if a.dtype == np.int8 else jnp.asarray(a,
                                                                      jdtype)

    def cast_t(a):
        return _torch(a) if a.dtype == np.int8 else _torch(a, tdtype)

    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    expected = jk.lstm_direction_fused_static(
        tuple(cast_j(x) for x in xs), tuple(cast_j(w) for w in ws),
        jnp.asarray(b), cast_j(w_hh), acc_scale=opt(acc_scale, jnp.asarray),
        rec_scale=opt(rec_scale, jnp.asarray), reverse=reverse,
        out_int8=out_int8, out_dtype=jdtype, interpret=True)
    actual = lstm_kernel.lstm_direction_fused_static_reference(
        tuple(cast_t(x) for x in xs), tuple(cast_t(w) for w in ws),
        _torch(b), cast_t(w_hh), acc_scale=opt(acc_scale, _torch),
        rec_scale=opt(rec_scale, _torch), reverse=reverse, out_int8=out_int8,
        out_dtype=tdtype)
    assert actual.shape == (T, B, H)
    assert actual.dtype == (torch.int8 if out_int8 else tdtype)
    return actual, expected


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("x_int8,rec_int8", [(False, False), (False, True),
                                             (True, False), (True, True)],
                         ids=["float_x-float_rec", "float_x-int8_rec",
                              "int8_x-float_rec", "int8_x-int8_rec"])
def test_static_twin_codes_match_jax_kernel(x_int8, rec_int8, n_parts,
                                            reverse, dtype, record_property):
    actual, expected = _run_static_pair(dtype, x_int8, rec_int8, n_parts,
                                        reverse, out_int8=True)
    diff = np.abs(actual.numpy().astype(np.int32)
                  - np.asarray(expected, np.int32))
    equal = float((diff == 0).mean())
    record_property("equal_fraction", equal)
    assert diff.max() <= 1
    assert equal >= CODE_BARS[rec_int8], equal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("x_int8,rec_int8", [(False, False), (False, True),
                                             (True, False), (True, True)],
                         ids=["float_x-float_rec", "float_x-int8_rec",
                              "int8_x-float_rec", "int8_x-int8_rec"])
def test_static_twin_float_output_matches_jax_kernel(x_int8, rec_int8,
                                                     reverse, dtype):
    actual, expected = _run_static_pair(dtype, x_int8, rec_int8,
                                        2 if x_int8 else 1, reverse,
                                        out_int8=False)
    np.testing.assert_allclose(actual.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,B", [(33, 8), (7, 16)])
def test_recurrence_twin_matches_jax_kernel(T, B, dtype):
    jdtype, tdtype, atol = DTYPES[dtype]
    rng = np.random.RandomState(T + B)
    xw = rng.randn(T, B, 4 * H).astype(np.float32)
    w_hh = rng.uniform(-0.2, 0.2, (H, 4 * H)).astype(np.float32)
    expected = jk.lstm_recurrence_pallas(
        jnp.asarray(xw, jdtype), jnp.asarray(w_hh, jdtype), interpret=True)
    actual = lstm_kernel.lstm_recurrence_reference(_torch(xw, tdtype),
                                                   _torch(w_hh, tdtype))
    assert actual.dtype == tdtype and actual.shape == (T, B, H)
    np.testing.assert_allclose(actual.float().numpy(),
                               np.asarray(expected, np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,B", [(33, 8), (7, 16)])
def test_recurrence_twin_reverse_matches_jax_flipped_kernel(T, B, dtype):
    """reverse=True steps t = T-1..0: what the JAX package's callers get
    from flipping xw, running lstm_recurrence_pallas forward and flipping
    its output back."""
    jdtype, tdtype, atol = DTYPES[dtype]
    rng = np.random.RandomState(T * B)
    xw = rng.randn(T, B, 4 * H).astype(np.float32)
    w_hh = rng.uniform(-0.2, 0.2, (H, 4 * H)).astype(np.float32)
    expected = jnp.flip(jk.lstm_recurrence_pallas(
        jnp.flip(jnp.asarray(xw, jdtype), 0), jnp.asarray(w_hh, jdtype),
        interpret=True), 0)
    actual = lstm_kernel.lstm_recurrence_reference(
        _torch(xw, tdtype), _torch(w_hh, tdtype), reverse=True)
    assert actual.dtype == tdtype and actual.shape == (T, B, H)
    np.testing.assert_allclose(actual.float().numpy(),
                               np.asarray(expected, np.float32), atol=atol)
    flipped = lstm_kernel.lstm_recurrence_reference(
        _torch(xw[::-1], tdtype), _torch(w_hh, tdtype)).flip(0)
    assert torch.equal(actual, flipped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [(26,), (H, H)], ids=["encoder",
                                                        "decoder"])
def test_dual_twin_matches_jax_kernel(parts, dtype):
    jdtype, tdtype, atol = DTYPES[dtype]
    params = jax.tree_util.tree_map(np.array, jrnn.init_lstm_params(
        jax.random.PRNGKey(len(parts)), sum(parts), H))
    rng = np.random.RandomState(3)
    xs = [rng.uniform(-1, 1, (33, 8, f)).astype(np.float32) for f in parts]
    jf, jb = jk.bilstm_fused(
        tuple(jnp.asarray(x, jdtype) for x in xs),
        {k: jnp.asarray(v, jdtype) for k, v in params.items()},
        interpret=True, dual=True)
    tparams = {k: _torch(v, tdtype) for k, v in params.items()}
    tf, tb = lstm_kernel.bilstm_fused(tuple(_torch(x, tdtype) for x in xs),
                                      tparams, dual=True)
    for actual, expected in ((tf, jf), (tb, jb)):
        assert actual.dtype == tdtype
        np.testing.assert_allclose(actual.float().numpy(),
                                   np.asarray(expected, np.float32),
                                   atol=atol)


def test_bilstm_fused_reads_pepper_lstm_dual(monkeypatch):
    """dual=None reads PEPPER_LSTM_DUAL, as the JAX package does; on the
    CPU the dual twin equals the two single-direction twins."""
    params = {k: _torch(np.array(v)) for k, v in jrnn.init_lstm_params(
        jax.random.PRNGKey(4), 26, H).items()}
    x = (_torch(np.random.RandomState(4).randn(9, 5, 26).astype(
        np.float32)),)
    calls = []
    dual = lstm_kernel.bilstm_dual_fused

    def spy(*args):
        calls.append(len(args))
        return dual(*args)

    monkeypatch.setattr(lstm_kernel, "bilstm_dual_fused", spy)
    single = lstm_kernel.bilstm_fused(x, params)
    assert calls == []
    monkeypatch.setenv("PEPPER_LSTM_DUAL", "1")
    both = lstm_kernel.bilstm_fused(x, params)
    assert calls == [7]
    for a, b in zip(both, single):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- models


@pytest.fixture
def jax_static_kernels(monkeypatch):
    """JAX's _infer_static with its static kernel in interpret mode."""
    monkeypatch.setattr(jk, "bilstm_fused_static", functools.partial(
        jk.bilstm_fused_static, interpret=True))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-4),
                                        ("bfloat16", 1e-2)])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
def test_static_model_matches_jax_kernel_math(rec_int8, dtype, atol,
                                              jax_static_kernels):
    jdtype, tdtype, _ = DTYPES[dtype]
    params = _jax_params(5)
    x = _windows(12, 6)
    tree = quantize.quantize_params_static(params, rec_int8=rec_int8)
    # __wrapped__: JAX's jit cache is per process and another test may have
    # traced _infer_static with the real kernel
    expected = np.asarray(jq._infer_static.__wrapped__(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jdtype,
        True))
    actual = quantize.transducer_infer_static(tree, _torch(x), tdtype)
    assert actual.dtype == torch.float32 and actual.shape == (12, 3)
    np.testing.assert_allclose(actual.numpy(), expected, atol=atol)
    np.testing.assert_array_equal(actual.numpy().argmax(1),
                                  expected.argmax(1))


@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
def test_static_model_f32_matches_jax_public(rec_int8):
    """In float32 the JAX package's CPU fallback is the kernel math."""
    params = _jax_params(7)
    x = _windows(10, 8)
    tree = quantize.quantize_params_static(params, rec_int8=rec_int8)
    expected = np.asarray(jq.transducer_infer_static(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(x, jnp.float32), jnp.float32))
    actual = quantize.transducer_infer_static(tree, _torch(x), torch.float32)
    np.testing.assert_allclose(actual.numpy(), expected, atol=2e-4)
    np.testing.assert_array_equal(actual.numpy().argmax(1),
                                  expected.argmax(1))


@pytest.mark.parametrize("shape", [(33, 26), (21, 48)],
                         ids=["33x26", "hp_21x48"])
@pytest.mark.parametrize("rec_int8,atol", [(False, 5e-3), (True, 1e-2)],
                         ids=["static", "static_rec"])
def test_static_float32_model_matches_jax_at_both_shapes(rec_int8, atol,
                                                         shape):
    """The float32 static modes (what --sharded, the staged run_inference
    and --compute_dtype float32 serve with --quantized): the port's
    transducer_infer_static in float32 against JAX's on the same
    numpy-seeded params, at the classifier's 33x26 windows and the HP
    classifier's 21x48 ones."""
    T, F = shape
    params = _jax_params(21, image_features=F, window=T)
    x = np.random.RandomState(22).randint(-125, 126, (12, T, F)).astype(
        np.int8)
    tree = quantize.quantize_params_static(params, rec_int8=rec_int8)
    expected = np.asarray(jq.transducer_infer_static(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(x, jnp.float32), jnp.float32))
    actual = quantize.transducer_infer_static(tree, _torch(x), torch.float32)
    assert actual.dtype == torch.float32 and actual.shape == (12, 3)
    np.testing.assert_allclose(actual.numpy(), expected, atol=atol)


def test_static_model_full_width_f32():
    params = _jax_params(9, hidden=256, linear_size=512)
    x = _windows(4, 10)
    tree = quantize.quantize_params_static(params)
    expected = np.asarray(jq.transducer_infer_static(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(x, jnp.float32), jnp.float32))
    actual = quantize.transducer_infer_static(tree, _torch(x), torch.float32)
    np.testing.assert_allclose(actual.numpy(), expected, atol=2e-4)
    np.testing.assert_array_equal(actual.numpy().argmax(1),
                                  expected.argmax(1))


def test_dynamic_model_matches_jax_kernel_math(monkeypatch):
    """JAX's _infer_int8 with its recurrence kernel in interpret mode; both
    run the recurrence on bfloat16 projections."""
    monkeypatch.setattr(jk, "use_pallas_lstm", lambda: True)
    monkeypatch.setattr(jk, "lstm_recurrence_pallas", functools.partial(
        jk.lstm_recurrence_pallas, interpret=True))
    params = _jax_params(11)
    x = _windows(12, 12)
    q, s = quantize.quantize_params(params)
    expected = np.asarray(jq._infer_int8.__wrapped__(
        q, s, jnp.asarray(x, jnp.float32), jnp.bfloat16))
    actual = quantize.transducer_infer_quantized(
        params_from_jax(q, "cpu"), params_from_jax(s, "cpu"),
        _torch(x))
    assert actual.dtype == torch.float32 and actual.shape == (12, 3)
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-2)
    np.testing.assert_array_equal(actual.numpy().argmax(1),
                                  expected.argmax(1))


def test_prepare_static_sets_the_kernel_dtypes():
    tree = quantize.prepare_static(
        quantize.quantize_params_static(_jax_params(13)), torch.bfloat16,
        "cpu")
    enc, dec = tree["encoder"], tree["decoder"]
    assert enc["w_ih_f"].dtype == enc["w_hh_b"].dtype == torch.bfloat16
    assert enc["b_f"].dtype == torch.float32
    assert dec["w_ih_b"].dtype == torch.int8
    assert dec["w_hh_f"].dtype == torch.bfloat16
    assert dec["as_f"].dtype == tree["linear_1"]["b"].dtype == torch.float32
    assert tree["linear_1"]["w"].dtype == torch.int8
    assert tree["linear_3"]["b"].dtype == torch.bfloat16
    again = quantize.prepare_static(tree, torch.bfloat16, "cpu")
    assert again["decoder"]["w_hh_f"] is dec["w_hh_f"]
