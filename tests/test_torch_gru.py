"""The port's GRU (models/rnn.py GRU half, ops/gru_kernel.py twins) against
the JAX package.

Inputs are made with numpy from a seed and fed to both; the JAX kernels
run in interpret mode, as the JAX package's own tests run them on the CPU.
Small widths (F=10, H=32, T=20, B=8).  Bars:

  * float32: atol 1e-5 (summation order; tests/test_lstm_kernel.py's bar);
  * bfloat16 x: atol 2e-2 (one rounding of h may fall on either side);
  * static int8: every code equal in float32 and the float carry within
    1e-6 (tests/test_quantize_static.py's bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import quantize as jq
from pepper_tpu.models import rnn as jrnn
from pepper_tpu.ops import gru_kernel as jk
from pepper_tpu_torch.models import quantize, rnn
from pepper_tpu_torch.models.params import params_from_jax
from pepper_tpu_torch.ops import gru_kernel

T, B, F, H = 20, 8, 10, 32
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PARTS = {"encoder": (F,), "decoder": (H, H)}


def _u(rng, *shape, scale=1.0 / H ** 0.5):
    return rng.uniform(-scale, scale, shape).astype(np.float32)


def _direction(seed, parts, batch=B):
    """x parts (T, batch, F_i), w_ih parts (F_i, 3H), b_ih, w_hh, b_hh and
    a non-zero h0 (batch, H), as numpy float32: the encoder reads image
    values, the decoder streams in (-1, 1)."""
    rng = np.random.RandomState(seed)
    if parts == (F,):
        xs = (rng.randint(0, 40, (T, batch, F)).astype(np.float32),)
    else:
        xs = tuple(rng.uniform(-1, 1, (T, batch, f)).astype(np.float32)
                   for f in parts)
    ws = tuple(_u(rng, f, 3 * H) for f in parts)
    return (xs, ws, _u(rng, 3 * H), _u(rng, H, 3 * H), _u(rng, 3 * H),
            rng.uniform(-0.9, 0.9, (batch, H)).astype(np.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _close(ours, theirs, atol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(reverse):
    (x,), (w_ih,), b_ih, w_hh, b_hh, h0 = _direction(0, (F,))
    x = x.transpose(1, 0, 2)
    ys, hT = rnn.gru_scan(_t(x), _t(w_ih), _t(w_hh), _t(b_ih), _t(b_hh),
                          h0=_t(h0), reverse=reverse)
    j_ys, j_hT = jrnn.gru_scan(jnp.asarray(x), w_ih, w_hh, b_ih, b_hh,
                               h0=jnp.asarray(h0), reverse=reverse)
    assert ys.shape == (B, T, H) and hT.shape == (B, H)
    _close(ys, j_ys, 1e-5)
    _close(hT, j_hT, 1e-5)


def test_bigru_matches_jax():
    params = jax.tree_util.tree_map(np.asarray, jrnn.init_gru_params(
        jax.random.PRNGKey(1), F, H))
    x = np.random.RandomState(1).rand(B, T, F).astype(np.float32)
    out, (hf, hb) = rnn.bigru(_t(x), params_from_jax(params, "cpu"))
    j_out, (j_hf, j_hb) = jrnn.bigru(jnp.asarray(x), params)
    assert out.shape == (B, T, 2 * H)
    for ours, theirs in ((out, j_out), (hf, j_hf), (hb, j_hb)):
        _close(ours, theirs, 1e-5)


def test_init_gru_params_layout():
    params = rnn.init_gru_params(torch.Generator().manual_seed(0), F, H)
    expected = jrnn.init_gru_params(jax.random.PRNGKey(0), F, H)
    assert list(params) == list(expected)
    for key, value in expected.items():
        assert params[key].shape == value.shape, key
        assert params[key].abs().max() <= 1.0 / H ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["encoder", "decoder"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_direction_fused_twin_matches_jax_kernel(dtype, shape, reverse):
    jdt, tdt, atol = DTYPES[dtype]
    xs, ws, b_ih, w_hh, b_hh, h0 = _direction(2, PARTS[shape])
    ys, hT = gru_kernel.gru_direction_fused(
        tuple(_t(x, tdt) for x in xs), tuple(_t(w) for w in ws), _t(b_ih),
        _t(w_hh), _t(b_hh), _t(h0, tdt), reverse=reverse)
    j_ys, j_hT = jk.gru_direction_fused(
        tuple(jnp.asarray(x, jdt) for x in xs), ws, b_ih, w_hh, b_hh,
        jnp.asarray(h0, jdt), reverse=reverse, interpret=True)
    assert ys.dtype == tdt and ys.shape == (T, B, H) and hT.dtype == tdt
    _close(ys, j_ys, atol)
    _close(hT, j_hT, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_direction_pallas_twin_matches_jax_kernel(dtype, reverse):
    jdt, tdt, atol = DTYPES[dtype]
    (x,), (w_ih,), b_ih, w_hh, b_hh, h0 = _direction(3, (F,))
    x = x.transpose(1, 0, 2)
    ys, hT = gru_kernel.gru_direction_pallas(
        _t(x, tdt), _t(w_ih), _t(w_hh), _t(b_ih), _t(b_hh), _t(h0, tdt),
        reverse=reverse)
    j_ys, j_hT = jk.gru_direction_pallas(
        jnp.asarray(x, jdt), w_ih, w_hh, b_ih, b_hh, jnp.asarray(h0, jdt),
        reverse=reverse, interpret=True)
    assert ys.shape == (B, T, H) and str(ys.dtype).endswith(
        str(j_ys.dtype))
    _close(ys, j_ys, atol)
    _close(hT, j_hT, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_recurrence_twin_matches_jax_kernel(dtype):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(4)
    xw = rng.uniform(-2, 2, (T, B, 3 * H)).astype(np.float32)
    w_hh, b_hh = _u(rng, H, 3 * H), _u(rng, 3 * H)
    h0 = rng.uniform(-0.9, 0.9, (B, H)).astype(np.float32)
    ys = gru_kernel.gru_recurrence(_t(xw, tdt), _t(w_hh), _t(b_hh), _t(h0))
    j_ys = jk.gru_recurrence_pallas(jnp.asarray(xw, jdt), w_hh,
                                    b_hh.reshape(1, -1), jnp.asarray(h0),
                                    interpret=True)
    assert ys.dtype == tdt and ys.shape == (T, B, H)
    _close(ys, j_ys, atol)


def test_bigru_fused_twin_matches_jax():
    params = jax.tree_util.tree_map(np.asarray, jrnn.init_gru_params(
        jax.random.PRNGKey(5), 2 * H, H))
    rng = np.random.RandomState(5)
    xs = tuple(rng.uniform(-1, 1, (T, B, H)).astype(np.float32)
               for _ in range(2))
    h0 = rng.uniform(-0.9, 0.9, (B, 2, H)).astype(np.float32)
    ours = gru_kernel.bigru_fused(tuple(_t(x) for x in xs),
                                  params_from_jax(params, "cpu"), _t(h0))
    theirs = jk.bigru_fused(tuple(jnp.asarray(x) for x in xs), params,
                            jnp.asarray(h0), interpret=True)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        _close(a, b, 1e-5)


def _static_trees(seed):
    from pepper_tpu.models.polish_gru import PolishConfig, init_polish_params

    params = jax.tree_util.tree_map(np.asarray, init_polish_params(
        jax.random.PRNGKey(seed), PolishConfig(hidden=H)))
    q = jq.polish_quantize_params_static(params)
    return q, params_from_jax(q, "cpu")


def _check_codes(ours, theirs):
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_bigru_fused_static_twin_matches_jax_kernel_and_scan():
    """Encoder (float x) then decoder (the encoder's int8 codes): every
    code equal to JAX's interpret-mode kernel and to the port's and JAX's
    scan paths, and the float carry within 1e-6."""
    jq_tree, q = _static_trees(6)
    rng = np.random.RandomState(6)
    xt = rng.randint(0, 40, (T, B, F)).astype(np.float32)
    h0 = rng.uniform(-0.9, 0.9, (B, 2, H)).astype(np.float32)
    j_enc = jax.tree_util.tree_map(jnp.asarray, jq_tree["encoder"])
    j_dec = jax.tree_util.tree_map(jnp.asarray, jq_tree["decoder"])

    enc = gru_kernel.bigru_fused_static((_t(xt),), q["encoder"], _t(h0))
    j_enc_k = jk.bigru_fused_static((jnp.asarray(xt),), j_enc,
                                    jnp.asarray(h0), interpret=True)
    enc_scan = quantize._scan_bigru_to_q(_t(xt), q["encoder"], _t(h0),
                                         torch.float32)
    j_enc_s = jq._scan_bigru_to_q(jnp.asarray(xt), j_enc, jnp.asarray(h0),
                                  jnp.float32)
    for ours in (enc, enc_scan):
        for i in range(2):
            _check_codes(ours[i], j_enc_k[i])
            _check_codes(ours[i], j_enc_s[i])
        _close(ours[2], j_enc_k[2], 1e-6)

    dec = q["decoder"]
    f1q, b1q, hid1 = enc
    out = gru_kernel.bigru_fused_static((f1q, b1q), dec, hid1,
                                        acc_scale=(dec["as_f"], dec["as_b"]))
    j_out = jk.bigru_fused_static(
        (jnp.asarray(f1q.numpy()), jnp.asarray(b1q.numpy())), j_dec,
        jnp.asarray(hid1.numpy()),
        acc_scale=(j_dec["as_f"], j_dec["as_b"]), interpret=True)
    out_scan = quantize._scan_bigru_q_to_q((f1q, b1q), dec, hid1,
                                           torch.float32)
    j_scan = jq._scan_bigru_q_to_q(
        (jnp.asarray(f1q.numpy()), jnp.asarray(b1q.numpy())), j_dec,
        jnp.asarray(hid1.numpy()), jnp.float32)
    for ours in (out, out_scan):
        for i in range(2):
            _check_codes(ours[i], j_out[i])
            _check_codes(ours[i], j_scan[i])
        _close(ours[2], j_out[2], 1e-6)


def test_use_fused_gru_reads_its_flag(monkeypatch):
    monkeypatch.delenv("PEPPER_GRU_FUSED", raising=False)
    assert gru_kernel.use_fused_gru("cuda")
    assert not gru_kernel.use_fused_gru("cpu")
    monkeypatch.setenv("PEPPER_GRU_FUSED", "0")
    assert not gru_kernel.use_fused_gru("cuda")
    monkeypatch.setenv("PEPPER_GRU_FUSED", "1")
    assert gru_kernel.use_fused_gru(torch.device("cpu"))
    monkeypatch.delenv("PEPPER_GRU_KERNEL", raising=False)
    assert not gru_kernel.use_pallas_gru()
    monkeypatch.setenv("PEPPER_GRU_KERNEL", "1")
    assert gru_kernel.use_pallas_gru()


def test_wrappers_on_cpu_run_their_twins_and_launch_nothing():
    xs, ws, b_ih, w_hh, b_hh, h0 = _direction(7, (F,))
    args = (tuple(_t(x) for x in xs), tuple(_t(w) for w in ws), _t(b_ih),
            _t(w_hh), _t(b_hh), _t(h0))
    counters = [getattr(gru_kernel, name) for name in gru_kernel.KERNELS]
    before = [c.launches for c in counters]
    ys, hT = gru_kernel.gru_direction_fused(*args)
    ref, ref_hT = gru_kernel.gru_direction_fused_reference(*args)
    assert torch.equal(ys, ref) and torch.equal(hT, ref_hT)
    gru_kernel.gru_direction_fused_static(*args)
    gru_kernel.gru_recurrence(torch.zeros(T, B, 3 * H), _t(w_hh), _t(b_hh),
                              _t(h0))
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("case", ["encoder", "encoder_reverse", "decoder",
                                  "decoder_reverse", "recurrence"])
def test_gru_twins_match_jax_kernels_at_ragged_batches(case, batch, dtype):
    """A batch of one and one that fills no block of the JAX kernels: the
    fused and recurrence twins against the interpret-mode kernels."""
    jdt, tdt, atol = DTYPES[dtype]
    if case == "recurrence":
        rng = np.random.RandomState(8)
        xw = rng.uniform(-2, 2, (T, batch, 3 * H)).astype(np.float32)
        w_hh, b_hh = _u(rng, H, 3 * H), _u(rng, 3 * H)
        h0 = rng.uniform(-0.9, 0.9, (batch, H)).astype(np.float32)
        ys = gru_kernel.gru_recurrence(_t(xw, tdt), _t(w_hh), _t(b_hh),
                                       _t(h0))
        j_ys = jk.gru_recurrence_pallas(jnp.asarray(xw, jdt), w_hh,
                                        b_hh.reshape(1, -1), jnp.asarray(h0),
                                        interpret=True)
        assert ys.dtype == tdt and ys.shape == (T, batch, H)
        _close(ys, j_ys, atol)
        return
    shape, _, direction = case.partition("_")
    reverse = direction == "reverse"
    xs, ws, b_ih, w_hh, b_hh, h0 = _direction(7, PARTS[shape], batch)
    ys, hT = gru_kernel.gru_direction_fused(
        tuple(_t(x, tdt) for x in xs), tuple(_t(w) for w in ws), _t(b_ih),
        _t(w_hh), _t(b_hh), _t(h0, tdt), reverse=reverse)
    j_ys, j_hT = jk.gru_direction_fused(
        tuple(jnp.asarray(x, jdt) for x in xs), ws, b_ih, w_hh, b_hh,
        jnp.asarray(h0, jdt), reverse=reverse, interpret=True)
    assert ys.dtype == tdt and ys.shape == (T, batch, H)
    _close(ys, j_ys, atol)
    _close(hT, j_hT, atol)
