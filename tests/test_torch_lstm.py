"""The port's LSTM layer against the JAX package.

Inputs are made with numpy from a seed and fed to both.  Tolerances:
float32 1e-5 (the JAX suite's recurrence bar; the two differ only in
summation order); bfloat16 2e-2 (one bf16 ulp of h near 1 is 2**-8, and
the rounding of h before the recurrent product can fall on either side).
The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the twin there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import rnn as jrnn
from pepper_tpu.ops import lstm_kernel as jkernel
from pepper_tpu_torch.models import rnn
from pepper_tpu_torch.ops import lstm_kernel

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _direction_inputs(seed, T, B, H, feature_parts):
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(H)
    xs = [rng.randn(T, B, f).astype(np.float32) for f in feature_parts]
    ws = [rng.uniform(-scale, scale, (f, 4 * H)).astype(np.float32)
          for f in feature_parts]
    b = rng.uniform(-2 * scale, 2 * scale, 4 * H).astype(np.float32)
    w_hh = rng.uniform(-scale, scale, (H, 4 * H)).astype(np.float32)
    return xs, ws, b, w_hh


def _torch(arrays, dtype, device="cpu"):
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("T,B,H", [(33, 16, 64), (7, 8, 32)])
def test_twin_matches_jax_kernel(T, B, H, n_parts, reverse, dtype):
    jdtype, tdtype, atol = DTYPES[dtype]
    parts = [26] if n_parts == 1 else [H, H]
    xs, ws, b, w_hh = _direction_inputs(T * 7 + B, T, B, H, parts)
    expected = jkernel.lstm_direction_fused(
        tuple(jnp.asarray(x, jdtype) for x in xs),
        tuple(jnp.asarray(w, jdtype) for w in ws), jnp.asarray(b, jdtype),
        jnp.asarray(w_hh, jdtype), reverse=reverse, interpret=True)
    actual = lstm_kernel.lstm_direction_fused_reference(
        _torch(xs, tdtype), _torch(ws, tdtype), *_torch([b, w_hh], tdtype),
        reverse=reverse)
    assert actual.dtype == tdtype and actual.shape == (T, B, H)
    np.testing.assert_allclose(actual.float().numpy(),
                               np.asarray(expected, np.float32), atol=atol)


FULL_PARTS = {"encoder": (26,), "decoder": (256, 256)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layer", ["encoder", "decoder"])
def test_twin_matches_jax_kernel_at_full_width(layer, reverse, dtype):
    """The transducer's widths: T=33, H=256, the encoder's 26 window
    features or the decoder's two 256-wide streams."""
    jdtype, tdtype, atol = DTYPES[dtype]
    xs, ws, b, w_hh = _direction_inputs(11, 33, 8, 256, FULL_PARTS[layer])
    expected = jkernel.lstm_direction_fused(
        tuple(jnp.asarray(x, jdtype) for x in xs),
        tuple(jnp.asarray(w, jdtype) for w in ws), jnp.asarray(b, jdtype),
        jnp.asarray(w_hh, jdtype), reverse=reverse, interpret=True)
    actual = lstm_kernel.lstm_direction_fused_reference(
        _torch(xs, tdtype), _torch(ws, tdtype), *_torch([b, w_hh], tdtype),
        reverse=reverse)
    assert actual.dtype == tdtype and actual.shape == (33, 8, 256)
    np.testing.assert_allclose(actual.float().numpy(),
                               np.asarray(expected, np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["encoder", "decoder"])
def test_dual_twin_matches_jax_kernel_at_full_width(layer, dtype):
    jdtype, tdtype, atol = DTYPES[dtype]
    xs, wf, b_f, w_hh_f = _direction_inputs(12, 33, 8, 256,
                                            FULL_PARTS[layer])
    _, wb, b_b, w_hh_b = _direction_inputs(13, 33, 8, 256, FULL_PARTS[layer])

    def jx(arrays):
        return tuple(jnp.asarray(a, jdtype) for a in arrays)

    expected = jkernel.bilstm_dual_fused(
        jx(xs), jx(wf), jx(wb), *jx([b_f, b_b, w_hh_f, w_hh_b]),
        interpret=True)
    actual = lstm_kernel.bilstm_dual_fused_reference(
        _torch(xs, tdtype), _torch(wf, tdtype), _torch(wb, tdtype),
        *_torch([b_f, b_b, w_hh_f, w_hh_b], tdtype))
    for a, e in zip(actual, expected):
        assert a.dtype == tdtype and a.shape == (33, 8, 256)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(e, np.float32), atol=atol)


@pytest.mark.parametrize("name", ["lstm_direction_fused",
                                  "bilstm_dual_fused", "lstm_recurrence"])
def test_float_lstm_kernels_build_with_the_core(name):
    """The float LSTM kernels include the bfloat16 core (and the PTX
    wrappers it shares with the int8 projection), so it enters their build
    stamps; the library of lstm_direction_fused also exports the
    projection alone."""
    from pepper_tpu_torch.ops import cuda_build

    headers, argtypes = cuda_build.KERNELS[name]
    assert headers == ("lstm_core.cuh", "mma_ptx.cuh", "lstm_cell.cuh")
    # the xw scratch(es) sit before the outputs; lstm_recurrence takes
    # `reverse` before the stream
    assert len(argtypes) == {"lstm_direction_fused": 16,
                             "bilstm_dual_fused": 21,
                             "lstm_recurrence": 9}[name]


def test_lstm_entries_are_bound_with_their_argument_types():
    import ctypes

    from pepper_tpu_torch.ops import cuda_build

    P, I = ctypes.c_void_p, ctypes.c_int
    entries = {
        # dtype, x0, x1, w0, w1, F0, F1, bias, xw, steps, B, H, stream
        "lstm_direction_fused_projection": [I, P, P, P, P, I, I, P, P, I, I,
                                            I, P],
        # dtype, xw, w_hh, out, steps, B, H, reverse, stream
        "lstm_direction_fused_recurrence": [I, P, P, P, I, I, I, I, P],
        # dtype, B, H, dirs, fused, int out[4], stream
        "lstm_direction_fused_plan": [I, I, I, I, I, P, P],
        # dtype, x0, x1, wf0, wf1, wb0, wb1, F0, F1, bias_f, bias_b, xw_f,
        # xw_b, steps, B, H, stream
        "bilstm_dual_fused_projection": [I, P, P, P, P, P, P, I, I, P, P, P,
                                         P, I, I, I, P],
        # dtype, xw_f, xw_b, w_hh_f, w_hh_b, out_f, out_b, steps, B, H,
        # stream
        "bilstm_dual_fused_recurrence": [I, P, P, P, P, P, P, I, I, I, P],
        # dtype, B, H, int out[4], stream
        "lstm_recurrence_plan": [I, I, I, P, P],
    }
    for name, expected in entries.items():
        kernel, argtypes = cuda_build.ENTRIES[name]
        assert kernel == name.rsplit("_", 1)[0] and argtypes == expected


@pytest.mark.parametrize("dtype,parts,scratch", [
    (torch.bfloat16, (256, 256), True), (torch.bfloat16, (26,), False),
    (torch.bfloat16, (16, 16), False), (torch.bfloat16, (20, 13), True),
    (torch.float32, (256, 256), True), (torch.float32, (26,), True),
    (torch.float32, (48,), True)])
def test_projection_scratch_only_where_the_input_leaves_the_step(
        dtype, parts, scratch):
    """bfloat16 inputs of more than 32 features in all are projected into a
    float32 (T, B, 4H) xw first, and float32 inputs of any width (the
    float32 core runs over xw alone); narrower bfloat16 ones need none."""
    xs = tuple(torch.zeros((5, 3, f), dtype=dtype) for f in parts)
    xw = lstm_kernel._projection_scratch(xs, 32)
    if scratch:
        assert xw.shape == (5, 3, 128) and xw.dtype == torch.float32
    else:
        assert xw is None


@pytest.mark.parametrize("x_dtype,whh_dtype,features,joins", [
    (torch.bfloat16, torch.bfloat16, 48, False),
    (torch.bfloat16, torch.int8, 48, False),
    (torch.bfloat16, torch.bfloat16, 26, True),
    (torch.bfloat16, torch.int8, 26, True),
    (torch.int8, torch.bfloat16, 512, False),
    (torch.int8, torch.int8, 512, False),
    (torch.float32, torch.float32, 48, False),
    (torch.float32, torch.int8, 48, False),
    (torch.int8, torch.float32, 512, False),
    (torch.float32, torch.float32, 26, False),
    (torch.float32, torch.int8, 26, False)],
    ids=["static_hp_encoder", "static_rec_hp_encoder", "static_encoder",
         "static_rec_encoder", "static_decoder", "static_rec_decoder",
         "float32", "float32_x_int8_whh", "int8_x_float32_whh",
         "float32_static_encoder", "float32_static_rec_encoder"])
def test_static_routes_by_dtype_at_every_width(x_dtype, whh_dtype, features,
                                               joins):
    """The static kernel has one route for every combination: x joins the
    recurrence's step where it can (bfloat16 x of at most 32 features), and
    is projected into a float32 xw first everywhere else (float32 x at
    every width), whatever W_hh and whatever is emitted."""
    del whh_dtype  # the route does not depend on it
    assert lstm_kernel.static_x_joins(x_dtype, (features,)) == joins
    xs = (torch.zeros((5, 3, features), dtype=x_dtype),)
    xw = lstm_kernel._static_scratch(xs, 32)
    assert (xw is None) == joins


# every (x, W_hh) dtype pair that lstm_direction_fused_static takes: float x
# with a W_hh of its dtype or int8, int8 x with a float32, bfloat16 or int8
# W_hh
STATIC_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.int8),
                (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.int8), (torch.int8, torch.float32),
                (torch.int8, torch.bfloat16), (torch.int8, torch.int8)]


# ... at the encoders' 26 and 48 features and the decoder's 512 (int8 x
# takes a multiple of 4)
STATIC_CASES = [(x, w, f) for x, w in STATIC_PAIRS for f in (26, 48, 512)
                if x != torch.int8 or f % 4 == 0]


@pytest.fixture
def recorded(monkeypatch):
    """The static wrapper's device path on meta tensors: require_cuda
    passes, launch records its name and arguments, and ptr hands over the
    tensor itself; nothing runs."""
    calls = []
    monkeypatch.setattr(lstm_kernel, "launch",
                        lambda name, device, *args: calls.append(args))
    monkeypatch.setattr(lstm_kernel, "require_cuda", lambda t, name: None)
    monkeypatch.setattr(lstm_kernel, "ptr", lambda t: t)
    return calls


def _static_launch(x_dtype, whh_dtype, features, out_int8, out_dtype,
                   recorded, H=32):
    """One static launch of a combination on meta tensors: its recorded
    arguments and its output."""
    x = torch.empty((2, 3, features), dtype=x_dtype, device="meta")
    w_ih = torch.empty((features, 4 * H), dtype=x_dtype, device="meta")
    w_hh = torch.empty((H, 4 * H), dtype=whh_dtype, device="meta")
    scale = torch.empty(4 * H, device="meta")
    out = lstm_kernel.lstm_direction_fused_static(
        (x,), (w_ih,), torch.empty(4 * H, device="meta"), w_hh,
        acc_scale=scale if x_dtype == torch.int8 else None,
        rec_scale=scale if whh_dtype == torch.int8 else None,
        out_int8=out_int8, out_dtype=out_dtype)
    assert len(recorded) == 1
    return recorded.pop(), out


def _assert_one_route(args, x_dtype, whh_dtype, features, H=32):
    """A launch's operands on the one route: int8 weights k-major (W_ih one
    (4H, F) matrix, W_hh (4H, H)), float ones as they are, and an xw
    scratch where x does not join the step."""
    w0, w1, w_rec, xw = args[5], args[6], args[12], args[13]
    assert w0.shape == ((4 * H, features) if x_dtype == torch.int8
                        else (features, 4 * H))
    assert w1 is None
    assert w_rec.shape == ((4 * H, H) if whh_dtype == torch.int8
                           else (H, 4 * H))
    del whh_dtype  # the route does not depend on it
    joins = lstm_kernel.static_x_joins(x_dtype, (features,))
    assert (xw is None) == joins
    if not joins:
        assert xw.shape == (2, 3, 4 * H) and xw.dtype == torch.float32


@pytest.mark.parametrize("x_dtype,whh_dtype,features", STATIC_CASES, ids=[
    f"{str(x).split('.')[1]}_x_{str(w).split('.')[1]}_whh_{f}"
    for x, w, f in STATIC_CASES])
def test_every_code_emitting_combination_runs_on_the_core(
        x_dtype, whh_dtype, features, recorded):
    """Each combination the wrapper accepts runs on the core's one route,
    with int8 codes out and with the float epilogue alike: the same
    operands, int8 weights relaid k-major, only the out kind differs."""
    H = 32
    scale = torch.ones(4 * H)
    lstm_kernel._check_static_args(
        (torch.zeros((2, 3, features), dtype=x_dtype),),
        (torch.zeros((features, 4 * H), dtype=x_dtype),),
        torch.zeros(4 * H), torch.zeros((H, 4 * H), dtype=whh_dtype),
        scale if x_dtype == torch.int8 else None,
        scale if whh_dtype == torch.int8 else None)
    for out_int8 in (True, False):
        args, out = _static_launch(x_dtype, whh_dtype, features, out_int8,
                                   torch.float32, recorded)
        assert args[2] == (2 if out_int8 else 0)
        assert out.dtype == (torch.int8 if out_int8 else torch.float32)
        _assert_one_route(args, x_dtype, whh_dtype, features)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype,whh_dtype", STATIC_PAIRS, ids=[
    f"{str(x).split('.')[1]}_x_{str(w).split('.')[1]}_whh"
    for x, w in STATIC_PAIRS])
def test_float_epilogue_takes_the_core_route(x_dtype, whh_dtype, out_dtype,
                                             recorded):
    """The float epilogue (out_int8=False) of every (x, W_hh) pair runs on
    the core: h emitted in the asked float dtype (the launch's out kind
    its dtype code), the weights as the code-emitting launch reads them,
    at the encoder's 26 features (28 for int8 x)."""
    features = 28 if x_dtype == torch.int8 else 26
    args, out = _static_launch(x_dtype, whh_dtype, features, False,
                               out_dtype, recorded)
    assert out.dtype == out_dtype and out.shape == (2, 3, 32)
    assert args[2] == {torch.float32: 0, torch.bfloat16: 1}[out_dtype]
    assert args[14] is out
    _assert_one_route(args, x_dtype, whh_dtype, features)


@pytest.mark.parametrize("x_dtype,whh_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_static_refuses_a_float_whh_of_another_dtype(x_dtype, whh_dtype):
    """Float x takes a W_hh of its own dtype or an int8 one."""
    H = 32
    with pytest.raises(TypeError):
        lstm_kernel._check_static_args(
            (torch.zeros((2, 3, 26), dtype=x_dtype),),
            (torch.zeros((26, 4 * H), dtype=x_dtype),), torch.zeros(4 * H),
            torch.zeros((H, 4 * H), dtype=whh_dtype), None, None)


@pytest.mark.parametrize("dtype,parts,whh_dtype,scratch", [
    (torch.bfloat16, (48,), torch.bfloat16, True),
    (torch.bfloat16, (20, 13), torch.bfloat16, True),
    (torch.bfloat16, (26,), torch.bfloat16, False),
    (torch.int8, (256, 256), torch.int8, True),
    (torch.int8, (28,), torch.bfloat16, True),
    (torch.bfloat16, (26,), torch.int8, False),
    (torch.float32, (65,), torch.float32, True),
    (torch.float32, (26,), torch.float32, True),
    (torch.float32, (48,), torch.float32, True),
    (torch.float32, (64,), torch.float32, True),
    (torch.float32, (20, 13), torch.float32, True),
    (torch.float32, (26,), torch.int8, True)])
def test_static_scratch_where_the_core_projects_first(dtype, parts, whh_dtype,
                                                      scratch):
    """The static kernel projects int8 x, bfloat16 x of more than 32
    features (both parts counted) and float32 x of any width, beside any
    W_hh, into a float32 (T, B, 4H) xw first; bfloat16 x of at most 32
    joins the step and takes no xw."""
    del whh_dtype  # the route does not depend on it
    xs = tuple(torch.zeros((5, 3, f), dtype=dtype) for f in parts)
    xw = lstm_kernel._static_scratch(xs, 32)
    if scratch:
        assert xw.shape == (5, 3, 128) and xw.dtype == torch.float32
    else:
        assert xw is None


def test_wrapper_takes_the_twin_on_cpu():
    """On CPU tensors the wrapper is the twin, and launches nothing."""
    xs, ws, b, w_hh = _direction_inputs(3, 9, 5, 32, [26])
    args = (_torch(xs, torch.float32), _torch(ws, torch.float32),
            *_torch([b, w_hh], torch.float32))
    before = lstm_kernel.lstm_direction_fused.launches
    out = lstm_kernel.lstm_direction_fused(*args, reverse=True)
    ref = lstm_kernel.lstm_direction_fused_reference(*args, reverse=True)
    assert torch.equal(out, ref)
    assert lstm_kernel.lstm_direction_fused.launches == before


def test_wrapper_rejects_other_devices():
    x = torch.zeros((3, 2, 4), device="meta")
    w = torch.zeros((4, 128), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        lstm_kernel.lstm_direction_fused(
            (x,), (w,), torch.zeros(128, device="meta"),
            torch.zeros((32, 128), device="meta"))


@pytest.mark.parametrize("case", ["three_parts", "dtype", "shape", "strided",
                                  "mixed"])
def test_kernel_argument_checks(case):
    """The checks the wrapper runs before a launch (pure Python)."""
    xs, ws, b, w_hh = _direction_inputs(4, 5, 3, 32, [26])
    x, w = _torch(xs, torch.float32)[0], _torch(ws, torch.float32)[0]
    b, w_hh = _torch([b, w_hh], torch.float32)
    args = {"three_parts": ((x, x, x), (w, w, w), b, w_hh),
            "dtype": ((x.half(),), (w.half(),), b.half(), w_hh.half()),
            "shape": ((x,), (w[:10],), b, w_hh),
            "strided": ((x.transpose(0, 1).contiguous().transpose(0, 1),),
                        (w,), b, w_hh),
            "mixed": ((x,), (w.bfloat16(),), b, w_hh)}[case]
    with pytest.raises((ValueError, TypeError)):
        lstm_kernel._check_kernel_args(*args)


def test_bilstm_fused_matches_jax():
    """The port's bilstm_fused (two parts, as the decoder calls it) against
    the JAX package's, both on their CPU paths."""
    H, T, B = 32, 11, 8
    params = jrnn.init_lstm_params(jax.random.PRNGKey(5), 24, H)
    rng = np.random.RandomState(6)
    xa = rng.randn(T, B, 10).astype(np.float32)
    xb = rng.randn(T, B, 14).astype(np.float32)
    jf, jb = jkernel.bilstm_fused((jnp.asarray(xa), jnp.asarray(xb)),
                                  params, interpret=True)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tf, tb = lstm_kernel.bilstm_fused(
        (torch.from_numpy(xa), torch.from_numpy(xb)), tparams)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)


@pytest.mark.parametrize("batch,hidden,timesteps", [(16, 64, 33), (8, 32, 7)])
def test_bilstm_matches_jax(batch, hidden, timesteps):
    params = jrnn.init_lstm_params(jax.random.PRNGKey(0), 26, hidden)
    x = np.random.RandomState(1).randn(batch, timesteps, 26).astype(
        np.float32)
    expected = jrnn.bilstm(jnp.asarray(x), params, allow_kernel=False)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    actual = rnn.bilstm(torch.from_numpy(x), tparams)
    assert actual.shape == (batch, timesteps, 2 * hidden)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               atol=1e-5)


def test_lstm_scan_state_matches_jax():
    params = jrnn.init_lstm_params(jax.random.PRNGKey(2), 12, 32)
    rng = np.random.RandomState(3)
    x = rng.randn(8, 9, 12).astype(np.float32)
    h0 = rng.randn(8, 32).astype(np.float32) * 0.5
    c0 = rng.randn(8, 32).astype(np.float32) * 0.5
    for reverse in (False, True):
        ys, (hT, cT) = jrnn.lstm_scan(
            jnp.asarray(x), params["w_ih_f"], params["w_hh_f"],
            params["b_f"], jnp.asarray(h0), jnp.asarray(c0), reverse=reverse)
        tys, (thT, tcT) = rnn.lstm_scan(
            torch.from_numpy(x), *(torch.from_numpy(np.array(params[k]))
                                   for k in ("w_ih_f", "w_hh_f", "b_f")),
            torch.from_numpy(h0), torch.from_numpy(c0), reverse=reverse)
        for a, e in ((tys, ys), (thT, hT), (tcT, cT)):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5)


def test_init_params_shapes_and_ranges():
    """Same keys, shapes and U(-1/sqrt(H), 1/sqrt(H)) ranges as the JAX
    init; a seeded generator reproduces the draw."""
    jparams = jrnn.init_lstm_params(jax.random.PRNGKey(0), 26, 64)
    a = rnn.init_lstm_params(torch.Generator().manual_seed(7), 26, 64)
    b = rnn.init_lstm_params(torch.Generator().manual_seed(7), 26, 64)
    assert a.keys() == jparams.keys()
    for key in a:
        assert tuple(a[key].shape) == jparams[key].shape
        assert torch.equal(a[key], b[key])
        bound = 2 / 8 if key.startswith("b_") else 1 / 8
        assert a[key].abs().max() <= bound
    lin = rnn.init_linear_params(torch.Generator().manual_seed(1), 16, 4)
    assert lin["w"].shape == (16, 4) and lin["b"].shape == (4,)
    assert lin["w"].abs().max() <= 0.25
