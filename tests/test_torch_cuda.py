"""The port on the card: the CUDA kernels against their twins, and the
transducer (float and int8), the runner and the polish consensus on cuda
against their CPU path.
Every test needs a CUDA device and nvcc and skips without them.  This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py

Tolerances: kernel vs twin float32 1e-5 and bfloat16 2e-2 (summation order;
a bf16 rounding of h may fall on either side); int8 codes within 1 of the
twin's and at least 99.9% equal (99.5% when the recurrence is int8 too and
feeds its own codes back); probabilities float32 2e-4 and bfloat16 1e-2,
the transducer bars of tests/test_torch_transducer.py, and 5e-3 / 1e-2 for
the static / static_rec and dynamic int8 modes.  The GRU kernels of polish
take the same kernel bars (the static kernel's float32 hT 1e-5, 2e-2 with
a bfloat16 W_hh); the consensus on the card is held to its CPU path at
votes 1e-4 (float) and 5e-3 (static int8), with equal labels wherever the
CPU's top-two vote margin exceeds 0.05.  The transformer's attention
kernel is held to its twin's math in float32 over the same inputs (float32
1e-5; bfloat16 2e-2, the output's rounding) and to the bfloat16 twin at
2e-2 (the twin rounds its scores and weights to bfloat16 as it goes); the
transformer runner, with the benchmark cell's weights, by the root mean
square of its probabilities' gap from the twin route's and the CPU's
(float32 2e-4, bfloat16 1e-2), which two heads swapped exceed.
"""

import numpy as np
import pytest
import torch

from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.models import transducer
from pepper_tpu_torch.ops import attention_kernel, lstm_kernel
from pepper_tpu_torch.ops.int8_matmul import int8_matmul
from pepper_tpu_torch.ops.pileup_ref import CandidateWindow

pytestmark = pytest.mark.cuda
H = 256
BARS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, parts, B, T=33, seed=0, hidden=H):
    gen = torch.Generator(device=device).manual_seed(seed)
    s = 1.0 / hidden ** 0.5

    def u(*size, scale=s):
        return ((torch.rand(size, generator=gen, device=device) * 2 - 1)
                * scale).to(dtype)

    xs = tuple(u(T, B, f, scale=1.0) for f in parts)
    ws = tuple(u(f, 4 * hidden) for f in parts)
    return xs, ws, u(4 * hidden, scale=2 * s), u(hidden, 4 * hidden)


def _check_direction(args, dtype, B, hidden=H):
    """Both directions of lstm_direction_fused against the twin, one launch
    each."""
    for reverse in (False, True):
        before = lstm_kernel.lstm_direction_fused.launches
        out = lstm_kernel.lstm_direction_fused(*args, reverse=reverse)
        assert lstm_kernel.lstm_direction_fused.launches == before + 1
        ref = lstm_kernel.lstm_direction_fused_reference(*args,
                                                         reverse=reverse)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (args[0][0].shape[0], B,
                                                    hidden)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=BARS[dtype], rtol=0)


# batches that cross the bfloat16 core's rows-a-cluster plan (16 rows at
# B <= 512, 128 at the serving batch) and a ragged last cluster
LSTM_BATCHES = [1, 37, 128, 300, 512, 4096]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [(26,), (H, H)], ids=["encoder", "decoder"])
@pytest.mark.parametrize("B", LSTM_BATCHES)
def test_kernel_matches_twin(device, dtype, parts, B):
    _check_direction(_inputs(device, dtype, parts, B), dtype, B)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["encoder", "decoder"])
@pytest.mark.parametrize("hidden", [32, 96, 128, 256])
def test_kernel_widths_match_twin(device, dtype, layer, hidden):
    """The cluster sizes: in bfloat16 one CTA at H=32, two at 96 and 128,
    four at 256; in float32 (32 units a CTA) one, three, four and
    eight."""
    parts = (26,) if layer == "encoder" else (hidden, hidden)
    _check_direction(_inputs(device, dtype, parts, 37, hidden=hidden), dtype,
                     37, hidden)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [(10, 16), (36, 20)],
                         ids=["two_fused_parts", "unaligned_parts"])
def test_kernel_other_feature_splits_match_twin(device, dtype, parts):
    """Two parts that join the step's product (26 features), and two whose
    widths are no multiple of 8 (the projection's element-wise loads)."""
    _check_direction(_inputs(device, dtype, parts, 37), dtype, 37)


def test_projection_entry_matches_float_product(device):
    """The bfloat16 projection alone: xw = b + x_0 @ W_0 + x_1 @ W_1, f32
    sums of exact products, against a float64 product; the recurrence
    entry over that xw gives the kernel's output bit for bit."""
    from pepper_tpu_torch.ops import cuda_build

    for B in (37, 512):
        xs, ws, b, w_hh = _inputs(device, torch.bfloat16, (H, H), B)
        xw = torch.full((33, B, 4 * H), float("nan"), device=device)
        cuda_build.launch("lstm_direction_fused_projection", device, 1,
                          *(t.data_ptr() for t in (*xs, *ws)), H, H,
                          b.data_ptr(), xw.data_ptr(), 33, B, H)
        exact = (torch.cat(xs, dim=-1).double() @ torch.cat(ws).double()
                 + b.double())
        torch.cuda.synchronize()
        torch.testing.assert_close(xw.double(), exact, atol=1e-4, rtol=0)
        for reverse in (0, 1):
            out = torch.empty((33, B, H), dtype=torch.bfloat16,
                              device=device)
            cuda_build.launch("lstm_direction_fused_recurrence", device, 1,
                              xw.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
                              33, B, H, reverse)
            whole = lstm_kernel.lstm_direction_fused(xs, ws, b, w_hh,
                                                     reverse=bool(reverse))
            torch.testing.assert_close(out, whole, atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="projection launch failed"):
        cuda_build.launch("lstm_direction_fused_projection", device, 2,
                          *(t.data_ptr() for t in (*xs, *ws)), H, H,
                          b.data_ptr(), xw.data_ptr(), 33, B, H)


@pytest.mark.parametrize("parts", [(26,), (H, H)], ids=["encoder", "decoder"])
def test_float32_entries_split_the_kernel(device, parts):
    """float32 projects every F first: the projection alone (3xTF32) is
    within 1e-5 of a float64 product, and the recurrence entry over its xw
    gives the kernel's output bit for bit, one direction and both."""
    from pepper_tpu_torch.ops import cuda_build

    for B in (37, 512):
        xs, ws, b, w_hh = _inputs(device, torch.float32, parts, B, seed=2)
        x1, w1 = (xs[1], ws[1]) if len(xs) > 1 else (None, None)
        ptr = (lambda t: None if t is None else t.data_ptr())
        xw = torch.full((33, B, 4 * H), float("nan"), device=device)
        cuda_build.launch("lstm_direction_fused_projection", device, 0,
                          ptr(xs[0]), ptr(x1), ptr(ws[0]), ptr(w1),
                          parts[0], parts[1] if x1 is not None else 0,
                          b.data_ptr(), xw.data_ptr(), 33, B, H)
        exact = (torch.cat(xs, dim=-1).double() @ torch.cat(ws).double()
                 + b.double())
        torch.cuda.synchronize()
        torch.testing.assert_close(xw.double(), exact, atol=1e-5, rtol=0)
        for reverse in (0, 1):
            out = torch.empty((33, B, H), device=device)
            cuda_build.launch("lstm_direction_fused_recurrence", device, 0,
                              xw.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
                              33, B, H, reverse)
            whole = lstm_kernel.lstm_direction_fused(xs, ws, b, w_hh,
                                                     reverse=bool(reverse))
            torch.testing.assert_close(out, whole, atol=0, rtol=0)
        _, wb, b_b, w_hh_b = _inputs(device, torch.float32, parts, B, seed=3)
        xws = [torch.empty((33, B, 4 * H), device=device) for _ in range(2)]
        outs = [torch.empty((33, B, H), device=device) for _ in range(2)]
        cuda_build.launch("bilstm_dual_fused_projection", device, 0,
                          ptr(xs[0]), ptr(x1), ptr(ws[0]), ptr(w1),
                          ptr(wb[0]), ptr(wb[1] if x1 is not None else None),
                          parts[0], parts[1] if x1 is not None else 0,
                          b.data_ptr(), b_b.data_ptr(),
                          *(t.data_ptr() for t in xws), 33, B, H)
        cuda_build.launch("bilstm_dual_fused_recurrence", device, 0,
                          *(t.data_ptr() for t in (*xws, w_hh, w_hh_b,
                                                   *outs)), 33, B, H)
        whole = lstm_kernel.bilstm_dual_fused(xs, ws, wb, b, b_b, w_hh,
                                              w_hh_b)
        torch.cuda.synchronize()
        for out, ref in zip(outs, whole):
            torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_core_plan_covers_the_batch_in_one_wave(device):
    """The core's launch plans: in bfloat16 4 CTAs a cluster at H=256,
    clusters that cover B, and one wave unless even 144 rows a cluster
    need more; in float32 8 CTAs a cluster (32 units each), 32, 64 or 96
    rows, one wave unless even 96 rows need more."""
    import ctypes

    from pepper_tpu_torch.ops import cuda_build

    plans = {1: (4, (16, 32, 48, 96, 144)), 0: (8, (32, 64, 96))}
    for dtype, (cluster, row_plans) in plans.items():
        for B in (1, 37, 512, 4096):
            for fused in ((0, 1) if dtype else (0,)):
                for dirs in (1, 2):
                    out = (ctypes.c_int * 4)()
                    cuda_build.launch("lstm_direction_fused_plan", device,
                                      dtype, B, H, dirs, fused,
                                      ctypes.addressof(out))
                    rows, ctas, clusters, at_once = out
                    assert ctas == cluster and rows in row_plans
                    assert rows * (clusters - 1) < B <= rows * clusters
                    assert (dirs * clusters <= at_once
                            or rows == row_plans[-1])
            # lstm_recurrence's instance of the core, over its xw
            out = (ctypes.c_int * 4)()
            cuda_build.launch("lstm_recurrence_plan", device, dtype, B, H,
                              ctypes.addressof(out))
            rows, ctas, clusters, at_once = out
            assert ctas == cluster and rows in row_plans
            assert rows * (clusters - 1) < B <= rows * clusters
            assert clusters <= at_once or rows == row_plans[-1]
    # the float32 core takes no fused x
    with pytest.raises(RuntimeError, match="plan launch failed"):
        cuda_build.launch("lstm_direction_fused_plan", device, 0, 37, H, 1,
                          1, ctypes.addressof(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernels_serve_unaligned_weights(device, dtype):
    """Weights off the 16-byte boundary are copied, not refused."""
    xs, ws, b, w_hh = _inputs(device, dtype, (H, H), 37)
    args = (xs, tuple(_unaligned(w) for w in ws), b, _unaligned(w_hh))
    out = lstm_kernel.lstm_direction_fused(*args)
    ref = lstm_kernel.lstm_direction_fused_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=BARS[dtype],
                               rtol=0)


def test_kernel_narrow_hidden(device):
    """H=32 (one warp a block) runs the same code path."""
    xs, ws, b, w_hh = _inputs(device, torch.float32, (26,), 9)
    xs = (xs[0],)
    w = ws[0][:, :128].contiguous()
    b, w_hh = b[:128].contiguous(), w_hh[:32, :128].contiguous()
    out = lstm_kernel.lstm_direction_fused(xs, (w,), b, w_hh, reverse=True)
    ref = lstm_kernel.lstm_direction_fused_reference(xs, (w,), b, w_hh,
                                                     reverse=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["float16", "hidden_48", "non_contiguous"])
def test_kernel_refuses_what_it_cannot_take(device, case):
    xs, ws, b, w_hh = _inputs(device, torch.float32, (26,), 4)
    if case == "float16":
        args = ((xs[0].half(),), (ws[0].half(),), b.half(), w_hh.half())
        error = TypeError
    elif case == "hidden_48":
        args = (xs, (ws[0][:, :192].contiguous(),), b[:192].contiguous(),
                w_hh[:48, :192].contiguous())
        error = ValueError
    else:
        args = ((xs[0].transpose(0, 1).contiguous().transpose(0, 1),), ws,
                b, w_hh)
        error = ValueError
    before = lstm_kernel.lstm_direction_fused.launches
    with pytest.raises(error):
        lstm_kernel.lstm_direction_fused(*args)
    assert lstm_kernel.lstm_direction_fused.launches == before


def _params():
    return transducer.init_transducer_params(torch.Generator().manual_seed(5))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4),
                                        (torch.bfloat16, 1e-2)])
def test_transducer_on_card_matches_cpu(device, dtype, atol):
    params = _params()
    x = torch.randint(-125, 126, (64, 33, 26),
                      generator=torch.Generator().manual_seed(6)).float()
    cpu = transducer.transducer_infer(params, x, dtype)
    before = lstm_kernel.lstm_direction_fused.launches
    gpu = transducer.transducer_infer(
        transducer.params_from_jax(params, device), x.to(device), dtype)
    assert lstm_kernel.lstm_direction_fused.launches == before + 4
    torch.testing.assert_close(gpu.cpu(), cpu, atol=atol, rtol=0)


def test_runner_on_card(device):
    rng = np.random.default_rng(1)
    windows = [CandidateWindow(
        contig="chr1", position=i, depth=30, candidates=["1T"],
        candidate_frequency=[9],
        image=rng.integers(-125, 126, (33, 26)).astype(np.int8))
        for i in range(300)]
    params = _params()
    gpu = InferenceRunner(params, batch_size=4096, compute_dtype="float32")
    assert gpu.device.type == "cuda"
    cpu = InferenceRunner(params, batch_size=4096, compute_dtype="float32",
                          device="cpu")
    piped = gpu.resolve(gpu.dispatch(windows))
    sync = gpu.predict(windows)
    expected = cpu.predict(windows)
    for a, b, c in zip(piped, sync, expected):
        np.testing.assert_array_equal(a.prediction_base, b.prediction_base)
        np.testing.assert_allclose(a.prediction_base, c.prediction_base,
                                   atol=2e-4)
    images = np.stack([w.image for w in windows])
    np.testing.assert_array_equal(gpu.predict_images(images),
                                  gpu.predict_images(images.astype(
                                      np.float32)))


@pytest.mark.parametrize("mode", [{}, {"quantized": True}],
                         ids=["float32", "static"])
def test_runner_over_two_device_entries_equals_one(device, mode):
    """The data-parallel runner over [cuda:0, cuda:0] (a card's worth of
    the split, the per-device trees and the gather): 300 windows in a
    bucket of 512, split in blocks of 256 (256 and 44 windows), give one
    device's probabilities (float32 1e-5, static int8 1e-3), each block
    launching its own four kernels."""
    rng = np.random.default_rng(2)
    images = rng.integers(-125, 126, (300, 33, 26)).astype(np.int8)
    params = _params()
    kw = dict(batch_size=4096, compute_dtype="float32", **mode)
    one = InferenceRunner(params, **kw)
    two = InferenceRunner(params, devices=[device, device], **kw)
    kernel = (lstm_kernel.lstm_direction_fused_static if mode
              else lstm_kernel.lstm_direction_fused)
    expected = one.predict_images(images)
    before = kernel.launches
    got = two.predict_images(images)
    assert kernel.launches == before + 8
    np.testing.assert_allclose(got, expected, atol=1e-3 if mode else 1e-5)


# ---------------------------------------------------------------- int8 serving

CODE_BARS = {False: 0.999, True: 0.995}    # equal share, by rec_int8


def _quantize_cols(w):
    """Per-output-column int8 codes and their (N,) scales."""
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    return torch.round(w / scale).clamp(-127, 127).to(torch.int8), scale


def static_inputs(device, dtype, x_int8, rec_int8, B, T=33, seed=0):
    """One direction of the static kernel at H=256: the decoder's shape
    (int8 codes, 2 x 256 features, int8 W_ih and acc_scale) or the
    encoder's (F=26 window values in dtype).  W_hh is int8 with rec_scale,
    or dtype."""
    gen = torch.Generator().manual_seed(seed)
    s = 1.0 / H ** 0.5

    def u(*size, scale=s):
        return (torch.rand(size, generator=gen) * 2 - 1) * scale

    if x_int8:
        xs = tuple(torch.randint(-127, 128, (T, B, H), generator=gen,
                                 dtype=torch.int8) for _ in range(2))
        w_q, w_scale = _quantize_cols(u(2 * H, 4 * H))
        ws, acc_scale = (w_q[:H], w_q[H:]), w_scale / 127.0
    else:
        xs = (torch.randint(-125, 126, (T, B, 26), generator=gen).to(dtype),)
        ws, acc_scale = (u(26, 4 * H).to(dtype),), None
    if rec_int8:
        w_hh, r_scale = _quantize_cols(u(H, 4 * H))
        rec_scale = r_scale / 127.0
    else:
        w_hh, rec_scale = u(H, 4 * H).to(dtype), None

    def move(t):
        return None if t is None else t.to(device).contiguous()

    return ([move(x) for x in xs], [move(w) for w in ws], move(u(4 * H)),
            move(w_hh), move(acc_scale), move(rec_scale))


def assert_codes_close(out, ref, rec_int8):
    """Codes within 1 everywhere; the equal share, a rate, is held to its
    bar on samples of at least 300k codes (B >= 37 at H=256, T=33): one h
    that rounds the other way in bf16 flips a few codes of its row."""
    diff = (out.int() - ref.int()).abs()
    assert diff.max().item() <= 1
    if diff.numel() >= 300_000:
        assert (diff == 0).float().mean().item() >= CODE_BARS[rec_int8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_int8", [False, True], ids=["float_x", "int8_x"])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["float_rec", "int8_rec"])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_static_kernel_matches_twin(device, dtype, x_int8, rec_int8, B):
    xs, ws, b, w_hh, acc_scale, rec_scale = static_inputs(
        device, dtype, x_int8, rec_int8, B)
    kernel = lstm_kernel.lstm_direction_fused_static
    twin = lstm_kernel.lstm_direction_fused_static_reference
    for reverse in (False, True):
        kw = dict(acc_scale=acc_scale, rec_scale=rec_scale, reverse=reverse)
        before = kernel.launches
        out = kernel(xs, ws, b, w_hh, out_int8=True, **kw)
        assert kernel.launches == before + 1
        ref = twin(xs, ws, b, w_hh, out_int8=True, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.int8 and out.shape == (33, B, H)
        assert_codes_close(out, ref, rec_int8)
        # the float epilogue, from the same core kinds
        out = kernel(xs, ws, b, w_hh, out_dtype=dtype, **kw)
        ref = twin(xs, ws, b, w_hh, out_dtype=dtype, **kw)
        assert out.dtype == dtype
        # an int8 recurrence feeds its codes back, and a code that rounds
        # the other way moves h by about 1e-4: the bf16 bar then
        atol = 2e-2 if rec_int8 else BARS[dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=0)


def _static_core_case(device, layer, rec_int8, B, hidden, seed=0, T=33,
                      features=26, dtype=torch.bfloat16):
    """One direction of a served static combination at width hidden (in
    bfloat16 unless dtype says otherwise): the encoder's (window values of
    `features` in dtype) or the decoder's (int8 codes of 2 x hidden
    features, int8 W_ih and acc_scale); W_hh int8 with rec_scale
    (static_rec) or dtype (static); a float32 bias."""
    gen = torch.Generator().manual_seed(seed)
    s = 1.0 / hidden ** 0.5

    def u(*size, scale=s):
        return (torch.rand(size, generator=gen) * 2 - 1) * scale

    G = 4 * hidden
    if layer == "encoder":
        xs = (torch.randint(-125, 126, (T, B, features), generator=gen).to(
            dtype),)
        ws, acc_scale = (u(features, G).to(dtype),), None
    else:
        xs = tuple(torch.randint(-127, 128, (T, B, hidden), generator=gen,
                                 dtype=torch.int8) for _ in range(2))
        w_q, w_scale = _quantize_cols(u(2 * hidden, G))
        ws, acc_scale = (w_q[:hidden], w_q[hidden:]), w_scale / 127.0
    if rec_int8:
        w_hh, r_scale = _quantize_cols(u(hidden, G))
        rec_scale = r_scale / 127.0
    else:
        w_hh, rec_scale = u(hidden, G).to(dtype), None

    def move(t):
        return None if t is None else t.to(device).contiguous()

    return ([move(x) for x in xs], [move(w) for w in ws], move(u(G)),
            move(w_hh), move(acc_scale), move(rec_scale))


# batches across the cores' rows-a-cluster plans (16 rows up to 512, 144 at
# the serving batch; the float32 core's 32 to 96) and widths of 1, 2 and 4
# CTAs a cluster (the float32 core's 1, 4 and 8)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("layer", ["encoder", "decoder"])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
@pytest.mark.parametrize("hidden", [32, 128, 256])
@pytest.mark.parametrize("B", [1, 37, 128, 4096])
def test_static_core_matches_twin(device, layer, rec_int8, hidden, B, dtype):
    """The served static combinations run on lstm_core.cuh (the int8
    products on the tensor cores; a float32 W_hh on the float32 core's
    codes kind, float32 x projected first) and meet the twin at the code
    bars, both directions, in bfloat16 and in float32."""
    xs, ws, b, w_hh, acc_scale, rec_scale = _static_core_case(
        device, layer, rec_int8, B, hidden, dtype=dtype)
    kernel = lstm_kernel.lstm_direction_fused_static
    for reverse in (False, True):
        kw = dict(acc_scale=acc_scale, rec_scale=rec_scale, reverse=reverse,
                  out_int8=True)
        before = kernel.launches
        out = kernel(xs, ws, b, w_hh, **kw)
        assert kernel.launches == before + 1
        ref = lstm_kernel.lstm_direction_fused_static_reference(
            xs, ws, b, w_hh, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.int8 and out.shape == (33, B, hidden)
        assert_codes_close(out, ref, rec_int8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
@pytest.mark.parametrize("hidden", [32, 128, 256])
@pytest.mark.parametrize("B", [1, 37, 4096])
def test_static_core_wide_encoder_matches_twin(device, rec_int8, hidden, B,
                                               dtype):
    """x of more than 32 features (the HP encoder's 48) runs on the core:
    projected first into a float32 xw (bfloat16 with the codes kinds' sums,
    float32 by float32 FMAs), then the recurrence over it; codes at the
    code bars, both directions."""
    xs, ws, b, w_hh, acc_scale, rec_scale = _static_core_case(
        device, "encoder", rec_int8, B, hidden, seed=11, T=21, features=48,
        dtype=dtype)
    kernel = lstm_kernel.lstm_direction_fused_static
    for reverse in (False, True):
        kw = dict(acc_scale=acc_scale, rec_scale=rec_scale, reverse=reverse,
                  out_int8=True)
        before = kernel.launches
        out = kernel(xs, ws, b, w_hh, **kw)
        assert kernel.launches == before + 1
        ref = lstm_kernel.lstm_direction_fused_static_reference(
            xs, ws, b, w_hh, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.int8 and out.shape == (21, B, hidden)
        assert_codes_close(out, ref, rec_int8)


# (layer, dtype, features): where the kernel projects x first
SPLIT_CASES = [("decoder", torch.bfloat16, 2 * H),
               ("decoder", torch.float32, 2 * H),
               ("encoder", torch.float32, 26), ("encoder", torch.float32, 48),
               ("encoder", torch.bfloat16, 48)]


@pytest.mark.parametrize("layer,dtype,features", SPLIT_CASES, ids=[
    f"{layer}_{str(dtype).split('.')[1]}_{features}"
    for layer, dtype, features in SPLIT_CASES])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
def test_static_core_entries_split_the_kernel(device, rec_int8, layer, dtype,
                                              features):
    """The library's projection entry writes the decoder's xw = b + f32(acc)
    * acc_scale exactly (the int32 sums are exact) and float x's xw = b +
    x @ W_ih within float32's rounding, and its recurrence entry over that
    xw (W_hh float32, bfloat16 or int8) gives the kernel's codes bit for
    bit."""
    from pepper_tpu_torch.ops import cuda_build

    B, T = 300, 33 if features != 48 else 21
    xs, ws, b, w_hh, acc_scale, rec_scale = _static_core_case(
        device, layer, rec_int8, B, H, T=T, features=features, dtype=dtype)
    xw = torch.empty((T, B, 4 * H), device=device)
    x_code = cuda_build.DTYPE_CODE[xs[0].dtype]
    if layer == "decoder":
        w = cuda_build.int8_kmajor(torch.cat(ws))
        acc = (int8_matmul(xs[0].reshape(T * B, H), ws[0])
               + int8_matmul(xs[1].reshape(T * B, H), ws[1]))
        expected = (b + acc.float() * acc_scale).reshape(T, B, -1)
        parts = (xs[0].data_ptr(), xs[1].data_ptr(), H, H)
    else:
        w = ws[0]
        expected = b + xs[0].float() @ w.float()
        parts = (xs[0].data_ptr(), None, features, 0)
    cuda_build.launch("lstm_direction_fused_static_projection", device,
                      x_code, *parts, w.data_ptr(),
                      acc_scale.data_ptr() if layer == "decoder" else None,
                      b.data_ptr(), xw.data_ptr(), T, B, H)
    torch.cuda.synchronize()
    if layer == "decoder":
        assert torch.equal(xw, expected)
    else:
        torch.testing.assert_close(xw, expected, atol=1e-4, rtol=1e-6)
    w_rec = cuda_build.int8_kmajor(w_hh) if rec_int8 else w_hh
    codes = torch.empty((T, B, H), dtype=torch.int8, device=device)
    cuda_build.launch("lstm_direction_fused_static_recurrence", device,
                      cuda_build.DTYPE_CODE[w_hh.dtype], xw.data_ptr(),
                      w_rec.data_ptr(),
                      rec_scale.data_ptr() if rec_int8 else None,
                      codes.data_ptr(), T, B, H, 1)
    out = lstm_kernel.lstm_direction_fused_static(
        xs, ws, b, w_hh, acc_scale=acc_scale, rec_scale=rec_scale,
        reverse=True, out_int8=True)
    torch.cuda.synchronize()
    assert torch.equal(codes, out)


@pytest.mark.parametrize("case", ["no_acc_scale", "mixed_whh", "unaligned"])
def test_static_kernel_refuses_what_it_cannot_take(device, case):
    xs, ws, b, w_hh, acc_scale, _ = static_inputs(device, torch.float32,
                                                  True, False, 4)
    if case == "no_acc_scale":
        acc_scale = None
    elif case == "mixed_whh":
        w_hh = w_hh.half()
    else:
        xs = [torch.empty(xs[0].numel() + 1, dtype=torch.int8,
                          device=device)[1:].view(xs[0].shape), xs[1]]
    before = lstm_kernel.lstm_direction_fused_static.launches
    with pytest.raises((TypeError, ValueError)):
        lstm_kernel.lstm_direction_fused_static(xs, ws, b, w_hh,
                                                acc_scale=acc_scale)
    assert lstm_kernel.lstm_direction_fused_static.launches == before


def _lstm_recurrence_inputs(device, dtype, B, hidden=H, seed=None, T=33):
    gen = torch.Generator().manual_seed(B if seed is None else seed)
    xw = ((torch.rand(T, B, 4 * hidden, generator=gen) * 2 - 1)).to(
        device, dtype)
    w_hh = ((torch.rand(hidden, 4 * hidden, generator=gen) * 2 - 1)
            / 16).to(device, dtype)
    return xw, w_hh


def _check_recurrence(xw, w_hh, dtype):
    """Both directions of lstm_recurrence against the twin, one launch
    each."""
    T, B, _ = xw.shape
    for reverse in (False, True):
        before = lstm_kernel.lstm_recurrence.launches
        out = lstm_kernel.lstm_recurrence(xw, w_hh, reverse=reverse)
        assert lstm_kernel.lstm_recurrence.launches == before + 1
        ref = lstm_kernel.lstm_recurrence_reference(xw, w_hh,
                                                    reverse=reverse)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (T, B, w_hh.shape[0])
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=BARS[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128, 256])
@pytest.mark.parametrize("B", [1, 37, 512, 4096])
def test_recurrence_kernel_matches_twin(device, dtype, B, hidden):
    """bfloat16 on the tensor-core core (1, 2 and 4 CTAs a cluster; the
    plan's 16-row clusters and its 144-row ones at 4096), float32 on its
    float32 kind (3xTF32); both directions."""
    _check_recurrence(*_lstm_recurrence_inputs(device, dtype, B, hidden),
                      dtype)


def test_recurrence_kernel_serves_unaligned_operands(device):
    """A bfloat16 xw or W_hh off the 16-byte boundary is copied, not
    refused."""
    xw, w_hh = _lstm_recurrence_inputs(device, torch.bfloat16, 37)
    _check_recurrence(_unaligned(xw), _unaligned(w_hh), torch.bfloat16)


@pytest.mark.parametrize("hidden", [32, 96, 128, 256])
def test_lstm_libraries_share_a_process_at_each_width(device, hidden):
    """The three libraries that instantiate lstm_core.cuh, loaded in one
    process, each launch at every cluster size (1, 2, 2 and 4 CTAs) and
    agree with their twins: the core's launcher statics stay each
    library's own."""
    dtype = torch.bfloat16
    xs, ws, b, w_hh = _inputs(device, dtype, (hidden, hidden), 37,
                              hidden=hidden)
    _check_direction((xs, ws, b, w_hh), dtype, 37, hidden)
    dual = (xs, ws, ws, b, b, w_hh, w_hh)
    outs = lstm_kernel.bilstm_dual_fused(*dual)
    refs = lstm_kernel.bilstm_dual_fused_reference(*dual)
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=BARS[dtype], rtol=0)
    _check_recurrence(*_lstm_recurrence_inputs(device, dtype, 37, hidden),
                      dtype)
    # the static kernel's library, the fourth to instantiate the core: its
    # fused body (static_rec encoder) and its hoisted one (static decoder)
    for layer, rec_int8 in (("encoder", True), ("decoder", False)):
        xs, ws, b, w_hh, acc_scale, rec_scale = _static_core_case(
            device, layer, rec_int8, 37, hidden)
        kw = dict(acc_scale=acc_scale, rec_scale=rec_scale, out_int8=True)
        out = lstm_kernel.lstm_direction_fused_static(xs, ws, b, w_hh, **kw)
        ref = lstm_kernel.lstm_direction_fused_static_reference(
            xs, ws, b, w_hh, **kw)
        torch.cuda.synchronize()
        assert_codes_close(out, ref, rec_int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [(26,), (H, H)], ids=["encoder", "decoder"])
@pytest.mark.parametrize("B", LSTM_BATCHES)
def test_dual_kernel_matches_twin(device, dtype, parts, B):
    xs, wf, b_f, w_hh_f = _inputs(device, dtype, parts, B, seed=1)
    _, wb, b_b, w_hh_b = _inputs(device, dtype, parts, B, seed=2)
    args = (xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b)
    before = lstm_kernel.bilstm_dual_fused.launches
    fwd, bwd = lstm_kernel.bilstm_dual_fused(*args)
    assert lstm_kernel.bilstm_dual_fused.launches == before + 1
    ref_f, ref_b = lstm_kernel.bilstm_dual_fused_reference(*args)
    singles = (lstm_kernel.lstm_direction_fused(xs, wf, b_f, w_hh_f),
               lstm_kernel.lstm_direction_fused(xs, wb, b_b, w_hh_b,
                                                reverse=True))
    torch.cuda.synchronize()
    for out, ref, single in zip((fwd, bwd), (ref_f, ref_b), singles):
        assert out.dtype == dtype and out.shape == (33, B, H)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=BARS[dtype], rtol=0)
        # the same sums as the single-direction kernel's, bit for bit
        torch.testing.assert_close(out, single, atol=0, rtol=0)


@pytest.mark.parametrize("M,K,N", [(4, 26, 3), (33, 32, 128),
                                   (37, 512, 1024), (64, 1024, 512),
                                   (64, 1032, 64), (4096, 512, 1024),
                                   (64, 16896, 512)])
def test_int8_matmul_on_card_is_exact(device, M, K, N):
    """Exact on either side of the float32 path's limits (K 1024, 2^30
    multiply-adds), with -128 included, and at the static kernels'
    narrowest shape."""
    gen = torch.Generator().manual_seed(M)
    a = torch.randint(-128, 128, (M, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8)
    out = int8_matmul(a.to(device), b.to(device))
    assert out.dtype == torch.int32 and out.shape == (M, N)
    assert torch.equal(out.cpu(), int8_matmul(a, b))


@pytest.mark.parametrize("mode,dtype,atol,launches", [
    ("static", torch.float32, 2e-4, 4),
    ("static", torch.bfloat16, 5e-3, 4),
    ("static_rec", torch.bfloat16, 1e-2, 4),
    ("dynamic", torch.bfloat16, 1e-2, 4)])
def test_quantized_runner_on_card_matches_cpu(device, mode, dtype, atol,
                                              launches):
    counter = (lstm_kernel.lstm_recurrence if mode == "dynamic"
               else lstm_kernel.lstm_direction_fused_static)
    rng = np.random.default_rng(3)
    images = rng.integers(-125, 126, (300, 33, 26)).astype(np.int8)
    params = _params()
    kw = dict(batch_size=4096, quantized=True, quantize_mode=mode,
              compute_dtype="float32" if dtype == torch.float32
              else "bfloat16")
    gpu = InferenceRunner(params, **kw)
    cpu = InferenceRunner(params, device="cpu", **kw)
    before = counter.launches
    probs = gpu.predict_images(images)
    assert counter.launches == before + launches
    np.testing.assert_allclose(probs, cpu.predict_images(images), atol=atol)
    np.testing.assert_array_equal(
        probs, gpu.predict_images(images.astype(np.float32)))


# ---------------------------------------------------------------- GRU (polish)

GRU_H = 128


def gru_inputs(device, x_dtype, parts, B, T=100, seed=0, w_dtype=None,
               H=GRU_H):
    """One GRU direction at the polish width (or H): the encoder's (F=10
    image values) or the decoder's (2 x H streams in (-1, 1)) x parts in
    x_dtype, (F_i, 3H) weights, (3H,) float32 biases, W_hh and a non-zero
    (B, H) h0, on `device`."""
    gen = torch.Generator().manual_seed(seed)
    s = 1.0 / H ** 0.5
    w_dtype = w_dtype or torch.float32

    def u(*size, scale=s):
        return (torch.rand(size, generator=gen) * 2 - 1) * scale

    if parts == (10,):
        xs = (torch.randint(0, 41, (T, B, 10), generator=gen).float(),)
    else:
        xs = tuple(u(T, B, f, scale=1.0) for f in parts)
    xs = tuple(x.to(device, x_dtype) for x in xs)
    ws = tuple(u(f, 3 * H).to(device, w_dtype) for f in parts)
    return (xs, ws, u(3 * H).to(device), u(H, 3 * H).to(device, w_dtype),
            u(3 * H).to(device), u(B, H, scale=0.9).to(device))


GRU_PARTS = [(10,), (GRU_H, GRU_H)]
# the consensus buckets (32, 128, 512 below), a ragged last block (1, 37,
# 200, 300) and two waves of 16-row blocks (4096); H = 32, 64 and 128 take
# the core's smem body (with 0, 64 and 96 rows of W_hh in registers at one
# row a block, 64 at two, as at B=200), 256 its L2-streaming body
GRU_BATCHES = [1, 32, 37, 128, 200, 300, 4096]
GRU_WIDTHS = [32, 64, 128, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["encoder", "decoder"])
@pytest.mark.parametrize("H", GRU_WIDTHS)
@pytest.mark.parametrize("B", GRU_BATCHES)
def test_gru_kernel_matches_twin(device, dtype, layer, H, B):
    from pepper_tpu_torch.ops import gru_kernel

    parts = (10,) if layer == "encoder" else (H, H)
    xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(device, dtype, parts, B, H=H)
    h0 = h0.to(dtype)
    for reverse in (False, True):
        before = gru_kernel.gru_direction_fused.launches
        ys, hT = gru_kernel.gru_direction_fused(xs, ws, b_ih, w_hh, b_hh, h0,
                                                reverse=reverse)
        assert gru_kernel.gru_direction_fused.launches == before + 1
        ref, ref_hT = gru_kernel.gru_direction_fused_reference(
            xs, ws, b_ih, w_hh, b_hh, h0, reverse=reverse)
        torch.cuda.synchronize()
        assert ys.dtype == dtype and ys.shape == (100, B, H)
        torch.testing.assert_close(ys.float(), ref.float(), atol=BARS[dtype],
                                   rtol=0)
        torch.testing.assert_close(hT.float(), ref_hT.float(),
                                   atol=BARS[dtype], rtol=0)


@pytest.mark.parametrize("x_dtype,w_hh_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.float32), (torch.int8, torch.bfloat16)],
    ids=["f32", "bf16", "int8_f32", "int8_bf16"])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_gru_static_kernel_matches_twin(device, x_dtype, w_hh_dtype, B):
    from pepper_tpu_torch.ops import gru_kernel

    parts = GRU_PARTS[1] if x_dtype == torch.int8 else GRU_PARTS[0]
    xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(device, torch.float32, parts,
                                              B)
    acc_scale = None
    if x_dtype == torch.int8:
        xs = tuple(torch.round(x * 127).to(torch.int8) for x in xs)
        w_q, w_scale = _quantize_cols(torch.cat(ws).cpu())
        ws = (w_q[:GRU_H].to(device), w_q[GRU_H:].to(device))
        acc_scale = (w_scale / 127.0).to(device)
    else:
        xs = tuple(x.to(x_dtype) for x in xs)
        ws = tuple(w.to(x_dtype) for w in ws)
    w_hh = w_hh.to(w_hh_dtype)
    kernel = gru_kernel.gru_direction_fused_static
    for reverse in (False, True):
        before = kernel.launches
        out, hT = kernel(xs, ws, b_ih, w_hh, b_hh, h0, acc_scale=acc_scale,
                         reverse=reverse)
        assert kernel.launches == before + 1
        ref, ref_hT = gru_kernel.gru_direction_fused_static_reference(
            xs, ws, b_ih, w_hh, b_hh, h0, acc_scale=acc_scale,
            reverse=reverse)
        torch.cuda.synchronize()
        assert out.dtype == torch.int8 and out.shape == (100, B, GRU_H)
        assert hT.dtype == torch.float32 and hT.shape == (B, GRU_H)
        diff = (out.int() - ref.int()).abs()
        assert diff.max().item() <= 1
        if diff.numel() >= 300_000:
            assert (diff == 0).float().mean().item() >= 0.999
        torch.testing.assert_close(hT, ref_hT, atol=1e-5 if w_hh_dtype
                                   == torch.float32 else 2e-2, rtol=0)


def _gru_static_case(device, x_dtype, w_hh_dtype, B, H, T=100, seed=0):
    """One static GRU direction at width H: the encoder's float x (F=10)
    with W_ih and W_hh of its dtype, or the decoder's int8 codes (2 x H)
    with int8 W_ih, acc_scale and a float32 or bfloat16 W_hh; a non-zero
    h0."""
    parts = (H, H) if x_dtype == torch.int8 else (10,)
    xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(device, torch.float32, parts,
                                              B, T=T, seed=seed, H=H)
    acc_scale = None
    if x_dtype == torch.int8:
        xs = tuple(torch.round(x * 127).to(torch.int8) for x in xs)
        w_q, w_scale = _quantize_cols(torch.cat(ws).cpu())
        ws = (w_q[:H].to(device), w_q[H:].to(device))
        acc_scale = (w_scale / 127.0).to(device)
    else:
        xs = tuple(x.to(x_dtype) for x in xs)
        ws = tuple(w.to(x_dtype) for w in ws)
    return xs, ws, b_ih, w_hh.to(w_hh_dtype), b_hh, h0, acc_scale


def _check_gru_static(case, B, H, T=100):
    """Both directions of gru_direction_fused_static against the twin:
    codes within 1 (at least 99.9% equal on samples of 300k codes or more)
    and hT within 1e-5 (float32 W_hh) or 2e-2 (bfloat16)."""
    from pepper_tpu_torch.ops import gru_kernel

    xs, ws, b_ih, w_hh, b_hh, h0, acc_scale = case
    kernel = gru_kernel.gru_direction_fused_static
    for reverse in (False, True):
        before = kernel.launches
        out, hT = kernel(xs, ws, b_ih, w_hh, b_hh, h0, acc_scale=acc_scale,
                         reverse=reverse)
        assert kernel.launches == before + 1
        ref, ref_hT = gru_kernel.gru_direction_fused_static_reference(
            xs, ws, b_ih, w_hh, b_hh, h0, acc_scale=acc_scale,
            reverse=reverse)
        torch.cuda.synchronize()
        assert out.dtype == torch.int8 and out.shape == (T, B, H)
        assert hT.dtype == torch.float32 and hT.shape == (B, H)
        diff = (out.int() - ref.int()).abs()
        assert diff.max().item() <= 1
        if diff.numel() >= 300_000:
            assert (diff == 0).float().mean().item() >= 0.999
        torch.testing.assert_close(hT, ref_hT, atol=1e-5 if w_hh.dtype
                                   == torch.float32 else 2e-2, rtol=0)


GRU_STATIC_COMBOS = [(torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.int8, torch.float32),
                     (torch.int8, torch.bfloat16)]


@pytest.mark.parametrize("x_dtype,w_hh_dtype", GRU_STATIC_COMBOS,
                         ids=["f32", "bf16", "int8_f32", "int8_bf16"])
@pytest.mark.parametrize("H", [32, 128, 256])
@pytest.mark.parametrize("B", [1, 37, 128, 4096])
def test_gru_static_core_matches_twin(device, x_dtype, w_hh_dtype, H, B):
    """Every combination on gru_core.cuh (its smem body to H=128, one row a
    block at B=128; its L2-streaming body at 256), the projection out of
    the loop, int8 codes and the f32 hT out."""
    _check_gru_static(_gru_static_case(device, x_dtype, w_hh_dtype, B, H),
                      B, H)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.int8],
                         ids=["float_x", "int8_x"])
def test_gru_static_entries_split_the_kernel(device, x_dtype):
    """The library's projection entry gives the exact int8 product (or the
    float one within 1e-4) and its recurrence entry over that xw the
    kernel's codes and hT bit for bit."""
    from pepper_tpu_torch.ops import cuda_build, gru_kernel

    B, T = 128, 100
    xs, ws, b_ih, w_hh, b_hh, h0, acc_scale = _gru_static_case(
        device, x_dtype, torch.float32, B, GRU_H)
    xw = torch.empty((T, B, 3 * GRU_H), device=device)
    two = len(xs) > 1
    w0, w1 = ((cuda_build.int8_kmajor(torch.cat(ws)), None) if two
              else (ws[0], None))
    cuda_build.launch("gru_direction_fused_static_projection", device,
                      cuda_build.DTYPE_CODE[x_dtype], xs[0].data_ptr(),
                      xs[1].data_ptr() if two else None, w0.data_ptr(),
                      None, xs[0].shape[2], xs[1].shape[2] if two else 0,
                      acc_scale.data_ptr() if two else None,
                      b_ih.data_ptr(), xw.data_ptr(), T, B, GRU_H)
    if two:
        acc = (int8_matmul(xs[0].reshape(T * B, -1), ws[0])
               + int8_matmul(xs[1].reshape(T * B, -1), ws[1]))
        exact = acc.float() * acc_scale + b_ih
        torch.cuda.synchronize()
        assert torch.equal(xw.reshape(T * B, -1), exact)
    else:
        exact = xs[0].double() @ ws[0].double() + b_ih.double()
        torch.cuda.synchronize()
        assert (xw.double() - exact).abs().max().item() <= 1e-4
    codes = torch.empty((T, B, GRU_H), dtype=torch.int8, device=device)
    h_out = torch.empty((B, GRU_H), device=device)
    cuda_build.launch("gru_direction_fused_static_recurrence", device, 0,
                      xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                      h0.data_ptr(), codes.data_ptr(), h_out.data_ptr(), T,
                      B, GRU_H, 0)
    out, hT = gru_kernel.gru_direction_fused_static(
        xs, ws, b_ih, w_hh, b_hh, h0, acc_scale=acc_scale)
    torch.cuda.synchronize()
    assert torch.equal(codes, out) and torch.equal(h_out, hT)


@pytest.mark.parametrize("H", GRU_WIDTHS)
def test_gru_libraries_share_a_process_at_each_width(device, H):
    """The three libraries that instantiate gru_core.cuh, loaded in one
    process, each launch at every width (the smem body with 0, 64 and 96
    rows of W_hh in registers, the streaming body at 256) and agree with
    their twins: the core's launcher statics stay each library's own."""
    from pepper_tpu_torch.ops import gru_kernel

    xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(device, torch.float32, (H, H),
                                              37, T=20, H=H)
    ys, hT = gru_kernel.gru_direction_fused(xs, ws, b_ih, w_hh, b_hh, h0)
    ref, ref_hT = gru_kernel.gru_direction_fused_reference(
        xs, ws, b_ih, w_hh, b_hh, h0)
    torch.testing.assert_close(ys, ref, atol=BARS[torch.float32], rtol=0)
    xw, w_hh, b_hh, h0 = _recurrence_inputs(device, torch.float32, 37, H)
    out = gru_kernel.gru_recurrence(xw, w_hh, b_hh, h0)
    torch.testing.assert_close(
        out, gru_kernel.gru_recurrence_reference(xw, w_hh, b_hh, h0),
        atol=BARS[torch.float32], rtol=0)
    for x_dtype, w_hh_dtype in GRU_STATIC_COMBOS[1:3]:
        _check_gru_static(_gru_static_case(device, x_dtype, w_hh_dtype, 37,
                                           H, T=20), 37, H, T=20)


def _recurrence_inputs(device, dtype, B, H):
    gen = torch.Generator().manual_seed(B)
    xw = (torch.rand(100, B, 3 * H, generator=gen) * 4 - 2).to(device, dtype)
    w_hh = ((torch.rand(H, 3 * H, generator=gen) * 2 - 1) / H ** 0.5).to(
        device)
    b_hh = (torch.rand(3 * H, generator=gen) * 0.2 - 0.1).to(device)
    h0 = (torch.rand(B, H, generator=gen) * 1.8 - 0.9).to(device)
    return xw, w_hh, b_hh, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", GRU_WIDTHS)
@pytest.mark.parametrize("B", GRU_BATCHES)
def test_gru_recurrence_kernel_matches_twin(device, dtype, H, B):
    from pepper_tpu_torch.ops import gru_kernel

    xw, w_hh, b_hh, h0 = _recurrence_inputs(device, dtype, B, H)
    before = gru_kernel.gru_recurrence.launches
    out = gru_kernel.gru_recurrence(xw, w_hh, b_hh, h0)
    assert gru_kernel.gru_recurrence.launches == before + 1
    ref = gru_kernel.gru_recurrence_reference(xw, w_hh, b_hh, h0)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (100, B, H)
    torch.testing.assert_close(out.float(), ref.float(), atol=BARS[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_direction_pallas_reverse_on_card_matches_cpu(device, dtype):
    """The unfused path's backward direction (flips around the recurrence
    kernel, xw in x's dtype) against the same call on the CPU."""
    from pepper_tpu_torch.ops import gru_kernel

    xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(torch.device("cpu"), dtype,
                                              GRU_PARTS[0], 37)
    x = xs[0].transpose(0, 1).contiguous()
    args = (x, ws[0].to(dtype), w_hh, b_ih, b_hh, h0)
    ys, hT = gru_kernel.gru_direction_pallas(
        *(a.to(device) for a in args), reverse=True)
    ref, ref_hT = gru_kernel.gru_direction_pallas(*args, reverse=True)
    torch.testing.assert_close(ys.float().cpu(), ref.float(),
                               atol=BARS[dtype], rtol=0)
    torch.testing.assert_close(hT.float().cpu(), ref_hT.float(),
                               atol=BARS[dtype], rtol=0)


@pytest.mark.parametrize("case", ["bf16_weights", "float16_x", "h0_shape",
                                  "hidden_288"])
def test_gru_kernel_refuses_what_it_cannot_take(device, case):
    from pepper_tpu_torch.ops import gru_kernel

    xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(device, torch.float32,
                                              GRU_PARTS[0], 4, T=5)
    error = TypeError
    if case == "bf16_weights":
        w_hh = w_hh.bfloat16()
    elif case == "float16_x":
        xs = (xs[0].half(),)
    elif case == "h0_shape":
        h0, error = h0[:3], ValueError
    else:
        xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(
            device, torch.float32, GRU_PARTS[0], 4, T=5, H=288)
        error = ValueError
    before = gru_kernel.gru_direction_fused.launches
    with pytest.raises(error):
        gru_kernel.gru_direction_fused(xs, ws, b_ih, w_hh, b_hh, h0)
    assert gru_kernel.gru_direction_fused.launches == before


def test_gru_recurrence_refuses_what_it_cannot_take(device):
    from pepper_tpu_torch.ops import gru_kernel

    xw, w_hh, b_hh, h0 = _recurrence_inputs(device, torch.float32, 4, 32)
    before = gru_kernel.gru_recurrence.launches
    with pytest.raises(TypeError):
        gru_kernel.gru_recurrence(xw.half(), w_hh, b_hh, h0)
    assert gru_kernel.gru_recurrence.launches == before


def _unaligned(t):
    """A contiguous copy of t that starts one float past a 16-byte
    boundary."""
    return torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view_as(t).copy_(t)


@pytest.mark.parametrize("kernel", ["fused", "recurrence"])
def test_gru_kernels_serve_unaligned_weights(device, kernel):
    """Weights off the 16-byte boundary the kernels read them from are
    copied onto a fresh allocation, not refused."""
    from pepper_tpu_torch.ops import gru_kernel

    if kernel == "fused":
        xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(
            device, torch.float32, GRU_PARTS[1], 37, T=20)
        args = (xs, tuple(_unaligned(w) for w in ws), b_ih, _unaligned(w_hh),
                b_hh, h0)
        before = gru_kernel.gru_direction_fused.launches
        ys, hT = gru_kernel.gru_direction_fused(*args)
        assert gru_kernel.gru_direction_fused.launches == before + 1
        ref, ref_hT = gru_kernel.gru_direction_fused_reference(*args)
        torch.testing.assert_close(hT, ref_hT, atol=BARS[torch.float32],
                                   rtol=0)
    else:
        xw, w_hh, b_hh, h0 = _recurrence_inputs(device, torch.float32, 37,
                                                GRU_H)
        before = gru_kernel.gru_recurrence.launches
        ys = gru_kernel.gru_recurrence(xw, _unaligned(w_hh), b_hh, h0)
        assert gru_kernel.gru_recurrence.launches == before + 1
        ref = gru_kernel.gru_recurrence_reference(xw, w_hh, b_hh, h0)
    torch.testing.assert_close(ys, ref, atol=BARS[torch.float32], rtol=0)


def _polish_params():
    from pepper_tpu_torch.models.polish_gru import init_polish_params

    return init_polish_params(torch.Generator().manual_seed(9))


@pytest.mark.parametrize("mode,env", [
    ("float", {}), ("static", {}),
    ("recurrence", {"PEPPER_GRU_FUSED": "0", "PEPPER_GRU_KERNEL": "1"})])
def test_consensus_on_card_matches_cpu(device, monkeypatch, mode, env):
    """The consensus scan on the card through one kernel (76 launches a
    batch: 19 windows x 4 directions) against the CPU path: votes within
    1e-4 (float) or 5e-3 (static int8: a code may round the other way),
    and equal labels wherever the CPU's top-two vote margin exceeds 0.05."""
    from pepper_tpu_torch.models import quantize
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.ops import gru_kernel
    from pepper_tpu_torch.polish import consensus

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    kernel = {"float": gru_kernel.gru_direction_fused,
              "static": gru_kernel.gru_direction_fused_static,
              "recurrence": gru_kernel.gru_recurrence}[mode]
    images = torch.from_numpy(np.random.RandomState(4).randint(
        0, 40, (40, 1000, 10)).astype(np.float32))
    tree = _polish_params()
    scan = consensus.consensus_scan
    if mode == "static":
        tree = params_from_jax(quantize.polish_quantize_params_static(tree),
                               "cpu")
        scan = consensus.consensus_scan_static
    before = kernel.launches
    votes, labels, _ = scan(params_from_jax(tree, device), images.to(device))
    assert kernel.launches == before + 76
    cpu_votes, cpu_labels, _ = scan(tree, images)
    torch.testing.assert_close(votes.cpu(), cpu_votes, rtol=0,
                               atol=5e-3 if mode == "static" else 1e-4)
    top2 = cpu_votes.topk(2, dim=2).values
    confident = (top2[..., 0] - top2[..., 1]) > 0.05
    assert confident.float().mean() > 0.3
    assert torch.equal(labels.cpu()[confident], cpu_labels[confident])


# ---------------------------------------------------------------------------
# the pileup histogram and the device-pileup flows


def _events(n_events, n_rows, n_cols=26, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n_rows, n_events).astype(np.int32),
            rng.randint(0, n_cols, n_events).astype(np.int32),
            rng.choice([-1, 1], n_events).astype(np.int32))


@pytest.mark.parametrize("n_events,n_rows,skew", [
    (10, 40, False), (5000, 300, False), (50000, 4096, False), (3, 1, False),
    (400000, 20000, False), (300000, 20000, True)])
def test_histogram_kernel_matches_twin_exactly(device, n_events, n_rows,
                                               skew):
    """Exact integer equality, one tile holding most events in the skewed
    case; out-of-range rows and columns in the slabs add nothing."""
    from pepper_tpu_torch.ops import pileup_kernel as pk

    rows, cols, deltas = _events(n_events, n_rows, seed=n_events)
    if skew:
        rows[: n_events // 2] = rows[: n_events // 2] % pk.TILE_R
    rel, bc, bd, n_tiles, capacity = pk._bin_events(rows, cols, deltas,
                                                    n_rows + 1)
    rel[0, -1], bc[0, 0] = 400, 70
    slabs = [torch.from_numpy(a).to(device) for a in (rel, bc, bd)]
    n_chunks = capacity // pk.CHUNK_E
    before = pk.pileup_histogram_events.launches
    out = pk.pileup_histogram(*slabs, n_tiles, n_chunks)
    assert pk.pileup_histogram_events.launches == before + 1
    ref = pk.pileup_histogram_reference(*slabs, n_tiles, n_chunks)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", [
    "emission", "row_sorted", "skewed", "one_key", "outside", "tail_1",
    "tail_2", "tail_3", "misaligned", "empty"])
def test_events_kernel_matches_twin_exactly(device, case):
    """The flat-event kernel against its twin, exact integer equality:
    events in emission-like order (runs of consecutive rows, as a read's
    bases), sorted by row, half of them in one 256-row tile, every event on
    one (row, col), rows and columns outside the image, N not a multiple
    of 4, views that start off the 16-byte boundary, and no events (no
    launch)."""
    from pepper_tpu_torch.ops import pileup_kernel as pk

    n_rows, n_cols = 20000, 26
    rng = np.random.RandomState(len(case))
    n_events = {"tail_1": 40001, "tail_2": 40002, "tail_3": 40003,
                "empty": 0}.get(case, 400000)
    rows, cols, deltas = _events(n_events, n_rows, seed=n_events)
    if case == "emission":
        starts = rng.randint(0, n_rows - 1000, n_events // 1000 + 1)
        rows = (np.repeat(starts, 1000)[:n_events]
                + np.tile(np.arange(1000), n_events // 1000 + 1)[:n_events]
                ).astype(np.int32)
    elif case == "row_sorted":
        order = np.argsort(rows, kind="stable")
        rows, cols, deltas = rows[order], cols[order], deltas[order]
    elif case == "skewed":
        rows[: n_events // 2] %= pk.TILE_R
    elif case == "one_key":
        rows[:], cols[:] = 7, 3
    elif case == "outside":
        rows[::7] = rng.choice([-1, -500, n_rows, n_rows + 9, 2 ** 31 - 1],
                               len(rows[::7]))
        cols[::5] = rng.choice([-1, n_cols, 63, 64, 1000], len(cols[::5]))
    tensors = [torch.from_numpy(a).to(device) for a in (rows, cols, deltas)]
    if case == "misaligned":
        tensors = [torch.cat([t[:k], t])[k:] for k, t in zip((1, 2, 3),
                                                             tensors)]
        assert all(t.data_ptr() % 16 for t in tensors)
    before = pk.pileup_histogram_events.launches
    out = pk.pileup_histogram_events(*tensors, n_rows, n_cols)
    assert pk.pileup_histogram_events.launches == before + (n_events > 0)
    ref = pk.pileup_histogram_events_reference(*tensors, n_rows, n_cols)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and out.shape == (n_rows, n_cols)
    assert torch.equal(out, ref)
    if case == "one_key":
        assert int(out[7, 3]) == int(deltas.sum())


@pytest.mark.parametrize("n_events,n_rows", [(10, 40), (50000, 4096),
                                             (0, 10)])
def test_accumulate_cuda_matches_numpy(device, n_events, n_rows):
    from pepper_tpu_torch.ops import pileup_kernel as pk

    rows, cols, deltas = _events(n_events, n_rows, seed=1)
    shape = (n_rows + 1, 26)
    before = pk.pileup_histogram_events.launches
    out = pk.accumulate_cuda(rows, cols, deltas, shape)
    assert pk.pileup_histogram_events.launches == before + (n_events > 0)
    np.testing.assert_array_equal(out, pk.accumulate_numpy(rows, cols,
                                                           deltas, shape))
    np.testing.assert_array_equal(
        pk.accumulate_torch(rows, cols, deltas, shape), out)


def _flow_inputs(n_regions=3, rows=2000, k=40, seed=0):
    """Random region images and their events (the images are the clamped,
    int8-cast accumulation of the events plus a reference channel), with
    random snp/insert/delete descriptors."""
    from pepper_tpu_torch.ops import device_windows as dw
    from pepper_tpu_torch.ops import pileup_kernel as pk

    rng = np.random.RandomState(seed)
    images, events, refs, descriptors = [], [], [], []
    for _ in range(n_regions):
        ev = _events(40 * rows, rows, seed=rng.randint(1 << 30))
        ref = rng.randint(1, 6, rows - 1).astype(np.int32)
        image = pk.accumulate_numpy(*ev, (rows, 26))
        image[:rows - 1, 0] += ref
        image[:rows - 1, 11:25] = np.clip(image[:rows - 1, 11:25], -125, 125)
        images.append(image.astype(np.int8))
        events.append(ev)
        refs.append(ref)
        digit = rng.randint(1, 4, k)
        descriptors.append(dw.CandidateDescriptors(
            base_index=rng.randint(0, rows, k).astype(np.int32),
            type_digit=digit.astype(np.int32),
            type_value=rng.randint(0, 6, k).astype(np.int32),
            depth_fwd=rng.randint(0, 60, k).astype(np.int32),
            depth_rev=rng.randint(0, 60, k).astype(np.int32),
            flip_fwd_col=rng.randint(8, 15, k).astype(np.int32),
            flip_rev_col=rng.randint(19, 26, k).astype(np.int32),
            star_fwd_col=np.full(k, 14, np.int32),
            star_rev_col=np.full(k, 25, np.int32),
            del_len=np.where(digit == 3, rng.randint(1, 6, k), 0)
            .astype(np.int32)))
    return images, events, refs, descriptors, [rows] * n_regions


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4),
                                        (torch.bfloat16, 1e-2)])
def test_device_flows_on_card_match_cpu(device, dtype, atol):
    """Both fused flows on cuda against the same flows on the CPU: the
    images flow launches no histogram, the events flow one; each runs the
    transducer's four LSTM launches."""
    from pepper_tpu_torch.ops import device_windows as dw
    from pepper_tpu_torch.ops import pileup_kernel as pk

    params = transducer.init_transducer_params(
        torch.Generator().manual_seed(3),
        transducer.TransducerConfig(hidden=64, linear_size=64))
    images, events, refs, descriptors, sizes = _flow_inputs()
    runs = {
        "images": lambda dev: dw.classify_regions_images(
            params, images, descriptors, sizes, compute_dtype=dtype,
            device=dev),
        "events": lambda dev: dw.classify_regions_events(
            params, events, refs, descriptors, sizes, compute_dtype=dtype,
            device=dev),
    }
    results = {}
    for name, run in runs.items():
        hist, lstm = pk.pileup_histogram_events.launches, \
            lstm_kernel.lstm_direction_fused.launches
        probs = run(device)
        torch.cuda.synchronize()
        assert pk.pileup_histogram_events.launches - hist == (
            name == "events")
        assert lstm_kernel.lstm_direction_fused.launches - lstm == 4
        cpu = run("cpu")
        assert probs.shape == cpu.shape == (sum(len(d.base_index)
                                                for d in descriptors), 3)
        torch.testing.assert_close(probs.cpu(), cpu, atol=atol, rtol=0)
        results[name] = probs.cpu()
    torch.testing.assert_close(results["events"], results["images"],
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# HP mode: the LSTM kernels at the 48x21 classifier's shapes (T=21, encoder
# F=48, which is wider than FUSED_X_MAX and so projected first in bfloat16,
# by the static kernel's core too), and the GRU kernels under the legacy HP
# sliding predictor

HP_T, HP_F = 21, 48
HP_BATCHES = [1, 37, 4096]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [(HP_F,), (H, H)],
                         ids=["encoder", "decoder"])
@pytest.mark.parametrize("B", HP_BATCHES)
def test_hp_kernels_match_twins(device, dtype, parts, B):
    """lstm_direction_fused both directions and bilstm_dual_fused (equal to
    the two single launches bit for bit) at T=21."""
    xs, wf, b_f, w_hh_f = _inputs(device, dtype, parts, B, T=HP_T, seed=3)
    _check_direction((xs, wf, b_f, w_hh_f), dtype, B)
    # both dtypes project first at both widths
    assert lstm_kernel._projection_scratch(xs, H) is not None
    _, wb, b_b, w_hh_b = _inputs(device, dtype, parts, B, T=HP_T, seed=4)
    args = (xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b)
    outs = lstm_kernel.bilstm_dual_fused(*args)
    refs = lstm_kernel.bilstm_dual_fused_reference(*args)
    singles = (lstm_kernel.lstm_direction_fused(xs, wf, b_f, w_hh_f),
               lstm_kernel.lstm_direction_fused(xs, wb, b_b, w_hh_b,
                                                reverse=True))
    torch.cuda.synchronize()
    for out, ref, single in zip(outs, refs, singles):
        assert out.shape == (HP_T, B, H)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=BARS[dtype], rtol=0)
        torch.testing.assert_close(out, single, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["encoder", "decoder"])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
@pytest.mark.parametrize("B", [37, 4096])
def test_hp_static_kernel_matches_twin(device, dtype, layer, rec_int8, B):
    """The served static combinations at the HP shape: in both dtypes both
    layers run on the core (the encoder's 48 features projected first into
    a float32 xw; a float32 W_hh on the float32 core's codes kind); codes
    at the code bars."""
    xs, ws, b, w_hh, acc_scale, rec_scale = _static_core_case(
        device, layer, rec_int8, B, H, seed=5, T=HP_T, features=HP_F,
        dtype=dtype)
    kernel = lstm_kernel.lstm_direction_fused_static
    for reverse in (False, True):
        kw = dict(acc_scale=acc_scale, rec_scale=rec_scale, reverse=reverse,
                  out_int8=True)
        before = kernel.launches
        out = kernel(xs, ws, b, w_hh, **kw)
        assert kernel.launches == before + 1
        ref = lstm_kernel.lstm_direction_fused_static_reference(
            xs, ws, b, w_hh, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.int8 and out.shape == (HP_T, B, H)
        assert_codes_close(out, ref, rec_int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", HP_BATCHES)
def test_hp_recurrence_kernel_matches_twin(device, dtype, B):
    _check_recurrence(*_lstm_recurrence_inputs(device, dtype, B, T=HP_T),
                      dtype)


def _hp_params():
    return transducer.init_transducer_params(
        torch.Generator().manual_seed(7),
        transducer.TransducerConfig(image_features=HP_F, window=HP_T))


@pytest.mark.parametrize("env,counter,launches", [
    ({}, "lstm_direction_fused", 4),
    ({"PEPPER_LSTM_DUAL": "1"}, "bilstm_dual_fused", 2)],
    ids=["fused", "dual"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4),
                                        (torch.bfloat16, 1e-2)])
def test_hp_transducer_on_card_matches_cpu(device, monkeypatch, env, counter,
                                           launches, dtype, atol):
    """The HP transducer through each LSTM kernel route on the card against
    the CPU's fused path."""
    params = _hp_params()
    x = torch.randint(-125, 126, (64, HP_T, HP_F),
                      generator=torch.Generator().manual_seed(8)).float()
    cpu = transducer.transducer_infer(params, x, dtype)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    kernel = getattr(lstm_kernel, counter)
    before = kernel.launches
    gpu = transducer.transducer_infer(
        transducer.params_from_jax(params, device), x.to(device), dtype)
    assert kernel.launches == before + launches
    torch.testing.assert_close(gpu.cpu(), cpu, atol=atol, rtol=0)


@pytest.mark.parametrize("layer", ["encoder", "decoder"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_hp_bilstm_pallas_on_card_matches_twin(device, layer, dtype, atol):
    """models/rnn.py's bilstm on a CUDA tensor takes bilstm_pallas: two
    lstm_recurrence launches over the HP layer's widths, against the same
    function on the CPU (the recurrence's twin) at the kernel bars."""
    from pepper_tpu_torch.models import rnn

    params = {k: v.to(dtype) for k, v in _hp_params()[layer].items()}
    features = HP_F if layer == "encoder" else 2 * params["w_hh_f"].shape[0]
    gen = torch.Generator().manual_seed(12)
    x = (torch.rand((37, HP_T, features), generator=gen) * 2 - 1).to(dtype)
    if layer == "encoder":
        x = torch.randint(-125, 126, x.shape, generator=gen).to(dtype)
    cpu = lstm_kernel.bilstm_pallas(x, params)
    before = lstm_kernel.lstm_recurrence.launches
    gpu = rnn.bilstm(x.to(device), {k: v.to(device)
                                    for k, v in params.items()})
    assert lstm_kernel.lstm_recurrence.launches == before + 2
    assert gpu.shape == (37, HP_T, 2 * params["w_hh_f"].shape[0])
    torch.testing.assert_close(gpu.cpu().float(), cpu.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("mode,dtype,atol", [
    ("static", torch.float32, 2e-4),
    ("static", torch.bfloat16, 5e-3),
    ("static_rec", torch.bfloat16, 1e-2),
    ("dynamic", torch.bfloat16, 1e-2)])
def test_hp_quantized_runner_on_card_matches_cpu(device, mode, dtype, atol):
    counter = (lstm_kernel.lstm_recurrence if mode == "dynamic"
               else lstm_kernel.lstm_direction_fused_static)
    images = np.random.default_rng(9).integers(
        -125, 126, (300, HP_T, HP_F)).astype(np.int8)
    kw = dict(batch_size=4096, window=HP_T, features=HP_F, quantized=True,
              quantize_mode=mode,
              compute_dtype="float32" if dtype == torch.float32
              else "bfloat16")
    gpu = InferenceRunner(_hp_params(), **kw)
    cpu = InferenceRunner(_hp_params(), device="cpu", **kw)
    before = counter.launches
    probs = gpu.predict_images(images)
    assert counter.launches == before + 4
    np.testing.assert_allclose(probs, cpu.predict_images(images), atol=atol)


@pytest.mark.parametrize("env,kernel", [
    ({}, "gru_direction_fused"),
    ({"PEPPER_GRU_FUSED": "0", "PEPPER_GRU_KERNEL": "1"},
     "gru_recurrence")], ids=["fused", "recurrence"])
def test_hp_votes_scan_on_card_matches_twin_path(device, monkeypatch, env,
                                                 kernel):
    """hp_votes_scan over 1000-column image pairs: 76 launches of the
    route's kernel a haplotype batch (19 windows x 4 directions), votes
    within 1 of the twin path's on the card, at least 99.9% equal, equal
    labels where the twin's top-two margin exceeds 50."""
    from pepper_tpu_torch.infer import hp_sliding
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.polish_gru import (PolishConfig,
                                                    init_polish_params)
    from pepper_tpu_torch.ops import gru_kernel

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    params = init_polish_params(torch.Generator().manual_seed(10),
                                PolishConfig(image_features=12))
    images = [np.random.RandomState(seed).randn(8, 1000, 12).astype(
        np.float32) for seed in (11, 12)]
    counter = getattr(gru_kernel, kernel)
    before = counter.launches
    votes = hp_sliding.predict_hp(params, *images)
    assert counter.launches == before + 2 * 76
    monkeypatch.setenv("PEPPER_GRU_FUSED", "0")
    monkeypatch.setenv("PEPPER_GRU_KERNEL", "0")
    tree = params_from_jax(params, device)
    for ours, image in zip(votes, images):
        twin = hp_sliding.hp_votes_scan(
            tree, torch.from_numpy(image).to(device)).cpu().numpy()
        diff = np.abs(ours.astype(np.int64) - twin)
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
        top2 = np.sort(twin, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 50
        np.testing.assert_array_equal(ours.argmax(-1)[clear],
                                      twin.argmax(-1)[clear])


# ---------------------------------------------------------------- training


def _train_batch(dtype=np.float32, B=64, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(-40, 41, (B, 33, 26)).astype(dtype)
    labels = rng.randint(0, 3, B).astype(np.int32)
    mask = np.ones(B, dtype)
    mask[-3:] = 0.0
    return images, labels, mask


def _train_steps(device, tree, batch, steps=2):
    from pepper_tpu_torch.train import step, trainer

    params = trainer.trainable_params(tree, device)
    optimizer = torch.optim.Adam(
        [leaf for _, leaf in step.leaves(params) if leaf.requires_grad],
        lr=1e-4, weight_decay=1e-4)
    train_step = step.make_train_step(optimizer, dropout_rate=0.0)
    losses, grads = [], []
    for _ in range(steps):
        losses.append(train_step(params, *batch[:2], None, batch[2])["loss"])
        grads.append({path: leaf.grad.cpu().numpy().copy()
                      for path, leaf in step.leaves(params)})
    return losses, grads, params


def test_training_step_and_eval_on_card(device):
    """Two full-width Adam steps on cuda against the same steps on the CPU
    (loss rtol 1e-5, each gradient leaf within 2e-4 of its largest
    magnitude, params atol 1e-5), on the eager recurrence: row 4
    (lstm_recurrence) and row 1 never launch in them.  The steps run in
    float64: in float32 a last bit moves a SELU pre-activation across 0,
    where its slope jumps, and Adam turns a last bit of a gradient near 0
    into +-lr (chip_smoke.py, phase 20).  Then one float32 eval batch
    through row 1's kernel: 4 launches, the CPU's loss (rtol 1e-4) and
    confusion."""
    from pepper_tpu_torch.models.params import map_params
    from pepper_tpu_torch.models.transducer import init_transducer_params
    from pepper_tpu_torch.train import step

    tree = map_params(lambda p: p.double(), init_transducer_params(
        torch.Generator().manual_seed(0)))
    batch = _train_batch(np.float64)
    lstm_kernel.lstm_recurrence.launches = 0
    lstm_kernel.lstm_direction_fused.launches = 0
    losses, grads, params = _train_steps(device, tree, batch)
    assert lstm_kernel.lstm_recurrence.launches == 0
    assert lstm_kernel.lstm_direction_fused.launches == 0
    cpu_losses, cpu_grads, cpu_params = _train_steps("cpu", tree, batch)
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    for grad, cpu_grad in zip(grads, cpu_grads):
        for path, value in cpu_grad.items():
            bar = 2e-4 * max(np.abs(value).max(), 1e-30)
            assert np.abs(grad[path] - value).max() <= bar, path
    for (path, a), (_, b) in zip(step.leaves(params),
                                 step.leaves(cpu_params)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), atol=1e-5,
                                   err_msg=str(path))

    eval_step = step.make_eval_step()
    params, cpu_params = (map_params(lambda p: p.detach().float(), trained)
                          for trained in (params, cpu_params))
    batch = _train_batch()
    lstm_kernel.lstm_direction_fused.launches = 0
    loss, confusion = eval_step(params, *batch)
    assert lstm_kernel.lstm_direction_fused.launches == 4
    cpu_loss, cpu_confusion = eval_step(cpu_params, *batch)
    assert loss == pytest.approx(cpu_loss, rel=1e-4)
    np.testing.assert_array_equal(confusion, cpu_confusion)


def test_kernel_wrappers_refuse_inputs_that_require_grad(device):
    """A launch would cut the graph (the kernels have no backward): with
    grad mode on, a wrapper given an input that requires grad raises;
    under no_grad it launches."""
    from pepper_tpu_torch.models.rnn import bilstm, init_lstm_params

    xs, ws, b, w_hh = _inputs(device, torch.float32, (26,), 8)
    w_hh.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        lstm_kernel.lstm_direction_fused(xs, ws, b, w_hh)
    xw = torch.zeros((33, 8, 4 * H), device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        lstm_kernel.lstm_recurrence(xw, w_hh.detach())
    params = {k: v.to(device).requires_grad_()
              for k, v in init_lstm_params(torch.Generator().manual_seed(0),
                                           26, H).items()}
    x = torch.zeros((8, 33, 26), device=device)
    with pytest.raises(RuntimeError, match="no backward"):
        bilstm(x, params)          # the kernel route: allow_kernel=True
    assert bilstm(x, params, allow_kernel=False).grad_fn is not None
    with torch.no_grad():
        out = lstm_kernel.lstm_direction_fused(xs, ws, b, w_hh)
    assert out.shape == (33, 8, H)


def _polish_step(device, tree, batch):
    """One TBPTT step (19 window updates, lr 1e-4, weight decay 1e-4) on
    `device`: each window's loss and gradients, and the params after."""
    from pepper_tpu_torch.polish import train
    from pepper_tpu_torch.train import step, trainer

    params = trainer.trainable_params(tree, device)
    leaves = [leaf for _, leaf in step.leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=1e-4, weight_decay=1e-4)
    grads, losses = [], []
    optimizer.register_step_pre_hook(lambda *_: grads.append(
        [leaf.grad.cpu().numpy().copy() for leaf in leaves]))
    train.make_tbptt_step(optimizer)(params, *batch, losses_out=losses)
    return losses, grads, [leaf.detach().cpu().numpy() for leaf in leaves]


def _polish_batch(dtype=np.float32, B=16, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (B, 1000, 10)).astype(dtype)
    labels = rng.randint(0, 5, (B, 1000)).astype(np.int32)
    mask = np.ones(B, dtype)
    mask[-1] = 0.0
    return images, labels, mask


def test_polish_tbptt_step_on_card_matches_cpu(device):
    """One full-width float64 TBPTT step on cuda against the same step on
    the CPU (each window's loss rtol 1e-5, each gradient leaf within 2e-4
    of its largest magnitude, params atol 1e-5), on the eager recurrence:
    no GRU kernel launches."""
    from pepper_tpu_torch.models.params import map_params
    from pepper_tpu_torch.models.polish_gru import init_polish_params
    from pepper_tpu_torch.ops import gru_kernel

    tree = map_params(lambda p: p.double(), init_polish_params(
        torch.Generator().manual_seed(0)))
    batch = _polish_batch(np.float64, B=4)
    for name in gru_kernel.KERNELS:
        getattr(gru_kernel, name).launches = 0
    losses, grads, params = _polish_step(device, tree, batch)
    assert not any(getattr(gru_kernel, name).launches
                   for name in gru_kernel.KERNELS)
    cpu_losses, cpu_grads, cpu_params = _polish_step("cpu", tree, batch)
    assert len(losses) == len(grads) == 19
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    for window, cpu_window in zip(grads, cpu_grads):
        for grad, cpu_grad in zip(window, cpu_window):
            bar = 2e-4 * max(np.abs(cpu_grad).max(), 1e-30)
            assert np.abs(grad - cpu_grad).max() <= bar
    for a, b in zip(params, cpu_params):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_polish_eval_on_card_runs_row_5_at_full_chunk(device):
    """The polish eval on cuda: one batch of 16 chunks of 1000 columns
    through gru_direction_fused (4 launches: 2 layers x 2 directions),
    whose output at T=1000 meets the kernel bar (1e-5) against its twin;
    the loss within rtol 1e-5 of the CPU's and the confusion equal but at
    positions whose CPU top-two logits lie within 1e-4."""
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.polish_gru import (init_polish_params,
                                                    polish_forward)
    from pepper_tpu_torch.ops import gru_kernel
    from pepper_tpu_torch.polish import train

    tree = init_polish_params(torch.Generator().manual_seed(1))
    images, labels, mask = _polish_batch(seed=1)
    cuda_tree = params_from_jax(tree, device)
    xt = torch.from_numpy(images).to(device).transpose(0, 1).contiguous()
    h0 = torch.zeros((16, 128), device=device)
    enc = cuda_tree["encoder"]
    for d in ("f", "b"):
        args = ((xt,), (enc[f"w_ih_{d}"],), enc[f"b_ih_{d}"],
                enc[f"w_hh_{d}"], enc[f"b_hh_{d}"], h0)
        with torch.no_grad():
            out, hT = gru_kernel.gru_direction_fused(*args, reverse=d == "b")
            ref, ref_hT = gru_kernel.gru_direction_fused_reference(
                *args, reverse=d == "b")
        assert (out - ref).abs().max().item() <= 1e-5
        assert (hT - ref_hT).abs().max().item() <= 1e-5
    eval_step = train.make_polish_eval_step()
    gru_kernel.gru_direction_fused.launches = 0
    loss, confusion = eval_step(cuda_tree, images, labels, mask)
    assert gru_kernel.gru_direction_fused.launches == 4
    cpu_loss, cpu_confusion = eval_step(tree, images, labels, mask)
    assert loss == pytest.approx(cpu_loss, rel=1e-5)
    with torch.inference_mode():
        logits = {d: polish_forward(
            params_from_jax(tree, d), torch.from_numpy(images).to(d),
            torch.zeros((16, 2, 128), device=d),
            allow_kernel=True)[0].cpu().numpy() for d in (device, "cpu")}
    top2 = np.sort(logits["cpu"], axis=-1)[..., -2:]
    differ = logits[device].argmax(-1) != logits["cpu"].argmax(-1)
    differ &= mask[:, None] > 0
    assert (np.diff(top2, axis=-1)[..., 0][differ] <= 1e-4).all()
    if not differ.any():
        np.testing.assert_array_equal(confusion, cpu_confusion)
    assert confusion.sum() == 15 * 1000


def test_trace_keeps_every_kernel_event_across_sessions(device, tmp_path):
    """A plain torch.profiler session, then two trace() sessions in one
    process, each around one bfloat16 transducer batch (4 launches of row
    1, 6 kernels): each trace file holds all 6 of the port's kernel events
    and trace() warns of none dropped."""
    import glob
    import json
    import os
    import warnings

    from pepper_tpu_torch import bench
    from pepper_tpu_torch.utils import profiling

    forward, tree = bench.bench_forward("bf16", device)
    x = bench.bench_inputs(256, device)
    with torch.inference_mode():
        forward(tree, x)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            forward(tree, x).sum().item()
        for session in range(2):
            log_dir = str(tmp_path / f"trace{session}")
            before = lstm_kernel.lstm_direction_fused.launches
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                with profiling.trace(log_dir):
                    forward(tree, x + session).sum().item()
            assert lstm_kernel.lstm_direction_fused.launches - before == 4
            (path,) = glob.glob(os.path.join(log_dir, "*.json"))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            names = [e.get("name", "") for e in events
                     if e.get("cat") == "kernel"]
            assert profiling.port_kernel_events(names) == 6


# buckets from the runner's smallest to its serving batch, and odd counts
# that leave the last CTA's second window empty
ATTENTION_BATCHES = [256, 257, 1001, 4096]


def _qkv(device, dtype, B, padding):
    """(B, 33, 312) packed qkv; its last `padding` rows zero, as a zero
    window's attention input has no data (its output is zero too)."""
    gen = torch.Generator(device=device).manual_seed(B)
    qkv = 0.5 * torch.randn((B, 33, 312), generator=gen, device=device)
    qkv[B - padding:] = 0
    return qkv.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", ATTENTION_BATCHES)
def test_window_attention_kernel_matches_twin(device, dtype, B):
    padding = B // 8
    qkv = _qkv(device, dtype, B, padding)
    before = attention_kernel.window_attention.launches
    out = attention_kernel.window_attention(qkv, 8)
    assert attention_kernel.window_attention.launches == before + 1
    twin = attention_kernel.window_attention_reference
    ref = twin(qkv.float(), 8)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, 33, 104)
    torch.testing.assert_close(out.float(), ref, atol=BARS[dtype], rtol=0)
    torch.testing.assert_close(out.float(), twin(qkv, 8).float(),
                               atol=BARS[torch.bfloat16], rtol=0)
    assert not out[B - padding:].any()


def test_window_attention_kernel_refuses_other_shapes(device):
    with pytest.raises(ValueError, match="window_attention takes"):
        attention_kernel.window_attention(
            torch.zeros((4, 21, 576), device=device), 8)
    with pytest.raises(ValueError, match="contiguous"):
        attention_kernel.window_attention(
            torch.zeros((312, 33, 4), device=device).transpose(0, 2), 8)


def _heads_swapped(qkv, num_heads):
    """The kernel route with its first two heads' outputs swapped."""
    out = attention_kernel.window_attention(qkv, num_heads)
    B, T, D = out.shape
    out = out.view(B, T, num_heads, D // num_heads).clone()
    out[:, :, [0, 1]] = out[:, :, [1, 0]]
    return out.reshape(B, T, D)


def _rms(a, b):
    return float(np.sqrt(np.square(a - b).mean()))


@pytest.mark.parametrize("compute_dtype,bar", [("float32", 2e-4),
                                               ("bfloat16", 1e-2)])
def test_transformer_runner_on_the_card_matches_the_cpu(device,
                                                        compute_dtype, bar):
    """The transformer family through InferenceRunner with the
    tfm.stream.bf16 cell's weights and windows (its pyramid at the scale
    where the probabilities follow the window): its six attention launches
    a batch on the kernel, device-timed inside a profiler session; the
    root mean square of the probabilities' gap from the twin route's on the
    card and from the CPU's within `bar`, and a route with two heads
    swapped beyond it (3.5e-2 to 7.9e-2 on the CPU)."""
    from unittest import mock

    from benchmark import spec
    from pepper_tpu_torch.utils import profiling

    cell = spec.load_cell("tfm.stream.bf16")
    cell.traffic.update(rows_per_device=300, pool=1)
    entry = spec.load_module("entries", cell.config["entry"]).Entry(
        cell, 8, [torch.device("cpu")])
    entry.inputs()
    tree, images = entry._weights(), entry.images[0]
    cpu = InferenceRunner(tree, batch_size=512, compute_dtype=compute_dtype,
                          model_type="transformer", device="cpu")
    card = InferenceRunner(tree, batch_size=512, compute_dtype=compute_dtype,
                           model_type="transformer", device=device)
    before = attention_kernel.window_attention.launches
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        probs = card.predict_images(images)
    assert attention_kernel.window_attention.launches - before == 6
    times = profiling.device_spans()["transformer.attention"]
    assert len(times) == 6 and all(t > 0 for t in times)
    assert len(profiling.spans()["transformer.forward"]) == 1
    profiling.clear_spans()
    with mock.patch.object(attention_kernel, "window_attention",
                           attention_kernel.window_attention_reference):
        twin = card.predict_images(images)
    assert attention_kernel.window_attention.launches - before == 6
    with mock.patch.object(attention_kernel, "attention", _heads_swapped):
        swapped = card.predict_images(images)
    assert _rms(probs, twin) <= bar
    assert _rms(probs, cpu.predict_images(images)) <= bar
    assert _rms(swapped, twin) > bar


def test_attention_route_takes_the_twin_where_a_gradient_flows(device):
    """Training differentiates the twin: a qkv that requires grad takes it
    on the card while grad mode is on, and the kernel is not launched;
    under no_grad the same qkv takes the kernel."""
    qkv = _qkv(device, torch.float32, 256, 0).requires_grad_()
    before = attention_kernel.window_attention.launches
    out = attention_kernel.attention(qkv, 8)
    assert attention_kernel.window_attention.launches == before
    assert out.grad_fn is not None
    with torch.no_grad():
        attention_kernel.attention(qkv, 8)
    assert attention_kernel.window_attention.launches == before + 1
