"""The int8 weight layouts the port's kernels read, and where they are made.

Every int8 kernel (csrc/int8_projection.cuh, the static_rec recurrence of
csrc/lstm_core.cuh) reads an int8 weight k-major: each 4 bytes of a row are
one B register of mma.sync m16n8k32 (csrc/mma_ptx.cuh).  These tests derive
that layout from the PTX ISA's fragment tables in plain numpy and hold the
relayout to it, round trip included, and show that the served paths
(models/quantize.py's static trees) relay each weight once per tree and
keep the copy (cuda_build.keep_relaid), not once per launch.  They run on
the CPU: the serving path's launches are driven on meta tensors with the
launcher recorded, so nothing runs.
"""

import numpy as np
import pytest
import torch

from pepper_tpu_torch.models import quantize
from pepper_tpu_torch.models.polish_gru import (PolishConfig,
                                                init_polish_params)
from pepper_tpu_torch.models.transducer import (TransducerConfig,
                                                init_transducer_params)
from pepper_tpu_torch.ops import cuda_build, gru_kernel, lstm_kernel
from pepper_tpu_torch.ops.cuda_build import int8_kmajor


def _weight(K, N, seed):
    return np.random.RandomState(seed).randint(-127, 128, (K, N)).astype(
        np.int8)


def _b_fragments(w, k0, n0):
    """(b0, b1) of each lane of mma.m16n8k32's B operand for the 32 x 8
    block of w (K, N) at (k0, n0), from the PTX ISA: lane = 4g + i holds,
    in b0, rows k0 + 4i .. 4i + 3 of column n0 + g, and in b1 the same 16
    rows further; the first row in the lowest byte."""
    frags = np.zeros((32, 2, 4), np.int8)
    for lane in range(32):
        g, i = divmod(lane, 4)
        for r in range(2):
            for byte in range(4):
                frags[lane, r, byte] = w[k0 + 16 * r + 4 * i + byte, n0 + g]
    return frags


def _kmajor_reads(w_t, k0, n0):
    """What the kernels read from the k-major w_t (N, K) for that block:
    ldmatrix's matrix over rows n0..n0+7 and 16 bytes from k0 (b0) or k0+16
    (b1) gives lane 4g + i the 4 bytes at column offset 4i of row g."""
    reads = np.zeros((32, 2, 4), np.int8)
    for lane in range(32):
        g, i = divmod(lane, 4)
        for r in range(2):
            start = k0 + 16 * r + 4 * i
            reads[lane, r] = w_t[n0 + g, start:start + 4]
    return reads


@pytest.mark.parametrize("K,N", [(512, 1024), (256, 384), (32, 96),
                                 (256, 1024)],
                         ids=["lstm_decoder_w_ih", "gru_decoder_w_ih",
                              "narrow", "lstm_w_hh"])
def test_kmajor_relayout_is_the_mma_b_fragment_layout(K, N):
    w = _weight(K, N, K + N)
    w_t = int8_kmajor(torch.from_numpy(w)).numpy()
    assert w_t.shape == (N, K) and w_t.flags["C_CONTIGUOUS"]
    rng = np.random.RandomState(0)
    blocks = [(0, 0), (K - 32, N - 8)] + [
        (32 * rng.randint(K // 32), 8 * rng.randint(N // 8))
        for _ in range(6)]
    for k0, n0 in blocks:
        np.testing.assert_array_equal(_kmajor_reads(w_t, k0, n0),
                                      _b_fragments(w, k0, n0))
    # the 32-bit words of a row, little-endian: byte b of word [n][kq] is
    # w[4 kq + b][n]
    words = w_t.view(np.uint32)
    expected = np.zeros((N, K // 4), np.uint32)
    for b in range(4):
        expected |= (w[b::4].T.astype(np.uint8).astype(np.uint32) << (8 * b))
    np.testing.assert_array_equal(words, expected)
    # round trip: the inverse is the same transpose
    back = int8_kmajor(torch.from_numpy(w_t)).numpy()
    np.testing.assert_array_equal(back, w)


# ---------------------------------------------------------------- served paths


class _Launches:
    """A stand-in for cuda_build.launch: records each launch's name and
    arguments (tensors, not pointers: see `recorded`); nothing runs."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, device, *args):
        self.calls.append((name, args))


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' device path on meta tensors: require_cuda passes,
    launch records, and ptr hands over the tensor itself (a meta tensor has
    no address), so each launch's operands can be told apart."""
    launches = _Launches()
    for module in (lstm_kernel, gru_kernel):
        monkeypatch.setattr(module, "launch", launches)
        monkeypatch.setattr(module, "require_cuda", lambda t, name: None)
        monkeypatch.setattr(module, "ptr", lambda t: t)
    return launches


def _transducer_tree(rec_int8, compute_dtype, device):
    params = init_transducer_params(torch.Generator().manual_seed(3),
                                    TransducerConfig(hidden=32,
                                                     linear_size=64))
    host = {name: {k: v.numpy() for k, v in node.items()}
            for name, node in params.items()}
    return quantize.prepare_static(
        quantize.quantize_params_static(host, rec_int8=rec_int8),
        compute_dtype, device)


def _int8_weights(tree):
    """(node, key) of every int8 weight of the two biLSTMs."""
    return [(tree[layer], key) for layer in ("encoder", "decoder")
            for key in ("w_ih_f", "w_ih_b", "w_hh_f", "w_hh_b")
            if tree[layer][key].dtype == torch.int8]


def _kept(w):
    """The copy keep_relaid kept for w; asking relays nothing."""
    before = cuda_build.relayout_int8.count
    copy = cuda_build.relaid((w,))
    assert cuda_build.relayout_int8.count == before
    return copy


def _serve(tree, rec_int8, compute_dtype, batches=2, T=5, B=4):
    """transducer_infer_static's two biLSTM layers, on meta tensors."""
    enc, dec = tree["encoder"], tree["decoder"]

    def rec(node):
        return (node["as_hh_f"], node["as_hh_b"]) if rec_int8 else None

    for _ in range(batches):
        x = torch.empty((T, B, 26), dtype=compute_dtype, device="meta")
        f1, b1 = lstm_kernel.bilstm_fused_static(
            (x,), enc, rec_scale=rec(enc), out_int8=True)
        lstm_kernel.bilstm_fused_static(
            (f1, b1), dec, acc_scale=(dec["as_f"], dec["as_b"]),
            rec_scale=rec(dec), out_int8=True)


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
def test_static_tree_relays_each_int8_weight_once(rec_int8, compute_dtype,
                                                  recorded):
    """prepare_static relays each int8 weight of the two biLSTMs once,
    k-major, and keeps the copy; a prepared tree is not relaid again, and
    serving batches from it relays nothing: every launch reads the kept
    copies."""
    before = cuda_build.relayout_int8.count
    tree = _transducer_tree(rec_int8, compute_dtype, "meta")
    weights = _int8_weights(tree)
    assert len(weights) == (6 if rec_int8 else 2)
    assert cuda_build.relayout_int8.count == before + len(weights)
    again = quantize.prepare_static(tree, compute_dtype, "meta")
    assert again["decoder"]["w_ih_f"] is tree["decoder"]["w_ih_f"]
    assert cuda_build.relayout_int8.count == before + len(weights)

    kept = {id(_kept(node[key])) for node, key in weights}

    after_prepare = cuda_build.relayout_int8.count
    _serve(tree, rec_int8, compute_dtype)
    assert cuda_build.relayout_int8.count == after_prepare
    assert len(recorded.calls) == 8
    # each launch's int8 operands (the W_ih parts at 5 and 6, W_hh at 12)
    # are the kept copies themselves
    handed = set()
    for _, args in recorded.calls:
        for arg in (args[5], args[6], args[12]):
            if isinstance(arg, torch.Tensor) and arg.dtype == torch.int8:
                assert arg._base is None
                handed.add(id(arg))
    assert handed == kept
    # the float32 encoder's window values are projected into an xw first,
    # as the decoder's codes are; the bfloat16 encoder's 26 join the step
    enc_f, _, dec_f, _ = (args for _, args in recorded.calls[:4])
    assert (enc_f[13] is None) == (compute_dtype == torch.bfloat16)
    assert dec_f[13].dtype == torch.float32


def test_static_launches_read_the_kept_copies(recorded):
    """On the served bfloat16 static_rec path the kernel gets each kept
    copy itself: W_hh k-major at argument 12, the decoder's one k-major
    W_ih for both parts at 5 (6 empty), an xw scratch at 13 for the
    decoder only."""
    tree = _transducer_tree(True, torch.bfloat16, "meta")
    enc, dec = tree["encoder"], tree["decoder"]
    _serve(tree, True, torch.bfloat16, batches=1)
    (_, enc_f), (_, enc_b), (_, dec_f), (_, dec_b) = recorded.calls
    assert enc_f[12] is _kept(enc["w_hh_f"])
    assert enc_b[12] is _kept(enc["w_hh_b"])
    assert enc_f[13] is None  # the encoder's x joins the step
    assert dec_f[5] is _kept(dec["w_ih_f"])
    assert dec_b[5] is _kept(dec["w_ih_b"])
    assert dec_b[6] is None
    assert dec_b[12] is _kept(dec["w_hh_b"])
    H = enc["w_hh_f"].shape[0]
    assert dec_b[13].shape == (5, 4, 4 * H)


def test_weights_without_kept_copies_relay_at_each_launch(recorded):
    """A wrapper handed int8 weights that have no kept copy relays them at
    each launch (what the served trees save), and so does one handed row
    slices that do not cover the kept weight."""
    tree = _transducer_tree(True, torch.bfloat16, "meta")
    dec = {k: (v.clone() if v.dtype == torch.int8 else v)
           for k, v in tree["decoder"].items()}
    x = torch.empty((5, 4, 32), dtype=torch.int8, device="meta")
    before = cuda_build.relayout_int8.count
    for _ in range(2):
        lstm_kernel.bilstm_fused_static(
            (x, x), dec, acc_scale=(dec["as_f"], dec["as_b"]),
            rec_scale=(dec["as_hh_f"], dec["as_hh_b"]), out_int8=True)
    # W_ih and W_hh of two directions, twice
    assert cuda_build.relayout_int8.count == before + 8
    w = tree["decoder"]["w_ih_f"]
    assert cuda_build.relaid((w[:32],)).shape == (w.shape[1], 32)
    assert cuda_build.relaid((w[32:], w[:32])) is not _kept(w)
    assert cuda_build.relayout_int8.count == before + 10


def test_a_written_weight_is_relaid_again():
    """A kept copy serves only the weight as it was: once the weight is
    written in place, the next launch relays it (and keep_relaid keeps the
    new copy)."""
    w = torch.from_numpy(_weight(64, 96, 7))
    kept = cuda_build.keep_relaid(w)
    assert _kept(w) is kept
    w[0, 0] = -w[0, 0] - 1
    before = cuda_build.relayout_int8.count
    fresh = cuda_build.relaid((w[:32], w[32:]))
    assert cuda_build.relayout_int8.count == before + 1
    np.testing.assert_array_equal(fresh.numpy(), w.numpy().T)
    again = cuda_build.keep_relaid(w)
    assert again is not kept and _kept(w) is again


def test_inference_tensors_keep_their_copies():
    """transducer_infer_static prepares its tree under
    torch.inference_mode, whose tensors carry no version counter: their
    copies are kept and found all the same."""
    with torch.inference_mode():
        tree = _transducer_tree(False, torch.bfloat16, "cpu")
        w = tree["decoder"]["w_ih_f"]
        assert w.is_inference()
        kept = _kept(w)
        assert cuda_build.relaid((w[:32], w[32:])) is kept


def test_polish_static_tree_relays_once(recorded):
    """The polish consensus's static tree (polish_prepare_static) keeps the
    decoder's int8 W_ih k-major; the window loop relays nothing and every
    decoder launch reads the kept copy."""
    params = init_polish_params(torch.Generator().manual_seed(5),
                                PolishConfig(hidden=32))
    host = {name: {k: v.numpy() for k, v in node.items()}
            for name, node in params.items()}
    q = {name: {k: torch.as_tensor(v, device="meta") for k, v in node.items()}
         for name, node in quantize.polish_quantize_params_static(
             host).items()}
    before = cuda_build.relayout_int8.count
    tree = quantize.polish_prepare_static(q)
    assert cuda_build.relayout_int8.count == before + 2
    assert quantize.polish_prepare_static(tree) is tree
    assert cuda_build.relayout_int8.count == before + 2
    dec = tree["decoder"]
    H = dec["w_hh_f"].shape[0]
    T, B = 10, 4
    hidden = torch.empty((B, 2, H), device="meta")
    for _ in range(3):  # windows
        xt = torch.empty((T, B, 10), device="meta")
        f1, b1, hid = gru_kernel.bigru_fused_static((xt,), tree["encoder"],
                                                    hidden)
        gru_kernel.bigru_fused_static((f1, b1), dec, hid,
                                      acc_scale=(dec["as_f"], dec["as_b"]))
    assert cuda_build.relayout_int8.count == before + 2
    decoder_calls = [args for _, args in recorded.calls
                     if args[0] == cuda_build.DTYPE_CODE[torch.int8]]
    assert [args[4] for args in decoder_calls] == [
        _kept(dec["w_ih_f"]), _kept(dec["w_ih_b"])] * 3


@pytest.mark.parametrize("rec_int8", [False, True],
                         ids=["static", "static_rec"])
def test_hp_static_tree_serves_the_48_feature_encoder_on_the_core(rec_int8,
                                                                  recorded):
    """At the HP shape (48 bfloat16 features) the static encoder runs on
    the core too: prepare_static relays its int8 W_hh (static_rec) k-major
    once, and each encoder launch reads that kept copy and hands the core
    a float32 (T, B, 4H) xw to project x into."""
    params = init_transducer_params(
        torch.Generator().manual_seed(4),
        TransducerConfig(hidden=32, linear_size=64, image_features=48,
                         window=21))
    host = {name: {k: v.numpy() for k, v in node.items()}
            for name, node in params.items()}
    before = cuda_build.relayout_int8.count
    tree = quantize.prepare_static(
        quantize.quantize_params_static(host, rec_int8=rec_int8),
        torch.bfloat16, "meta")
    weights = _int8_weights(tree)
    assert cuda_build.relayout_int8.count == before + len(weights)
    enc = tree["encoder"]
    H = enc["w_hh_f"].shape[0]
    assert enc["w_ih_f"].shape == (48, 4 * H)
    kept = {id(_kept(node[key])) for node, key in weights}

    after_prepare = cuda_build.relayout_int8.count
    x = torch.empty((21, 4, 48), dtype=torch.bfloat16, device="meta")
    lstm_kernel.bilstm_fused_static(
        (x,), enc, rec_scale=((enc["as_hh_f"], enc["as_hh_b"]) if rec_int8
                              else None), out_int8=True)
    assert cuda_build.relayout_int8.count == after_prepare
    assert len(recorded.calls) == 2
    for _, args in recorded.calls:
        w_rec, xw = args[12], args[13]
        assert (id(w_rec) in kept) == rec_int8
        assert xw.shape == (21, 4, 4 * H) and xw.dtype == torch.float32
