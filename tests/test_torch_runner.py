"""The port's InferenceRunner on the CPU against the JAX package's, same
weights and windows.  float32 probabilities are held to rtol/atol 2e-4
(the transducer bar); the runner's own transport (int8 upload, dispatch/
resolve, bucket padding) must not change a bit.
"""

import jax
import numpy as np
import pytest
import torch

from pepper_tpu.infer.runner import InferenceRunner as JaxRunner
from pepper_tpu.models.transducer import (TransducerConfig as JaxConfig,
                                          init_transducer_params)
from pepper_tpu.ops.pileup_ref import CandidateWindow as JaxWindow
from pepper_tpu_torch.device import resolve_device
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.ops.pileup_ref import CandidateWindow
from pepper_tpu_torch.utils import profiling


def _params(seed=0):
    return jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(seed), JaxConfig(hidden=32, linear_size=64)))


def _windows(n, seed=1, cls=CandidateWindow):
    rng = np.random.default_rng(seed)
    return [cls(contig="chr1", position=100 + i, depth=30,
                candidates=[f"{i % 4}T"], candidate_frequency=[9],
                image=rng.integers(-125, 126, (33, 26)).astype(np.int8))
            for i in range(n)]


def test_predict_matches_jax_runner():
    params = _params()
    ours = InferenceRunner(params, batch_size=16, device="cpu").predict(
        _windows(21))
    theirs = JaxRunner(params, batch_size=16).predict(
        _windows(21, cls=JaxWindow))
    assert len(ours) == len(theirs) == 21
    for a, b in zip(ours, theirs):
        assert (a.contig, a.position, a.depth, a.candidates,
                a.candidate_frequency) == (b.contig, b.position, b.depth,
                                           b.candidates,
                                           b.candidate_frequency)
        assert a.prediction_base.dtype == np.float32
        np.testing.assert_allclose(a.prediction_base, b.prediction_base,
                                   rtol=2e-4, atol=2e-4)


def test_dispatch_resolve_matches_predict():
    runner = InferenceRunner(_params(), batch_size=8, device="cpu")
    windows = _windows(8, seed=2)
    sync = runner.predict(windows)
    piped = runner.resolve(runner.dispatch(windows))
    assert [p.position for p in piped] == [p.position for p in sync]
    for a, b in zip(piped, sync):
        np.testing.assert_array_equal(a.prediction_base, b.prediction_base)
    # an oversized chunk runs the multi-batch loop inside dispatch
    big = _windows(20, seed=3)
    for a, b in zip(runner.resolve(runner.dispatch(big)), runner.predict(big)):
        np.testing.assert_array_equal(a.prediction_base, b.prediction_base)
    assert runner.resolve(runner.dispatch([])) == []
    assert runner.predict([]) == []


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_a_one_deep_loop_resolves_each_batch_as_predict_images(devices):
    """call_variant's drain: dispatch batch k, then resolve batch k-1.
    Each batch's probabilities are bitwise predict_images' on it when
    resolved, and still are after two further dispatches and resolves (no
    prediction is a view of a block the runner hands out again)."""
    runner = InferenceRunner(_params(), batch_size=8, device="cpu",
                             devices=devices)
    batches = [_windows(n, seed=10 + k)
               for k, n in enumerate((8, 8, 5, 8, 3, 8, 8))]
    expected = [runner.predict_images(np.stack([w.image for w in batch]))
                for batch in batches]
    resolved, inflight = [], None
    for batch in batches:
        handle = runner.dispatch(batch)
        if inflight is not None:
            resolved.append(runner.resolve(inflight))
            k = len(resolved) - 1
            assert [p.position for p in resolved[k]] == [
                w.position for w in batches[k]]
            np.testing.assert_array_equal(
                np.stack([p.prediction_base for p in resolved[k]]),
                expected[k])
        inflight = handle
    resolved.append(runner.resolve(inflight))
    for preds, probs in zip(resolved, expected):
        np.testing.assert_array_equal(
            np.stack([p.prediction_base for p in preds]), probs)


class _Event:
    """A CUDA event's stand-in: done or not when queried; records the
    calls made to it."""

    def __init__(self, done, calls):
        self.done, self.calls = done, calls

    def query(self):
        self.calls.append("query")
        return self.done

    def synchronize(self):
        self.calls.append("synchronize")


def test_the_ready_counter_counts_one_resolve_a_call():
    """One count a resolve, ready where every block was done when its
    wait began (a CPU block, with no event, always is)."""
    runner = InferenceRunner(_params(), batch_size=8, device="cpu")
    before = profiling.resolve_ready()
    for handle in [runner.dispatch(_windows(n, seed=20 + n))
                   for n in (8, 3, 8)]:
        runner.resolve(handle)
    assert tuple(now - then for now, then in
                 zip(profiling.resolve_ready(), before)) == (3, 3)
    block = torch.zeros((2, 3))
    for done, ready in (((True, True), 1), ((True, False), 0),
                        ((False, True), 0)):
        calls, before = [], profiling.resolve_ready()
        InferenceRunner._gather(
            [(block, None)] + [(block, _Event(d, calls)) for d in done])
        assert calls == ["query", "synchronize"] * 2
        assert tuple(now - then for now, then in
                     zip(profiling.resolve_ready(), before)) == (ready, 1)
        assert profiling.ready_line(before) == (
            f"resolves ready {ready} of 1 ({100.0 * ready:.1f}%)")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_upload_bit_identical_to_float32(compute_dtype):
    runner = InferenceRunner(_params(), batch_size=8,
                             compute_dtype=compute_dtype, device="cpu")
    images8 = np.stack([w.image for w in _windows(13)])
    assert runner._upload_dtype(images8) == np.int8
    assert runner._upload_dtype(images8.astype(np.float32)) == np.float32
    np.testing.assert_array_equal(
        runner.predict_images(images8),
        runner.predict_images(images8.astype(np.float32)))


@pytest.mark.parametrize("batch_size", [16, 256, 4096, 5000])
def test_bucket_matches_jax(batch_size):
    params = _params()
    ours = InferenceRunner(params, batch_size=batch_size, device="cpu")
    theirs = JaxRunner(params, batch_size=batch_size)
    for n in (1, 10, 255, 256, 257, 300, 1000, 4000, 4096, 4097, 6000):
        assert ours._bucket(n) == theirs._bucket(n), n


def test_padding_does_not_change_rows():
    """Rows are independent through every layer, so the bucket a chunk is
    padded to cannot change its probabilities."""
    params = _params()
    images = np.stack([w.image for w in _windows(10)])
    a = InferenceRunner(params, batch_size=4096, device="cpu")
    b = InferenceRunner(params, batch_size=16, device="cpu")
    np.testing.assert_allclose(a.predict_images(images),
                               b.predict_images(images), atol=1e-6)


def test_params_live_on_the_device_in_the_compute_dtype():
    runner = InferenceRunner(_params(), compute_dtype="bfloat16",
                             device="cpu")
    assert runner.device == torch.device("cpu")
    w = runner.params["decoder"]["w_hh_b"]
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"


@pytest.mark.parametrize("mode,atol", [("static", 2e-4),
                                      ("static_rec", 2e-4),
                                      ("dynamic", 1e-2)])
def test_quantized_modes_match_jax_runner(mode, atol):
    """float32 compute; the dynamic mode's recurrence is bfloat16 in both,
    with f32 state in the port (the TPU kernel's) and bf16 state in the
    JAX package's CPU fallback, hence its wider bar."""
    params = _params()
    kw = dict(batch_size=16, quantized=True, quantize_mode=mode)
    ours = InferenceRunner(params, device="cpu", **kw)
    assert (ours.quantized, ours.quantize_mode) == (True, mode)
    ours = ours.predict(_windows(21))
    theirs = JaxRunner(params, **kw).predict(_windows(21, cls=JaxWindow))
    assert len(ours) == len(theirs) == 21
    for a, b in zip(ours, theirs):
        assert (a.position, a.candidates) == (b.position, b.candidates)
        assert a.prediction_base.dtype == np.float32
        np.testing.assert_allclose(a.prediction_base, b.prediction_base,
                                   atol=atol)
        assert a.prediction_base.argmax() == b.prediction_base.argmax()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "static_rec", "dynamic"])
def test_quantized_int8_upload_bit_identical_to_float32(mode,
                                                        compute_dtype):
    runner = InferenceRunner(_params(), batch_size=8, quantized=True,
                             quantize_mode=mode, compute_dtype=compute_dtype,
                             device="cpu")
    images8 = np.stack([w.image for w in _windows(13)])
    assert runner._upload_dtype(images8) == np.int8
    np.testing.assert_array_equal(
        runner.predict_images(images8),
        runner.predict_images(images8.astype(np.float32)))


def test_quantized_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="quantize_mode"):
        InferenceRunner(_params(), quantized=True, quantize_mode="int4",
                        device="cpu")


def test_quantized_rejects_other_families_before_the_registry():
    """quantized + a non-lstm family is a ValueError, raised before the
    registry (which would say the family is not ported) is asked."""
    with pytest.raises(ValueError, match="quantized"):
        InferenceRunner(_params(), quantized=True, model_type="no_cnn",
                        device="cpu")


def test_static_tree_lives_on_the_device_in_the_kernel_dtypes():
    runner = InferenceRunner(_params(), compute_dtype="bfloat16",
                             quantized=True, quantize_mode="static_rec",
                             device="cpu")
    enc, dec = runner.params["encoder"], runner.params["decoder"]
    assert enc["w_ih_f"].dtype == torch.bfloat16
    assert enc["w_hh_f"].dtype == dec["w_hh_b"].dtype == torch.int8
    assert dec["as_hh_f"].dtype == enc["b_b"].dtype == torch.float32


def test_unported_modes_raise():
    """The transformer family, refused until item 6 was ported, now serves
    float windows as the JAX runner does (the transducer's bar)."""
    from pepper_tpu.models.registry import make_family

    params = jax.tree_util.tree_map(np.array, make_family(
        "transformer").init(jax.random.PRNGKey(3)))
    ours = InferenceRunner(params, batch_size=16, model_type="transformer",
                           device="cpu").predict(_windows(5))
    theirs = JaxRunner(params, batch_size=16, model_type="transformer"
                       ).predict(_windows(5, cls=JaxWindow))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.prediction_base, b.prediction_base,
                                   rtol=2e-4, atol=2e-4)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for device in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(device)
