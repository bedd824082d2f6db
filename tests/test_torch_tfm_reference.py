"""The transformer window classifier served through the port's
InferenceRunner(model_type="transformer") on the CPU against the
benchmark's plain reference (benchmark/reference/pepper_tfm.py), with
seeded weights built as the benchmark's entry builds them, at the
published widths (d_model 104, 8 heads of 13, FFN 2048, six layers) and
B = 64.  Also: the attention twin against the JAX package's _mha, the
int8 window upload of every float family, and the device spans outside a
profiler session.

Bars: float32 1e-5 (both compute every product in float32 and differ in
summation order alone); bfloat16 3e-2: the port rounds every activation to
bfloat16 (2**-9 relative), through six post-LN layers whose residual sums
and norms round again, and the pyramid, at the cell's variance-keeping
scale, carries that into logits that vary by ~0.5 across windows: the
widest gap measured was 1.1e-2 to 1.4e-2 in 1,024 windows a seed (three
seeds, CPU); the bar holds 64 windows at twice that.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import spec
from pepper_tpu.models import alternates as jalt
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.models import alternates
from pepper_tpu_torch.ops import attention_kernel
from pepper_tpu_torch.utils import profiling

B = 64
BARS = {"float32": 1e-5, "bfloat16": 3e-2}


def _cell_weights_and_windows(seed):
    """The tfm.stream.bf16 cell's weights and one batch of its windows on
    the CPU, as its entry makes them (gammas near 1, BatchNorm statistics
    from the pool's first batch)."""
    cell = spec.load_cell("tfm.stream.bf16")
    cell.traffic.update(rows_per_device=B, pool=1)
    entry = spec.load_module("entries", cell.config["entry"]).Entry(
        cell, seed, [torch.device("cpu")])
    entry.inputs()
    return cell.config, entry.reference, entry._weights(), entry.images[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runner_matches_the_plain_reference(dtype):
    config, reference, weights, images = _cell_weights_and_windows(
        2 ** 31 + 99)
    expected = reference.forward(weights, config, torch.from_numpy(images))
    runner = InferenceRunner(weights, batch_size=B, compute_dtype=dtype,
                             window=config["window"],
                             features=config["image_features"],
                             model_type="transformer", device="cpu")
    probs = runner.predict_images(images)
    assert probs.shape == (B, 3) and probs.dtype == np.float32
    np.testing.assert_allclose(probs, expected.numpy(), rtol=0,
                               atol=BARS[dtype])


def test_reference_calibrates_batchnorm_as_the_port():
    """The entry's BatchNorm statistics (the reference's
    calibrate_batchnorm) are those the port's post-training calibration
    sets from the same batch."""
    _, _, weights, images = _cell_weights_and_windows(5)
    calibrated = alternates.transformer_calibrate_batchnorm(
        weights, torch.from_numpy(images))
    for bn in ("bn1", "bn2"):
        for stat in ("mean", "var"):
            torch.testing.assert_close(weights[bn][stat],
                                       calibrated[bn][stat], rtol=1e-5,
                                       atol=1e-5)


def _layer(rng, D, scale=0.3):
    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    return {"w_qkv": u(D, 3 * D), "b_qkv": u(3 * D),
            "out_proj": {"w": u(D, D), "b": u(D)}}


@pytest.mark.parametrize("D,heads,T", [(104, 8, 33), (192, 8, 21)],
                         ids=["variant", "hp"])
@pytest.mark.parametrize("kernel", [False, True], ids=["twin", "route"])
def test_attention_matches_jax_mha(D, heads, T, kernel):
    """_mha over the twin, and over the route every forward takes (the
    twin on the CPU), against the JAX package's _mha in float32."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, T, D)).astype(np.float32)
    lp = _layer(rng, D)
    expected = jalt._mha(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, lp), heads)
    torch_lp = {"w_qkv": torch.from_numpy(lp["w_qkv"]),
                "b_qkv": torch.from_numpy(lp["b_qkv"]),
                "out_proj": {k: torch.from_numpy(v)
                             for k, v in lp["out_proj"].items()}}
    route = (contextlib.nullcontext() if kernel else mock.patch.object(
        attention_kernel, "attention",
        attention_kernel.window_attention_reference))
    with route:
        actual = alternates._mha(torch.from_numpy(x), torch_lp, heads)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=1e-5, atol=1e-5)


def test_route_takes_the_twin_on_the_cpu_and_counts_nothing():
    qkv = torch.randn(3, 33, 312)
    before = attention_kernel.window_attention.launches
    out = attention_kernel.attention(qkv, 8)
    assert attention_kernel.window_attention.launches == before
    assert torch.equal(out, attention_kernel.window_attention_reference(
        qkv, 8))
    assert attention_kernel.kernel_takes(qkv, 8)
    assert not attention_kernel.kernel_takes(qkv, 4)
    assert not attention_kernel.kernel_takes(torch.randn(3, 21, 576), 8)
    assert not attention_kernel.kernel_takes(qkv.double(), 8)


def _family_tree(name, seed=4):
    from pepper_tpu_torch.models.registry import make_family

    return make_family(name).init(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["transformer", "no_cnn"])
def test_int8_upload_bit_identical_to_float32(name, compute_dtype):
    """Every family's int8 windows ship as int8 and widen on the device;
    the probabilities equal the float32 upload's bit for bit."""
    runner = InferenceRunner(_family_tree(name), batch_size=8,
                             compute_dtype=compute_dtype, model_type=name,
                             device="cpu")
    images = np.random.default_rng(6).integers(
        -125, 126, (11, 33, 26)).astype(np.int8)
    assert runner._upload_dtype(images) == np.int8
    assert runner._upload_dtype(images.astype(np.float32)) == np.float32
    np.testing.assert_array_equal(
        runner.predict_images(images),
        runner.predict_images(images.astype(np.float32)))


def test_transformer_forward_is_a_span_inside_a_profiler_session():
    runner = InferenceRunner(_family_tree("transformer"), batch_size=4,
                             model_type="transformer", device="cpu")
    images = np.zeros((4, 33, 26), np.int8)
    profiling.clear_spans()
    runner.predict_images(images)
    assert "transformer.forward" not in profiling.spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        runner.predict_images(images)
    assert len(profiling.spans()["transformer.forward"]) == 1
    profiling.clear_spans()


def test_device_spans_are_empty_outside_a_profiler_session():
    profiling.clear_spans()
    with profiling.device_span("transformer.attention"):
        torch.zeros(3).sum()
    assert profiling.device_spans() == {}
    assert profiling.device_span("x") is profiling.span("y")
