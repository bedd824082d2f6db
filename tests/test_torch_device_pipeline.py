"""End-to-end --device_pileup in the port on the CPU, on
tests/test_device_pipeline.py's scene (30 kb, 40 SNPs) in float32: the
fused device-window flow through the real call_variant path must write the
same records as the port's host window flow and as the JAX package's
call_variant(device_pileup=True), with one thread and with the fork pool.

The bar is the records of all three VCFs by (contig, pos, REF, ALT, GT,
FILTER), as in tests/test_torch_call_variant.py: QUAL is printed from
float32 probabilities that the frameworks and batch shapes sum in other
orders."""

import jax
import numpy as np
import pytest

from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.pipeline import call_variant as jcv
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.cli import main as cli
from pepper_tpu_torch.models.checkpoint import save_params
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.pipeline import call_variant as cv
from pepper_tpu_torch.presets import set_parameters

from test_device_pipeline import CONTIG, sim  # noqa: F401 (fixture)
from test_torch_call_variant import VCFS, _records


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(7), TransducerConfig(hidden=32, linear_size=64)))


def _options(cls, preset, sim, out, **overrides):
    options = cls(bam=sim["bam"], fasta=sim["fasta"], output_dir=str(out),
                  threads=1, sample_name="S", ont_r9_guppy5_sup=True,
                  sub_command="call_variant", device_region_batch=4,
                  region=CONTIG, region_size=5000, batch_size=256)
    for key, value in overrides.items():
        setattr(options, key, value)
    return preset(options)


def _port_run(sim, params, name, **overrides):
    out = sim["tmp"] / name
    totals = cv.call_variant(_options(PepperOptions, set_parameters, sim,
                                      out, **overrides),
                             params=params, device="cpu")
    return totals, out


@pytest.fixture(scope="module")
def jax_device_run(sim, params):
    out = sim["tmp"] / "jax_device"
    totals = jcv.call_variant(_options(JaxOptions, jax_set_parameters, sim,
                                       out, device_pileup=True), params)
    return totals, out


def _assert_same_records(ours, theirs):
    for name in VCFS:
        assert _records(ours, name) == _records(theirs, name), name


@pytest.mark.parametrize("threads", [1, 2])
def test_device_pileup_matches_host_flow_and_jax(sim, params, jax_device_run,
                                                 threads):
    totals_host, out_host = _port_run(sim, params, f"host{threads}",
                                      threads=threads)
    totals_dev, out_dev = _port_run(sim, params, f"dev{threads}",
                                    threads=threads, device_pileup=True)
    jax_totals, out_jax = jax_device_run
    assert totals_host[0] > 0
    assert totals_dev == totals_host == jax_totals
    _assert_same_records(out_dev, out_host)
    _assert_same_records(out_dev, out_jax)


BLOCKERS = [dict(dry=True), dict(use_hp_info=True), dict(quantized=True),
            dict(model_type="transformer"), dict(train_mode=True),
            dict(num_devices=2), {}]


@pytest.mark.parametrize("blocker", BLOCKERS, ids=lambda b: ",".join(b)
                         or "none")
def test_resolve_device_pileup_gating_equals_jax(blocker):
    """Unsupported combinations clear the flag (and say so); the supported
    one keeps it; the port decides as the JAX package does."""
    def make(cls):
        base = dict(device_pileup=True, dry=False, use_hp_info=False,
                    quantized=False, model_type="lstm")
        base.update(blocker)
        return cls(**base)

    ours, theirs = make(PepperOptions), make(JaxOptions)
    cv.resolve_device_pileup(ours)
    jcv.resolve_device_pileup(theirs)
    assert ours.device_pileup is theirs.device_pileup is (not blocker)


@pytest.mark.parametrize("override,item", [
    ({"model_type": "no_cnn"}, "item 6"),
    ({"use_hp_info": True}, "item 9"),
])
def test_cleared_flag_still_refuses_unported_modes(sim, params, override,
                                                   item):
    """--device_pileup gives way to the host flow for these modes, which
    the port does not serve yet."""
    with pytest.raises(NotImplementedError, match=item):
        _port_run(sim, params, "refused", device_pileup=True, **override)


def test_cli_device_pileup_region_batch(sim, params):
    model = str(sim["tmp"] / "model.npz")
    save_params(model, params, {"model_type": "lstm"})
    out = sim["tmp"] / "cli_device"
    assert cli.main(["call_variant", "-b", sim["bam"], "-f", sim["fasta"],
                     "-m", model, "-o", str(out), "-s", "S", "-r", CONTIG,
                     "--region_size", "5000", "--ont_r9_guppy5_sup",
                     "--compute_dtype", "float32", "--device", "cpu",
                     "--device_pileup", "--device_region_batch", "4"]) == 0
    _, out_lib = _port_run(sim, params, "lib_device", device_pileup=True,
                           batch_size=4096)
    _assert_same_records(out, out_lib)
