"""Each plain reference against the port's CPU path at tiny batch sizes,
with the same weights and inputs from the benchmark's generator."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate, spec


def test_snp_reference_matches_the_port_on_the_cpu():
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.transducer import transducer_infer

    config = spec.load_cell("snp.stream.f32").config
    reference = spec.load_module("reference", "pepper_snp")
    weights = generate.make_weights(reference.param_shapes(config), 21,
                                    "cpu")
    images = torch.from_numpy(generate.make_pool(
        config, 8, 1, (33, 26), 21)[0])
    port = transducer_infer(params_from_jax(weights, "cpu"), images,
                            torch.float32)
    ref = reference.forward(weights, config, images)
    assert port.shape == ref.shape == (8, 3)
    assert float((port - ref).abs().max()) < 1e-5


def test_polish_reference_matches_the_port_on_the_cpu():
    from pepper_tpu_torch.polish.consensus import consensus_predict

    config = spec.load_cell("polish.consensus.f32").config
    reference = spec.load_module("reference", "pepper_polish")
    weights = generate.make_weights(reference.param_shapes(config), 22,
                                    "cpu")
    images = generate.make_pool(config, 2, 1, (1000, 10), 22)[0]
    labels, phred = consensus_predict(weights, images, batch_size=2,
                                      device="cpu")
    ref_labels, fraction, margin = (
        t.numpy() for t in reference.consensus(
            weights, config, torch.from_numpy(images)))
    port_fraction = 1.0 - 10.0 ** (-phred.astype(np.float64) / 10)
    assert np.abs(port_fraction - fraction).max() < 1e-5
    clear = margin > 1e-3
    assert clear.mean() > 0.5
    assert (labels[clear] == ref_labels[clear]).all()
