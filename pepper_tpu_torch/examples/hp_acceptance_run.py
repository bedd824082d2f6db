"""HP-mode (haplotagged) trained acceptance: train a 48-channel window
classifier on haplotagged simulated reads (HP aux tags emitted by the
simulator, parsed natively), then call an unseen mixed SNP/INS/DEL genome
through the real call_variant --use_hp_info path and score per variant
type.  The port of the JAX package's examples/hp_acceptance_run.py.

  python -m pepper_tpu_torch.examples.hp_acceptance_run [genome_mb] \
      [threads] [error_model] [coverage] [--device cpu]

error_model: "uniform" (default), "ont", or "ont_str"; coverage scales
the simulated read strides (36x default).
"""

from __future__ import annotations

import os
import sys
import tempfile

from ..device import pop_device_arg, resolve_device
from ..utils.profiling import StageTimer, kernel_launches, log_line
from ..utils.simulate import build_mixed_genome
from .acceptance_run import call_and_score, train_variant_model
from .chr_scale_run import strides_for


def run(genome_mb=2.0, threads=None, error_model="uniform", coverage=36.0,
        device=None, epochs=12, base=None):
    """Returns {"stats": the per-type scores, "train_accuracy": ...,
    "base": ...}."""
    from ..models.transducer import TransducerConfig

    device = resolve_device(device)
    threads = threads or os.cpu_count() or 8
    strides = strides_for(coverage)
    base = base or tempfile.mkdtemp(prefix="pepper_hp_acceptance_")
    with StageTimer("SIMULATE TRAIN GENOME (0.5 Mb, haplotagged)"):
        train_genome = build_mixed_genome(base, "train", 500_000, 1500,
                                          2500, 11, strides=strides,
                                          error_model=error_model)
    with StageTimer("SIMULATE TEST GENOME (haplotagged)"):
        test_genome = build_mixed_genome(base, "test",
                                         int(genome_mb * 1_000_000),
                                         int(genome_mb * 700),
                                         int(genome_mb * 1000), 22,
                                         strides=strides,
                                         error_model=error_model)
    params, accuracy = train_variant_model(
        train_genome, os.path.join(base, "train_run"), threads, device,
        epochs=epochs, use_hp_info=True,
        config=TransducerConfig(image_features=48, window=21, hidden=64,
                                linear_size=128))
    stats = call_and_score(test_genome, params, os.path.join(base, "calls"),
                           threads, device, 16384,
                           "CALL_VARIANT --use_hp_info (full pipeline)",
                           use_hp_info=True)
    log_line(f"KERNEL LAUNCHES: {kernel_launches()}")
    log_line(f"OUTPUT: {base}")
    return {"stats": stats["PEPPER_VARIANT_FULL"],
            "train_accuracy": accuracy, "base": base}


def main(argv=None):
    argv, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    genome_mb = float(argv[0]) if len(argv) > 0 else 2.0
    threads = int(argv[1]) if len(argv) > 1 else (os.cpu_count() or 8)
    error_model = argv[2] if len(argv) > 2 else "uniform"
    coverage = float(argv[3]) if len(argv) > 3 else 36.0
    return run(genome_mb, threads, error_model, coverage, device=device)


if __name__ == "__main__":
    main()
