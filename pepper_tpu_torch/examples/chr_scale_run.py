"""Chromosome-scale soak: train once, then call a chr20-class simulated
genome (SNP+INS+DEL truth incl. homopolymer-adjacent indels) through the
real pipeline and score per variant type.  The port of the JAX package's
examples/chr_scale_run.py.

  python -m pepper_tpu_torch.examples.chr_scale_run [genome_mb] [threads] \
      [error_model] [coverage_x] [--device cpu]

error_model "uniform" (default) or "ont" (homopolymer-scaled indels,
strand bias, correlated quals — utils/simulate.py apply_ont_errors).
coverage_x scales read strides (default ~36x; e.g. 20 for a low-coverage
point).
"""

from __future__ import annotations

import os
import sys
import tempfile

from ..device import pop_device_arg, resolve_device
from ..utils.profiling import StageTimer, kernel_launches, log_line
from ..utils.simulate import build_mixed_genome
from .acceptance_run import call_and_score, train_variant_model

PRODUCT_FILES = ("PEPPER_VARIANT_FULL", "PEPPER_VARIANT_OUTPUT_PEPPER",
                 "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING")


def strides_for(coverage):
    """The default strides (160, 160, 550) give ~36x total; scale
    inversely."""
    scale = 36.0 / coverage
    return (int(160 * scale), int(160 * scale), int(550 * scale))


def run(genome_mb=20.0, threads=None, error_model="uniform", coverage=36.0,
        device=None, epochs=12, base=None):
    """Returns {"stats": {file: per-type scores}, "train_accuracy": ...,
    "base": ...}: the FULL file (every call) and the two product outputs
    the reference pipeline consumes, the PEPPER-confident VCF and the
    re-genotype VCF that downstream DeepVariant re-examines
    (VcfWriter.py:163-217 routing)."""
    device = resolve_device(device)
    threads = threads or os.cpu_count() or 8
    strides = strides_for(coverage)
    base = base or tempfile.mkdtemp(prefix="pepper_chr_")
    with StageTimer("SIMULATE TRAIN GENOME (SNP+INS+DEL)"):
        train_genome = build_mixed_genome(base, "train", 500_000, 1500,
                                          2500, 31, strides=strides,
                                          error_model=error_model)
    with StageTimer(f"SIMULATE {genome_mb} Mb TEST GENOME (SNP+INS+DEL)"):
        test_genome = build_mixed_genome(base, "test",
                                         int(genome_mb * 1_000_000),
                                         int(genome_mb * 700),
                                         int(genome_mb * 1000), 32,
                                         strides=strides,
                                         error_model=error_model)
    params, accuracy = train_variant_model(
        train_genome, os.path.join(base, "run"), threads, device,
        epochs=epochs)
    stats = call_and_score(test_genome, params, os.path.join(base, "calls"),
                           threads, device, 16384,
                           "CALL_VARIANT (chr-scale)", names=PRODUCT_FILES)
    log_line(f"KERNEL LAUNCHES: {kernel_launches()}")
    log_line(f"OUTPUT: {base}")
    return {"stats": stats, "train_accuracy": accuracy, "base": base}


def main(argv=None):
    argv, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    genome_mb = float(argv[0]) if len(argv) > 0 else 20.0
    threads = int(argv[1]) if len(argv) > 1 else (os.cpu_count() or 8)
    error_model = argv[2] if len(argv) > 2 else "uniform"
    coverage = float(argv[3]) if len(argv) > 3 else 36.0
    return run(genome_mb, threads, error_model, coverage, device=device)


if __name__ == "__main__":
    main()
