"""Self-contained quickstart on simulated data (no network, no real BAMs).

Builds a small diploid genome with known SNPs, simulates haplotype reads,
writes BAM/FASTA/truth-VCF fixtures, then runs the full pipeline twice:
  1. --dry (label passthrough) — verifies the pipeline recovers the truth;
  2. train a model on a second simulated genome and call with it.

Run:  python -m pepper_tpu_torch.examples.simulated_quickstart \
          [/tmp/pepper_demo] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile

from ..device import pop_device_arg, resolve_device
from ..io.bam_writer import write_bam, write_fasta
from ..options import PepperOptions
from ..pipeline.call_variant import call_variant
from ..presets import set_parameters
from ..utils.simulate import (random_reference, score_vcf_by_type,
                              simulate_reads, write_truth_vcf)

CONTIG = "chr_demo"


def build_dataset(directory, length=8000, seed=7):
    import numpy as np

    ref = random_reference(length, seed=seed)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}
    rng = np.random.RandomState(seed)
    positions = sorted(rng.choice(np.arange(400, length - 400, 50), size=10,
                                  replace=False))
    variants = [(int(p), ref[p], alt[ref[p]],
                 "1|1" if i % 3 == 0 else "1|0")
                for i, p in enumerate(positions)]
    hap1 = [(p, r, a) for p, r, a, _ in variants]
    hap2 = [(p, r, a) for p, r, a, g in variants if g == "1|1"]
    records = simulate_reads(ref, [hap1, hap2], read_len=300, stride=25)

    os.makedirs(directory, exist_ok=True)
    bam = os.path.join(directory, "reads.bam")
    fasta = os.path.join(directory, "ref.fa")
    truth = os.path.join(directory, "truth.vcf")
    bed = os.path.join(directory, "confident.bed")
    write_bam(bam, [(CONTIG, length)], records)
    write_fasta(fasta, {CONTIG: ref})
    write_truth_vcf(truth, CONTIG, length, variants)
    with open(bed, "w") as f:
        f.write(f"{CONTIG}\t0\t{length}\n")
    return dict(bam=bam, fasta=fasta, truth=truth, bed=bed,
                variants=variants)


def _train_options(data, **fields):
    return set_parameters(PepperOptions(
        bam=data["bam"], fasta=data["fasta"], threads=1,
        ont_r9_guppy5_sup=True, train_mode=True, truth_vcf=data["truth"],
        region_bed=data["bed"], random_draw_probability=1.0, region=CONTIG,
        **fields))


def run(base, device=None, epochs=20):
    """The dry pass on one simulated genome, then a model trained on a
    second (seed 8) calling the first.  Returns {"dry": ..., "trained":
    ...}, each with the call totals and the per-type scores."""
    from ..models.checkpoint import load_params
    from ..models.transducer import TransducerConfig
    from ..pipeline.stages import image_arrays
    from ..train.trainer import train_on_arrays

    device = resolve_device(device)
    data = build_dataset(os.path.join(base, "data"))
    out_dir = os.path.join(base, "calls_dry")
    totals = call_variant(_train_options(
        data, output_dir=out_dir, sub_command="call_variant", dry=True),
        device=device)
    result = {"dry": {"totals": list(totals), "scores": score_vcf_by_type(
        os.path.join(out_dir, "PEPPER_VARIANT_FULL.vcf.gz"),
        data["variants"])}}
    print(f"\nDry run complete: {totals[0]} records "
          f"({totals[1]} PEPPER-confident). Output: {out_dir}")
    print(f"Truth variants: "
          f"{[(p, r, a, g) for p, r, a, g in data['variants']]}")

    train = build_dataset(os.path.join(base, "train_data"), seed=8)
    images, type_labels, _ = image_arrays(_train_options(
        train, sub_command="make_train_images"))
    model_path, accuracy = train_on_arrays(
        PepperOptions(batch_size=32), images, type_labels,
        os.path.join(base, "train_run"), epochs=epochs, learning_rate=3e-4,
        step_size=10_000, batch_size=32, holdout_fraction=0.1, seed=0,
        config=TransducerConfig(hidden=64, linear_size=128), device=device)
    params, _ = load_params(os.path.join(base, "train_run",
                                         "pepper_model_best.npz"))
    out_dir = os.path.join(base, "calls_trained")
    totals = call_variant(set_parameters(PepperOptions(
        bam=data["bam"], fasta=data["fasta"], output_dir=out_dir, threads=1,
        ont_r9_guppy5_sup=True, sub_command="call_variant", region=CONTIG)),
        params=params, device=device)
    result["trained"] = {
        "totals": list(totals), "train_accuracy": accuracy,
        "scores": score_vcf_by_type(
            os.path.join(out_dir, "PEPPER_VARIANT_FULL.vcf.gz"),
            data["variants"])}
    print(f"Trained-model run complete: {totals[0]} records "
          f"(train accuracy {accuracy:.2f}). Output: {out_dir}")
    print(f"\nInspect: zcat {out_dir}/PEPPER_VARIANT_FULL.vcf.gz "
          "| grep -v '^##'")
    return result


def main(argv=None):
    argv, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    base = argv[0] if argv else tempfile.mkdtemp(prefix="pepper_demo_")
    return run(base, device=device)


if __name__ == "__main__":
    main()
