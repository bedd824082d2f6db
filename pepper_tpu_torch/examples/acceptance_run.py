"""Chr-scale acceptance run on simulated data: train on one genome, call a
2 Mb unseen genome with the trained model, score recall/precision/genotype
concordance PER VARIANT TYPE (SNP/INS/DEL — the reference's published
contract is per-type F1 tables, docs/pipeline_docker/ONT_variant_calling.md)
and wall-clock per stage. Truth includes insertions and deletions of length
1-10 with homopolymer-adjacent sites, 3% uniform per-base sequencing errors
and a systematic-noise read population.  The port of the JAX package's
examples/acceptance_run.py; training takes its windows in memory
(pipeline/stages.py image_arrays, make_images' arrays in its order).

  python -m pepper_tpu_torch.examples.acceptance_run [genome_mb] [threads] \
      [error_model] [--device cpu]

error_model "uniform" (default): 3% uniform per-base substitutions.
error_model "ont": the homopolymer-scaled, strand-biased sub+indel process
with correlated qualities (utils/simulate.py apply_ont_errors) — the regime
behind the reference's published INDEL F1 of 0.77-0.88
(docs/pipeline_docker/ONT_variant_calling.md:149-154).
"""

from __future__ import annotations

import os
import sys
import tempfile

from ..device import pop_device_arg, resolve_device
from ..utils.profiling import StageTimer, kernel_launches, log_line
from ..utils.simulate import build_mixed_genome, score_vcf_by_type


def print_score_table(stats, log_line):
    log_line("TYPE    N      RECALL   PRECISION  GT-CONCORDANCE  (TP/FP/FN)")
    for kind in ("SNP", "INS", "DEL", "ALL"):
        s = stats[kind]
        log_line(f"{kind:<6} {s['n']:<6} {s['recall']:.4f}   "
                 f"{s['precision']:.4f}     {s['gt_concordance']:.4f}"
                 f"          ({s['tp']}/{s['fp']}/{s['fn']})")


def train_variant_model(genome, out_dir, threads, device, *, epochs=12,
                        use_hp_info=False, config=None):
    """make_images' windows of a simulated genome (in memory), then
    train_model's recipe on them: lr 3e-4, batch 64, 10% held out, seed 0.
    Returns (the best checkpoint's params, held-out accuracy)."""
    from ..models.checkpoint import load_params
    from ..models.transducer import TransducerConfig
    from ..options import PepperOptions
    from ..pipeline.stages import image_arrays
    from ..presets import set_parameters
    from ..train.trainer import train_on_arrays

    train_options = set_parameters(PepperOptions(
        bam=genome["bam"], fasta=genome["fasta"], ont_r9_guppy5_sup=True,
        sub_command="make_train_images", train_mode=True,
        truth_vcf=genome["truth"], region_bed=genome["bed"],
        random_draw_probability=1.0, region=genome["contig"],
        threads=threads, use_hp_info=use_hp_info))
    with StageTimer("TRAIN IMAGE GENERATION", unit="windows") as timer:
        images, type_labels, _ = image_arrays(train_options)
        timer.add(len(images))
    with StageTimer("TRAINING", unit="windows") as timer:
        _, accuracy = train_on_arrays(
            PepperOptions(batch_size=64, use_hp_info=use_hp_info), images,
            type_labels, out_dir, epochs=epochs, learning_rate=3e-4,
            step_size=10_000, batch_size=64, holdout_fraction=0.1, seed=0,
            config=config or TransducerConfig(hidden=64, linear_size=128),
            device=device)
        timer.add(epochs * len(images))
    log_line(f"TRAIN ACCURACY: {accuracy:.2f}")
    params, _ = load_params(os.path.join(out_dir, "pepper_model_best.npz"))
    return params, accuracy


def call_and_score(genome, params, out_dir, threads, device, batch_size,
                   stage, use_hp_info=False,
                   names=("PEPPER_VARIANT_FULL",)):
    """call_variant with the trained params on a simulated genome, then
    each named VCF's per-type table.  Returns {name: stats}."""
    from ..options import PepperOptions
    from ..pipeline.call_variant import call_variant
    from ..presets import set_parameters

    call_options = set_parameters(PepperOptions(
        bam=genome["bam"], fasta=genome["fasta"], output_dir=out_dir,
        ont_r9_guppy5_sup=True, sub_command="call_variant",
        region=genome["contig"], threads=threads, batch_size=batch_size,
        use_hp_info=use_hp_info))
    with StageTimer(stage):
        call_variant(call_options, params=params, device=device)
    tables = {}
    for name in names:
        path = os.path.join(out_dir, name + ".vcf.gz")
        if not os.path.exists(path):
            continue
        if len(names) > 1:
            log_line(f"=== {name} ===")
        tables[name] = score_vcf_by_type(path, genome["variants"])
        print_score_table(tables[name], log_line)
    return tables


def run(genome_mb=2.0, threads=None, error_model="uniform", device=None,
        train_mb=0.5, epochs=12, base=None):
    """Train on a train_mb genome (3 variants and 5 noise sites a kb, as
    the JAX run's 0.5 Mb with 1,500 and 2,500), call a genome_mb one (0.7
    and 1 a kb).  Returns {"stats": the per-type scores, "train_accuracy":
    ..., "base": the run's directory}."""
    device = resolve_device(device)
    threads = threads or os.cpu_count() or 8
    base = base or tempfile.mkdtemp(prefix="pepper_acceptance_")
    with StageTimer(f"SIMULATE TRAIN GENOME ({train_mb} Mb, SNP+INS+DEL)"):
        train_genome = build_mixed_genome(
            base, "train", int(train_mb * 1_000_000), int(train_mb * 3000),
            int(train_mb * 5000), 11, error_model=error_model)
    with StageTimer("SIMULATE TEST GENOME (SNP+INS+DEL)"):
        test_genome = build_mixed_genome(base, "test",
                                         int(genome_mb * 1_000_000),
                                         int(genome_mb * 700),
                                         int(genome_mb * 1000), 22,
                                         error_model=error_model)
    params, accuracy = train_variant_model(
        train_genome, os.path.join(base, "train_run"), threads, device,
        epochs=epochs)
    stats = call_and_score(test_genome, params, os.path.join(base, "calls"),
                           threads, device, 2048,
                           "CALL_VARIANT (full pipeline)")
    log_line(f"KERNEL LAUNCHES: {kernel_launches()}")
    log_line(f"OUTPUT: {base}")
    return {"stats": stats["PEPPER_VARIANT_FULL"],
            "train_accuracy": accuracy, "base": base}


def main(argv=None):
    argv, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    genome_mb = float(argv[0]) if len(argv) > 0 else 2.0
    threads = int(argv[1]) if len(argv) > 1 else (os.cpu_count() or 8)
    error_model = argv[2] if len(argv) > 2 else "uniform"
    return run(genome_mb, threads, error_model, device=device)


if __name__ == "__main__":
    main()
