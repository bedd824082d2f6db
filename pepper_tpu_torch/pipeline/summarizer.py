"""Per-interval summary generation (AlignmentSummarizer.py:68-242 semantics):
halo fetch and seeded reservoir downsampling, and under --device_pileup one
RegionPackage per interval.  Train mode (truth labels, hom-ref example
subsampling) and HP images are not ported yet and raise
NotImplementedError."""

from __future__ import annotations

import numpy as np

from ..options import AlignerOptions, ImageOptions
from ..ops.pileup_ref import RegionalSummary


def reservoir_downsample(batch, total_allowed: int,
                         seed: int = AlignerOptions.RANDOM_SEED):
    """Seeded reservoir sampling over coordinate-order reads
    (AlignmentSummarizer.py:110-125, nucleus-style)."""
    total_reads = batch.n_reads
    if total_reads <= total_allowed:
        return batch
    random = np.random.RandomState(seed)
    sample: list[int] = []
    for i in range(total_reads):
        if len(sample) < total_allowed:
            sample.append(i)
        else:
            j = random.randint(0, i + 1)
            if j < total_allowed:
                sample[j] = i
    return batch.subset(sample)


def create_region_summary(options, bam_handler, fasta_handler, contig: str,
                          region_start_position: int,
                          region_end_position: int, bed_list=None):
    """Generate candidate windows for one interval (inference mode): fetch
    with a 100bp halo, candidates gated to the unpadded interval.  Under
    --device_pileup the windows come as one RegionPackage (images left to
    the device).
    bed_list is accepted for the JAX package's signature; only train mode
    reads it."""
    halo = 100  # ConsensCandidateFinder.REGION_SAFE_BASES (Options.py:2)
    if options.train_mode:
        raise NotImplementedError(
            "train mode (truth labels through io/vcf_reader.py) is not "
            "ported yet: ROADMAP.md queue A, item 11")
    if options.use_hp_info:
        raise NotImplementedError(
            "--use_hp_info (HP images, ops/pileup_hp.py) is not ported "
            "yet: ROADMAP.md queue A, item 9")

    region_start = max(0, region_start_position - halo)
    region_end = region_end_position + halo
    all_reads = bam_handler.get_reads(
        contig, region_start, region_end,
        options.include_supplementary, options.min_mapq,
        options.min_snp_baseq)
    total_allowed = int(min(AlignerOptions.MAX_READS_IN_REGION,
                            options.downsample_rate * all_reads.n_reads))
    all_reads = reservoir_downsample(all_reads, total_allowed)
    if all_reads.n_reads == 0:
        return None
    ref_seq = fasta_handler.get_reference_sequence(
        contig, region_start, region_end + 1)
    # Halo regions can run past the contig end; faidx clamps the fetch,
    # so pad with N (no reads align there — counts stay zero).
    expected_len = region_end - region_start + 1
    if len(ref_seq) < expected_len:
        ref_seq = ref_seq + "N" * (expected_len - len(ref_seq))
    use_native = getattr(options, "use_native_pileup", True)
    summary = RegionalSummary(contig, region_start, region_end,
                              ref_seq, use_native=use_native)
    summary.generate_max_insert_summary(all_reads)
    # mirror of call_variant.resolve_device_pileup's blockers (the fused
    # flow serves only the non-quantized lstm transducer) so a direct
    # caller can never get packages a runner won't serve
    device_pileup = (getattr(options, "device_pileup", False)
                     and not options.train_mode
                     and not options.use_hp_info
                     and not getattr(options, "dry", False)
                     and not getattr(options, "quantized", False)
                     and getattr(options, "num_devices", 1) == 1
                     and getattr(options, "model_type", "lstm") == "lstm")
    windows = summary.generate_summary(
        all_reads,
        min_snp_baseq=options.min_snp_baseq,
        min_indel_baseq=options.min_indel_baseq,
        snp_freq_threshold=options.snp_frequency,
        insert_freq_threshold=options.insert_frequency,
        delete_freq_threshold=options.delete_frequency,
        min_coverage_threshold=options.min_coverage_threshold,
        snp_candidate_freq_threshold=(
            options.snp_candidate_frequency_threshold),
        indel_candidate_freq_threshold=(
            options.indel_candidate_frequency_threshold),
        candidate_support_threshold=options.candidate_support_threshold,
        skip_indels=options.skip_indels,
        candidate_region_start=region_start_position,
        candidate_region_end=region_end_position,
        candidate_window_size=ImageOptions.CANDIDATE_WINDOW_SIZE,
        feature_size=ImageOptions.IMAGE_HEIGHT,
        train_mode=False,
        build_window_images=not device_pileup)
    if device_pileup and windows:
        from ..ops.device_windows import (RegionPackage,
                                          descriptors_from_candidates)

        return [RegionPackage(
            windows=windows, image=summary.image_int8,
            region_rows=summary.region_rows,
            descriptors=descriptors_from_candidates(
                summary.descriptor_rows, summary))]
    return windows
