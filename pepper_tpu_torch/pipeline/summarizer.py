"""Per-interval summary generation (AlignmentSummarizer.py:68-242 semantics):
halo fetch, seeded reservoir downsampling, truth parsing in train mode,
hom-ref example subsampling; 48-feature HP windows under --use_hp_info,
and under --device_pileup one RegionPackage per interval."""

from __future__ import annotations

import numpy as np

from ..options import AlignerOptions, ImageOptions, ImageOptionsHP
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


def range_intersection_bed(interval, bed_intervals):
    """(AlignmentSummarizer.py:18-37)."""
    left, right = interval
    intervals = []
    for bed_left, bed_right in bed_intervals:
        if bed_right < left or bed_left > right:
            continue
        intervals.append([max(left, bed_left), min(right, bed_right)])
    return intervals


def create_region_summary(options, bam_handler, fasta_handler, contig: str,
                          region_start_position: int,
                          region_end_position: int, bed_list=None):
    """Generate candidate windows for one interval.

    Inference mode: fetch with a 100bp halo, candidates gated to the
    unpadded interval.  Train mode: iterate BED∩interval truth regions,
    attach labels, subsample hom-ref examples.  Under --use_hp_info the
    windows are RegionalSummaryHP's 21x48 images; under --device_pileup
    they come as one RegionPackage (images left to the device)."""
    halo = 100  # ConsensCandidateFinder.REGION_SAFE_BASES (Options.py:2)

    def summarize(region_start, region_end, candidate_start, candidate_end,
                  truth=None, stop_plus_one=False):
        all_reads = bam_handler.get_reads(
            contig, region_start, region_end + (1 if stop_plus_one else 0),
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
        if options.use_hp_info:
            from ..ops.pileup_hp import RegionalSummaryHP

            summary = RegionalSummaryHP(contig, region_start, region_end,
                                        ref_seq, use_native=use_native)
            window_size = ImageOptionsHP.CANDIDATE_WINDOW_SIZE
            feature_size = ImageOptionsHP.IMAGE_HEIGHT
        else:
            summary = RegionalSummary(contig, region_start, region_end,
                                      ref_seq, use_native=use_native)
            window_size = ImageOptions.CANDIDATE_WINDOW_SIZE
            feature_size = ImageOptions.IMAGE_HEIGHT
        summary.generate_max_insert_summary(all_reads)
        if truth is not None:
            summary.generate_labels(*truth)
        # mirror of call_variant.resolve_device_pileup's blockers (the
        # fused flow serves only the non-quantized lstm transducer) so a
        # direct caller can never get packages a runner won't serve
        device_pileup = (getattr(options, "device_pileup", False)
                         and not options.train_mode
                         and not options.use_hp_info
                         and not getattr(options, "dry", False)
                         and not getattr(options, "quantized", False)
                         and getattr(options, "num_devices", 1) == 1
                         and getattr(options, "model_type",
                                     "lstm") == "lstm")
        extra = {} if options.use_hp_info else {
            "build_window_images": not device_pileup}
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
            candidate_region_start=candidate_start,
            candidate_region_end=candidate_end,
            candidate_window_size=window_size,
            feature_size=feature_size,
            train_mode=options.train_mode,
            **extra)
        if device_pileup and windows:
            from ..ops.device_windows import (RegionPackage,
                                              descriptors_from_candidates)

            return [RegionPackage(
                windows=windows, image=summary.image_int8,
                region_rows=summary.region_rows,
                descriptors=descriptors_from_candidates(
                    summary.descriptor_rows, summary))]
        return windows

    if not options.train_mode:
        region_start = max(0, region_start_position - halo)
        region_end = region_end_position + halo
        return summarize(region_start, region_end, region_start_position,
                         region_end_position)

    # ---- train mode ----
    from ..io.vcf_reader import get_truth_haplotype_records

    truth_regions = []
    if bed_list is not None:
        if contig in bed_list:
            truth_regions = range_intersection_bed(
                [region_start_position, region_end_position],
                bed_list[contig])
    if not truth_regions:
        return None

    all_candidates = []
    for sub_start, sub_end in truth_regions:
        region_start = max(0, sub_start - halo)
        region_end = sub_end + halo
        truth = get_truth_haplotype_records(options.truth_vcf, contig,
                                            region_start, region_end)
        windows = summarize(region_start, region_end, region_start_position,
                            region_end_position, truth=truth,
                            stop_plus_one=True)
        if not windows:
            continue
        # random subsample of hom-ref examples (AlignmentSummarizer.py:
        # 163-179), from numpy's global generator as the JAX package draws
        # it, so that one np.random.seed gives both the same windows
        total_ref = sum(1 for w in windows if w.type_label == 0)
        draws = np.random.uniform(0.0, 1.0, total_ref)
        draw_index = 0
        for window in windows:
            if window.type_label == 0:
                keep = draws[draw_index] <= options.random_draw_probability
                draw_index += 1
                if keep:
                    all_candidates.append(window)
            else:
                all_candidates.append(window)
    return all_candidates
