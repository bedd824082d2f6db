"""Standalone pipeline stages with HDF5 transport — the reference's
make_images / run_inference / find_candidates subcommand surface
(pepper_variant.py:37-97), the port of the JAX package's
pipeline/stages.py, for users who want stage-at-a-time runs and
resumability; `call_variant` streams in-process instead.  The files are
those of the JAX package's stores (io/datastore.py), so either package's
stage reads the other's; they need h5py, which call_variant does not."""

from __future__ import annotations

import os
import time

import numpy as np

from ..decode.candidate_finder import (decode_predictions_parallel,
                                       find_candidates)
from ..decode.vcf_writer import VCFWriter
from ..device import resolve_device
from ..infer.runner import InferenceRunner, fake_predict
from ..io.bam import BamReader
from ..io.datastore import ImageStore, PredictionStore
from ..io.fasta import FastaReader
from .regions import build_intervals, get_chromosome_list, log_info
from .summarizer import create_region_summary


def _image_plan(options):
    """make_images' intervals, BED regions and worker count."""
    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)
    chr_list, bed_list = get_chromosome_list(options.region, fasta_handler,
                                             bam_handler, options.region_bed)
    intervals, total_bases = build_intervals(chr_list, fasta_handler,
                                             options.region_size,
                                             options.train_mode)
    log_info(f"TOTAL CONTIGS: {len(chr_list)} TOTAL INTERVALS: "
             f"{len(intervals)} TOTAL BASES: {total_bases}")
    return intervals, bed_list, max(1, min(options.threads, len(intervals)))


def _share_summaries(options, intervals, bed_list, process_id, n_workers):
    """Yield (summary name, windows) of one worker's round-robin interval
    share, for each interval with windows.  Host code only."""
    from .call_variant import _get_handles

    bam_handler, fasta_handler = _get_handles(options.bam, options.fasta)
    for i, (contig, start, end) in enumerate(intervals):
        if i % n_workers != process_id:
            continue
        windows = create_region_summary(options, bam_handler, fasta_handler,
                                        contig, start, end, bed_list)
        if windows:
            yield f"{contig}_{start}_{end}", windows


def _image_worker(args):
    """One worker process: its round-robin interval share -> one HDF5 file
    (the reference's generate_image_and_save_to_file,
    ImageGenerationUI.py:190-274)."""
    (options, intervals, bed_list, output_dir, process_id, n_workers,
     timestr) = args
    suffix = "_hp" if options.use_hp_info else ""
    file_name = os.path.join(
        output_dir,
        f"pepper_variants_images_thread_{process_id}_{timestr}{suffix}"
        ".hdf5")
    written = 0
    with ImageStore(file_name, "w") as store:
        for name, windows in _share_summaries(options, intervals, bed_list,
                                              process_id, n_workers):
            store.write_summary(name, windows, options.train_mode)
            written += 1
    if written == 0:
        os.remove(file_name)
        return None
    return file_name


def _map_workers(worker, tasks):
    """worker over tasks, in a process pool when there are several."""
    from .call_variant import _process_pool

    if len(tasks) == 1:
        return [worker(tasks[0])]
    with _process_pool(len(tasks)) as pool:
        return list(pool.map(worker, tasks))


def make_images(options, output_dir: str):
    """Generate candidate images and save to HDF5
    (ImageGenerationUI.py:190-274 layout: one file per worker, one summary
    group per interval)."""
    os.makedirs(output_dir, exist_ok=True)
    intervals, bed_list, n_workers = _image_plan(options)
    timestr = time.strftime("%m%d%Y_%H%M%S")
    files = _map_workers(_image_worker, [
        (options, intervals, bed_list, output_dir, process_id, n_workers,
         timestr) for process_id in range(n_workers)])
    files = [f for f in files if f]
    log_info("FINISHED IMAGE GENERATION")
    return files[0] if len(files) == 1 else files


def _array_worker(args):
    """One worker's share as make_images stores it: [(summary name,
    images int8, type labels uint8, base labels uint8)], the labels zeros
    outside train mode, as the store reads them back."""
    options, intervals, bed_list, process_id, n_workers = args
    out = []
    for name, windows in _share_summaries(options, intervals, bed_list,
                                          process_id, n_workers):
        labels = np.zeros((2, len(windows)), np.uint8)
        if options.train_mode:
            labels = np.array([[w.type_label for w in windows],
                               [w.base_label for w in windows]], np.uint8)
        out.append((name, np.array([w.image for w in windows], np.int8),
                    *labels))
    return out


def image_arrays(options):
    """make_images' windows in memory, with no HDF5 store: (images float32
    (N, T, F), type labels int32 (N,), base labels int32 (N,)) in the
    order train_model reads make_images' files back (train/data.py
    load_image_dir): the files by name (worker i's holds `thread_{i}_`),
    then each file's summaries by name, as HDF5 lists a group's
    members."""
    intervals, bed_list, n_workers = _image_plan(options)
    shares = _map_workers(_array_worker, [
        (options, intervals, bed_list, process_id, n_workers)
        for process_id in range(n_workers)])
    summaries = [summary
                 for process_id in sorted(range(n_workers),
                                          key=lambda i: f"{i}_")
                 for summary in sorted(shares[process_id],
                                       key=lambda item: item[0])]
    if not summaries:
        raise ValueError("no candidate windows in the given regions")
    return tuple(np.concatenate([s[k] for s in summaries]).astype(dtype)
                 for k, dtype in ((1, np.float32), (2, np.int32),
                                  (3, np.int32)))


def _image_files(input_dir: str):
    return sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.endswith((".hdf5", ".h5")))


def _prediction_files(input_dir: str):
    return sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.endswith(".hdf"))


def run_inference(options, image_dir: str, output_dir: str, params=None,
                  device=None, devices=None):
    """Classify stored images -> prediction HDF5
    (RunInference.py:94-138 contract), on `device` (cuda unless given) or
    data parallel as call_variant runs.  As the JAX package's stage, the
    runner keeps its default compute dtype, float32 (ROADMAP.md, reference
    notes)."""
    device = resolve_device(device if devices is None else devices[0])
    os.makedirs(output_dir, exist_ok=True)
    output_file = os.path.join(output_dir, "pepper_prediction_0.hdf")
    runner = None
    if not options.dry:
        from ..options import ImageOptions, ImageOptionsHP
        from .call_variant import _inference_devices

        size_options = (ImageOptionsHP if options.use_hp_info
                        else ImageOptions)
        runner = InferenceRunner(
            params, batch_size=options.batch_size,
            window=size_options.CANDIDATE_WINDOW_SIZE + 1,
            features=size_options.IMAGE_HEIGHT,
            quantized=options.quantized,
            quantize_mode=getattr(options, "quantize_mode", "static"),
            model_type=options.model_type, device=device,
            devices=_inference_devices(options, device, devices))
    batch_no = 0
    with PredictionStore(output_file, "w") as store:
        for image_file in _image_files(image_dir):
            with ImageStore(image_file, "r") as images:
                for name in images.summary_names():
                    windows = images.read_summary(name)
                    if not windows:
                        continue
                    if options.dry:
                        predictions = fake_predict(windows)
                    else:
                        predictions = runner.predict(windows)
                    store.write_prediction(batch_no, predictions)
                    batch_no += 1
    log_info("FINISHED PREDICTION")
    return output_file


def process_candidates(options, input_dir: str, output_dir: str):
    """Predictions HDF5 -> candidate decode -> 5 VCFs
    (FindCandidates.py:156-198 contract)."""
    from .call_variant import _process_pool

    os.makedirs(output_dir, exist_ok=True)
    fasta_handler = FastaReader(options.fasta)
    all_predictions = []
    for prediction_file in _prediction_files(input_dir):
        with PredictionStore(prediction_file, "r") as store:
            for name in store.batch_names():
                all_predictions.extend(store.read_batch(name))

    log_info("STARTING CANDIDATE FINDING.")
    threads = getattr(options, "threads", 1)
    pool = _process_pool(threads) if threads > 1 else None
    try:
        margin_list, dv_list = decode_predictions_parallel(
            options, all_predictions, options.fasta, threads, pool=pool)
        contigs, margin_dict, dv_dict = find_candidates(margin_list, dv_list)
        writer = VCFWriter(contigs, fasta_handler, options.sample_name,
                           output_dir, "PEPPER_VARIANT_FULL",
                           "PEPPER_VARIANT_OUTPUT_PEPPER",
                           "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING")
        totals = writer.write_vcf_records_parallel(dv_dict, options, pool,
                                                   threads)
        writer.close()
    finally:
        if pool is not None:
            pool.shutdown()
    total, pepper, vc, snp, indel = totals
    log_info(f"FINISHED PROCESSING, TOTAL CANDIDATES FOUND: {total}")
    log_info(f"FINISHED PROCESSING, TOTAL VARIANTS IN PEPPER: {pepper}")
    log_info(f"FINISHED PROCESSING, TOTAL VARIANTS SELECTED FOR "
             f"RE-GENOTYPING: {vc}")
    log_info(f"FINISHED PROCESSING, TOTAL SNP VARIANTS SELECTED FOR "
             f"RE-GENOTYPING: {snp}")
    log_info(f"FINISHED PROCESSING, TOTAL INDEL VARIANTS SELECTED FOR "
             f"RE-GENOTYPING: {indel}")
    return totals
