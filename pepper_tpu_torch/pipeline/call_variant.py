"""End-to-end variant calling on one torch device.

Per-region windows stream in-process into padded batches through the
transducer on the device (under --device_pileup, per-region packages in
region batches through the device runner), and predictions flow into the
decoder and the VCF writer — no intermediate files.  With threads > 1 one process pool
serves window generation and candidate decoding.  The pool forks after
CUDA is initialised in this process, so the worker functions
(_interval_worker, candidate_finder._decode_worker) are host code that must
never touch torch.cuda.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import time

from ..decode.candidate_finder import decode_predictions, find_candidates
from ..decode.vcf_writer import VCFWriter
from ..device import resolve_device
from ..infer.runner import InferenceRunner, fake_predict
from ..io.bam import BamReader
from ..io.fasta import FastaReader
from ..utils import profiling
from .regions import build_intervals, get_chromosome_list, log_info
from .summarizer import create_region_summary


_worker_handles = {}


def _get_handles(bam_path, fasta_path):
    """Per-process persistent BAM/FASTA handles (pool workers process many
    intervals; reopening per task costs header+index parses).

    Keyed by PID: fork()-started pool workers inherit the parent's cache,
    and inherited readers share the parent's open file descriptions — two
    children seeking/reading through the same file offset race and return
    corrupt slices. A PID mismatch forces each child to open fresh handles.
    """
    key = (os.getpid(), bam_path, fasta_path)
    if key not in _worker_handles:
        _worker_handles.clear()  # drop inherited (cross-process) handles
        _worker_handles[key] = (BamReader(bam_path), FastaReader(fasta_path))
    return _worker_handles[key]


def _interval_worker(args):
    """Worker (one process): generate windows for a slice of intervals."""
    options, intervals, bed_list = args
    bam_handler, fasta_handler = _get_handles(options.bam, options.fasta)
    results = []
    for contig, start, end in intervals:
        windows = create_region_summary(options, bam_handler, fasta_handler,
                                        contig, start, end, bed_list)
        if windows:
            results.extend(windows)
    return results


def _process_pool(threads: int) -> concurrent.futures.ProcessPoolExecutor:
    # fork, explicitly: the workers run host code only, and fork keeps
    # their start-up free of a fresh torch import
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=threads, mp_context=multiprocessing.get_context("fork"))


def generate_windows(options, intervals, bed_list, threads: int = 1):
    """Region-sharded window generation (process-parallel like the
    reference's ImageGenerationUI.py:326-328, but returning in-memory
    windows)."""
    if threads <= 1 or len(intervals) <= 1:
        return _interval_worker((options, intervals, bed_list))
    shards = [(options, intervals[i::threads], bed_list)
              for i in range(threads)]
    all_windows = []
    with _process_pool(threads) as pool:
        for result in pool.map(_interval_worker, shards):
            all_windows.extend(result)
    return all_windows


def call_variant_sharded(options, params=None, manifest_dir=None,
                         device=None, devices=None):
    """Multi-process / resumable call_variant: intervals are claimed
    deterministically per rank, completed intervals are skipped on restart
    (explicit shard completion — no silently dropped regions), per-rank
    predictions land in HDF5 and rank 0 performs the deterministic decode
    merge (the order-independent global sort, CandidateFinder.py:549-550).
    The ranks are those of parallel/dist.py's process group (one process
    without it); each runs its inference on `device` or `devices` as
    call_variant does.  Needs h5py (io/datastore.py)."""
    from ..io.datastore import PredictionStore
    from ..parallel.dist import (RegionManifest, barrier, process_count,
                                 process_index, shard_intervals)
    from .stages import process_candidates

    rank, world = process_index(), process_count()

    # the sharded path persists per-window predictions to HDF5 between
    # processes; the fused device-window flow is single-process only
    options.device_pileup = False

    os.makedirs(options.output_dir, exist_ok=True)
    manifest_dir = manifest_dir or os.path.join(options.output_dir,
                                                "manifest")
    prediction_dir = os.path.join(options.output_dir, "predictions")
    os.makedirs(prediction_dir, exist_ok=True)

    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)
    chr_list, bed_list = get_chromosome_list(options.region, fasta_handler,
                                             bam_handler, options.region_bed)
    intervals, _ = build_intervals(chr_list, fasta_handler,
                                   options.region_size, options.train_mode)

    manifest = RegionManifest(manifest_dir)
    if rank == 0:
        manifest.write(intervals)
    barrier("manifest-written")

    my_intervals = shard_intervals(intervals, rank, world)
    pending = [i for i in my_intervals if not manifest.is_done(i)]
    log_info(f"HOST {rank}/{world}: "
             f"{len(pending)}/{len(my_intervals)} INTERVALS PENDING")

    device = resolve_device(device if devices is None else devices[0])
    runner = None
    if not options.dry:
        # as the JAX package's sharded path: the runner's default
        # compute dtype, float32 (ROADMAP.md, reference notes)
        runner = InferenceRunner(
            params, batch_size=options.batch_size,
            quantized=options.quantized,
            quantize_mode=options.quantize_mode,
            model_type=options.model_type, device=device,
            devices=_inference_devices(options, device, devices))

    output_file = os.path.join(prediction_dir,
                               f"pepper_prediction_{rank}.hdf")
    mode = "a" if os.path.exists(output_file) else "w"
    # 1-deep dispatch pipeline (same as _stream_predictions): interval
    # k's device work overlaps interval k+1's window generation.  Resume
    # stays exact — an interval is only marked done after its predictions
    # are resolved AND stored, so up to two intervals (the one in flight
    # and the one being summarized) are re-done after a crash, and
    # write_prediction skips the keys already stored.
    inflight = None  # (key, interval, handle)

    with PredictionStore(output_file, mode) as store:

        def flush():
            nonlocal inflight
            if inflight is not None:
                key, interval, handle = inflight
                store.write_prediction(key, runner.resolve(handle))
                manifest.mark_done(interval)
                inflight = None

        for contig, start, end in pending:
            windows = create_region_summary(options, bam_handler,
                                            fasta_handler, contig, start,
                                            end, bed_list)
            # interval-derived batch key so resumed runs never collide
            key = f"{contig}_{start}_{end}"
            if windows and runner is not None:
                handle = runner.dispatch(windows)
                flush()
                inflight = (key, (contig, start, end), handle)
            else:
                if windows:
                    store.write_prediction(key, fake_predict(windows))
                manifest.mark_done((contig, start, end))
        flush()

    barrier("predictions-complete")
    if rank == 0:
        return process_candidates(options, prediction_dir,
                                  options.output_dir)
    return None


def resolve_num_devices(options, device) -> None:
    """Resolve options.num_devices (-1/0 = all local devices) against the
    local device count of `device`'s type — once, up front, so the
    device_pileup gate, the summarizer mirror gate and the runners all see
    the same integer.  On the CPU it resolves to 1."""
    from ..parallel.mesh import resolve_num_devices as resolve

    options.num_devices = resolve(getattr(options, "num_devices", 1), device)


def _inference_devices(options, device, devices=None):
    """The devices the data-parallel InferenceRunner runs on, or None (one
    device); sets options.num_devices to their count.  An explicit list
    (a library caller's, possibly naming one device twice) overrides
    options.num_devices."""
    from ..parallel.mesh import local_devices

    if devices is None:
        resolve_num_devices(options, device)
        devices = local_devices(options.num_devices, device)
    else:
        devices = [resolve_device(d) for d in devices]
        options.num_devices = len(devices)
    return devices if devices and len(devices) > 1 else None


def resolve_device_pileup(options) -> None:
    """Clear options.device_pileup when the fused device-window flow
    cannot serve the request (it classifies with the bf16/f32 lstm
    transducer only): quantized serving, non-lstm families, HP images and
    dry runs all take the host window flow, explicitly and logged, so the
    user never gets a silently different model."""
    if not getattr(options, "device_pileup", False):
        return
    blockers = []
    if options.dry:
        blockers.append("--dry")
    if options.train_mode:
        blockers.append("train_mode")
    if options.use_hp_info:
        blockers.append("--use_hp_info")
    if options.quantized:
        blockers.append("--quantized")
    if getattr(options, "model_type", "lstm") != "lstm":
        blockers.append(f"--model_type {options.model_type}")
    if getattr(options, "num_devices", 1) != 1:
        # the fused region-batch dispatch is single-device
        blockers.append(f"--num_devices {options.num_devices}")
    if blockers:
        log_info("DEVICE PILEUP DISABLED (unsupported with "
                 f"{', '.join(blockers)}); using the host window flow")
        options.device_pileup = False


def _make_predict_fn(options, params, device, devices=None):
    if options.dry:
        return fake_predict
    if getattr(options, "device_pileup", False) and not options.use_hp_info:
        # fused device-window flow: the summarizer emits RegionPackages
        # (native int8 region image + injection descriptors) and window
        # gather + injection + classification run on the device, one call
        # per region batch (ops/device_windows.py)
        from ..infer.device_runner import DeviceRegionRunner

        runner = DeviceRegionRunner(
            params, compute_dtype=getattr(options, "compute_dtype",
                                          "float32"),
            region_batch=getattr(options, "device_region_batch", 32),
            device=device)
        return runner.predict
    from ..options import ImageOptions, ImageOptionsHP

    size_options = (ImageOptionsHP if options.use_hp_info
                    else ImageOptions)
    runner = InferenceRunner(
        params, batch_size=options.batch_size,
        compute_dtype=getattr(options, "compute_dtype", "float32"),
        window=size_options.CANDIDATE_WINDOW_SIZE + 1,
        features=size_options.IMAGE_HEIGHT,
        quantized=options.quantized, quantize_mode=options.quantize_mode,
        model_type=options.model_type, device=device, devices=devices)
    return runner.predict


def _stream_predictions(options, intervals, bed_list, predict_fn,
                        pool=None, on_predictions=None):
    """Overlap host-side window generation with device inference:
    interval workers run in a process pool while the main thread feeds
    completed windows to the device in batch_size slices.

    on_predictions: optional sink called with each prediction batch as it
    is produced (in stream order); when given, the returned prediction
    list is empty.  pool: reuse an existing ProcessPoolExecutor."""
    predictions = []
    sink = on_predictions if on_predictions is not None else \
        predictions.extend
    total_windows = 0
    pending = []
    # overlap audit: predict time = host time of the main thread inside
    # predict_fn (or dispatch/resolve), the device's work that it waits on
    # included; window-wait = main thread blocked on window futures
    stream_start = time.perf_counter()
    predict_time = 0.0
    wait_time = 0.0
    rows_before = profiling.padded_rows()["runner"]
    ready_before = profiling.resolve_ready()
    # device-pileup streams RegionPackages (one per region), so the drain
    # unit is a region batch rather than a window batch
    device_mode = (getattr(options, "device_pileup", False)
                   and not options.dry and not options.use_hp_info)
    chunk_size = (getattr(options, "device_region_batch", 32)
                  if device_mode else options.batch_size)
    # 1-deep dispatch pipeline: when the backend exposes dispatch/resolve
    # (InferenceRunner), batch k+1 is uploaded and enqueued BEFORE batch
    # k's probabilities are fetched.  Stream order is preserved.
    runner_obj = getattr(predict_fn, "__self__", None)
    can_pipeline = callable(getattr(runner_obj, "dispatch", None))
    inflight = None

    def drain(final=False):
        nonlocal pending, predict_time, inflight
        while len(pending) >= chunk_size or (final and pending):
            chunk = pending[:chunk_size]
            pending = pending[chunk_size:]
            t0 = time.perf_counter()
            if can_pipeline:
                handle = runner_obj.dispatch(chunk)
                if inflight is not None:
                    sink(runner_obj.resolve(inflight))
                inflight = handle
            else:
                sink(predict_fn(chunk))
            predict_time += time.perf_counter() - t0
        if final and inflight is not None:
            t0 = time.perf_counter()
            sink(runner_obj.resolve(inflight))
            inflight = None
            predict_time += time.perf_counter() - t0

    def count_windows(items):
        if device_mode:  # RegionPackage stream
            return sum(len(package.windows) for package in items)
        return len(items)

    if options.threads <= 1 or len(intervals) <= 1:
        bam_handler = BamReader(options.bam)
        fasta_handler = FastaReader(options.fasta)
        for contig, start, end in intervals:
            windows = create_region_summary(options, bam_handler,
                                            fasta_handler, contig, start,
                                            end, bed_list)
            if windows:
                total_windows += count_windows(windows)
                pending.extend(windows)
                drain()
    else:
        own_pool = None
        if pool is None:
            pool = own_pool = _process_pool(options.threads)
        try:
            futures = [
                pool.submit(_interval_worker,
                            (options, [interval], bed_list))
                for interval in intervals
            ]
            for future in concurrent.futures.as_completed(futures):
                t0 = time.perf_counter()
                windows = future.result()
                wait_time += time.perf_counter() - t0
                if windows:
                    total_windows += count_windows(windows)
                    pending.extend(windows)
                    drain()
        finally:
            if own_pool is not None:
                own_pool.shutdown()
    drain(final=True)
    wall = time.perf_counter() - stream_start
    log_info(f"STREAM OVERLAP: wall {wall:.1f}s, host in predict "
             f"{predict_time:.1f}s "
             f"({100 * predict_time / max(1e-9, wall):.0f}%), "
             f"window-wait {wait_time:.1f}s "
             f"({100 * wait_time / max(1e-9, wall):.0f}%), "
             + profiling.padded_line("runner", rows_before) + ", "
             + profiling.ready_line(ready_before))
    return predictions, total_windows


def call_variant(options, params=None, device=None, devices=None):
    """Full pipeline: windows -> model -> candidates -> 5 VCFs.

    params: transducer parameter tree (numpy arrays as load_params gives
    them, or tensors); None with options.dry uses the label passthrough.
    device: the torch device for inference, cuda unless given; with
    options.num_devices other than 1 on cuda, inference runs data parallel
    over that many local GPUs, or over `devices` where given."""
    start_time = time.time()
    device = resolve_device(device if devices is None else devices[0])
    devices = _inference_devices(options, device, devices)
    resolve_device_pileup(options)
    os.makedirs(options.output_dir, exist_ok=True)
    if devices is not None and not options.dry:
        log_info(f"INFERENCE SHARDED OVER {len(devices)} DEVICES")

    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)

    chr_list, bed_list = get_chromosome_list(options.region, fasta_handler,
                                             bam_handler,
                                             options.region_bed)
    intervals, total_bases = build_intervals(chr_list, fasta_handler,
                                             options.region_size,
                                             options.train_mode)
    log_info(f"TOTAL CONTIGS: {len(chr_list)} TOTAL INTERVALS: "
             f"{len(intervals)} TOTAL BASES: {total_bases}")

    predict_fn = _make_predict_fn(options, params, device, devices)
    if options.threads > 1 and len(intervals) > 1:
        # one pool serves both interval workers and decode chunks, so
        # candidate decoding overlaps window generation + inference; chunk
        # results are concatenated in submission order, which keeps the
        # decode stream identical to the sequential path
        from ..decode.candidate_finder import DECODE_CHUNK, _decode_worker

        decode_futures = []
        decode_buffer = []

        def submit_decode(preds, final=False):
            decode_buffer.extend(preds)
            while (len(decode_buffer) >= DECODE_CHUNK
                   or (final and decode_buffer)):
                chunk = decode_buffer[:DECODE_CHUNK]
                del decode_buffer[:DECODE_CHUNK]
                decode_futures.append(pool.submit(
                    _decode_worker, (options, options.fasta, chunk)))

        margin_list, deepvariant_list = [], []
        with _process_pool(options.threads) as pool:
            _, total_windows = _stream_predictions(
                options, intervals, bed_list, predict_fn, pool=pool,
                on_predictions=submit_decode)
            submit_decode([], final=True)
            log_info(f"TOTAL CANDIDATE WINDOWS: {total_windows}")
            log_info("FINISHED PREDICTION")
            for future in decode_futures:
                margin, deepvariant = future.result()
                margin_list.extend(margin)
                deepvariant_list.extend(deepvariant)
            contigs, margin_dict, dv_dict = find_candidates(
                margin_list, deepvariant_list)
            writer = VCFWriter(contigs, fasta_handler, options.sample_name,
                               options.output_dir, "PEPPER_VARIANT_FULL",
                               "PEPPER_VARIANT_OUTPUT_PEPPER",
                               "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING")
            totals = writer.write_vcf_records_parallel(
                dv_dict, options, pool, options.threads)
            writer.close()
    else:
        predictions, total_windows = _stream_predictions(options, intervals,
                                                         bed_list,
                                                         predict_fn)
        log_info(f"TOTAL CANDIDATE WINDOWS: {total_windows}")
        log_info("FINISHED PREDICTION")
        margin_list, deepvariant_list = decode_predictions(
            options, predictions, fasta_handler)
        contigs, margin_dict, dv_dict = find_candidates(margin_list,
                                                        deepvariant_list)
        writer = VCFWriter(contigs, fasta_handler, options.sample_name,
                           options.output_dir, "PEPPER_VARIANT_FULL",
                           "PEPPER_VARIANT_OUTPUT_PEPPER",
                           "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING")
        totals = writer.write_vcf_records(dv_dict, options)
        writer.close()

    (total, total_pepper, total_vc, total_snp, total_indel) = totals
    log_info(f"FINISHED PROCESSING, TOTAL CANDIDATES FOUND: {total}")
    log_info(f"FINISHED PROCESSING, TOTAL VARIANTS IN PEPPER: {total_pepper}")
    log_info("FINISHED PROCESSING, TOTAL VARIANTS SELECTED FOR "
             f"RE-GENOTYPING: {total_vc}")
    log_info("FINISHED PROCESSING, TOTAL SNP VARIANTS SELECTED FOR "
             f"RE-GENOTYPING: {total_snp}")
    log_info("FINISHED PROCESSING, TOTAL INDEL VARIANTS SELECTED FOR "
             f"RE-GENOTYPING: {total_indel}")
    elapsed = time.time() - start_time
    log_info(f"TOTAL ELAPSED TIME: {int(elapsed / 60)} Min "
             f"{int(elapsed) % 60} Sec")
    return totals
