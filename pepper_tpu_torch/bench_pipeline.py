"""End-to-end pipeline throughput on simulated data, the port of the JAX
package's bench_pipeline.py (not the headline bench — see bench.py for the
single JSON metric).

    python -m pepper_tpu_torch.bench_pipeline [genome_mb] [threads]
    python -m pepper_tpu_torch.bench_pipeline vcf [n_sites] [threads]
    python -m pepper_tpu_torch.bench_pipeline device [genome_mb] [threads]
    python -m pepper_tpu_torch.bench_pipeline consensus [num_devices] \
        [batch] [float32|static]
    python -m pepper_tpu_torch.bench_pipeline polish [kb] [error_model] \
        [repeats]
    python -m pepper_tpu_torch.bench_pipeline windows [mb] [error_model] \
        [repeats]

Add `--device cpu` to run the device stages on the CPU; they run on cuda
otherwise and raise without it.  Each function logs its stages in the
reference's format (utils/profiling.py) and returns them as a dict.  A
stage that ends on device work ends on a host fetch, so its wall time
covers the device's part.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from .utils.profiling import StageTimer, kernel_launches, log_line


def _snp_scene(directory, length, seed, error_model="uniform"):
    """A diploid SNP genome at ~36x (3 kb reads, 170 bp strides a
    haplotype; a SNP every ~1.4 kb, a third homozygous), written as
    r.bam and ref.fa under directory.  Returns (bam, fasta, records,
    hap1)."""
    from .io.bam_writer import write_bam, write_fasta
    from .utils.simulate import random_reference, simulate_reads

    os.makedirs(directory, exist_ok=True)
    ref = random_reference(length, seed=seed)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}
    rng = np.random.RandomState(seed)
    positions = sorted(rng.choice(np.arange(500, length - 500, 700),
                                  size=length // 1400, replace=False))
    hap1 = [(int(p), ref[p], alt[ref[p]]) for p in positions]
    hap2 = [v for i, v in enumerate(hap1) if i % 3 == 0]
    records = simulate_reads(ref, [hap1, hap2], read_len=3000,
                             strides=[170, 170], error_model=error_model)
    bam = os.path.join(directory, "r.bam")
    fasta = os.path.join(directory, "ref.fa")
    write_bam(bam, [("chrB", length)], records)
    write_fasta(fasta, {"chrB": ref})
    return bam, fasta, records, hap1


def _stage(timer: StageTimer) -> dict:
    return {"seconds": timer.elapsed, "count": timer.count,
            "unit": timer.unit,
            "per_s": timer.count / max(1e-9, timer.elapsed)}


def main_stages(genome_mb: float = 1.0, threads: int | None = None,
                device=None, workdir: str | None = None) -> dict:
    """Simulates a diploid genome at ~36x, then times each stage of
    call_variant: window generation (native pileup), inference on
    `device`, candidate decode and VCF writing."""
    import torch

    from .decode.candidate_finder import (decode_predictions_parallel,
                                          find_candidates)
    from .decode.vcf_writer import VCFWriter
    from .device import resolve_device
    from .infer.runner import InferenceRunner
    from .io.fasta import FastaReader
    from .models.transducer import init_transducer_params
    from .options import PepperOptions
    from .pipeline.call_variant import _process_pool, generate_windows
    from .pipeline.regions import build_intervals
    from .presets import set_parameters

    device = resolve_device(device)
    threads = threads or os.cpu_count() or 4
    length = int(genome_mb * 1_000_000)
    log_line(f"SIMULATING {genome_mb} Mb GENOME @ ~36x, {threads} THREADS")
    tmp = workdir or tempfile.mkdtemp(prefix="pepper_bench_")
    stages = {}
    with StageTimer("SIMULATION+BAM WRITE", unit="reads") as timer:
        bam, fasta, records, hap1 = _snp_scene(tmp, length, seed=3)
        timer.add(len(records))
    stages["simulation"] = _stage(timer)

    options = set_parameters(PepperOptions(
        bam=bam, fasta=fasta, ont_r9_guppy5_sup=True,
        sub_command="call_variant", region="chrB", threads=threads,
        batch_size=4096, output_dir=tmp))
    fasta_handler = FastaReader(fasta)
    intervals, _ = build_intervals([("chrB", None)], fasta_handler,
                                   options.region_size)
    aligned_bases = sum(len(r.seq) for r in records)
    log_line(f"READS: {len(records)}  ALIGNED BASES: {aligned_bases:,}  "
             f"TRUE VARIANTS: {len(hap1)}")

    with StageTimer("WINDOW GENERATION (native pileup)",
                    unit="aligned-bases") as timer:
        windows = generate_windows(options, intervals, None, threads)
        timer.add(aligned_bases)
    stages["windows"] = {**_stage(timer), "windows": len(windows),
                         "per_core": aligned_bases / timer.elapsed / threads}
    log_line(f"CANDIDATE WINDOWS: {len(windows)}")

    params = init_transducer_params(torch.Generator().manual_seed(0))
    runner = InferenceRunner(params, batch_size=options.batch_size,
                             compute_dtype="bfloat16", device=device)
    runner.predict(windows[:options.batch_size])  # warmup
    # predict gathers its probabilities to the host: the stage's barrier
    with StageTimer(f"INFERENCE ({device.type})", unit="windows") as timer:
        predictions = runner.predict(windows)
        timer.add(len(windows))
    stages["inference"] = _stage(timer)

    with _process_pool(threads) as pool:
        with StageTimer("DECODE (pool)", unit="candidates") as timer:
            margin, dv = decode_predictions_parallel(
                options, predictions, fasta, threads, pool=pool)
            timer.add(len(predictions))
        stages["decode"] = _stage(timer)
        contigs, _, dv_dict = find_candidates(margin, dv)
        with StageTimer("VCF WRITE (pool)", unit="records") as timer:
            writer = VCFWriter(contigs, fasta_handler, "S", tmp, "FULL",
                               "PEP", "VC")
            totals = writer.write_vcf_records_parallel(dv_dict, options,
                                                       pool, threads)
            writer.close()
            timer.add(totals[0])
        stages["vcf"] = _stage(timer)
    log_line(f"TOTAL RECORDS: {totals[0]}")
    log_line(f"OUTPUT: {tmp}")
    return {"genome_mb": genome_mb, "threads": threads,
            "device": str(device), "reads": len(records),
            "aligned_bases": aligned_bases, "true_variants": len(hap1),
            "records": totals[0], "stages": stages}


def bench_vcf_only(n_sites: int, threads: int, workdir: str | None = None,
                   contig_len: int = 500_000_000) -> dict:
    """WGS-tail VCF emission bench: n_sites synthetic multiallelic-ish
    sites over a contig_len contig -> 5 bgzf VCFs + tabix, sequential vs
    pool-parallel.  contig_len is the JAX bench's 500 Mb unless given; the
    subcommand never gives it, and the CPU tests pass a small one to skip
    the ~20 s draw of n_sites positions out of 500 M."""
    import shutil

    from .decode.vcf_writer import VCFWriter
    from .io.bam_writer import write_fasta
    from .io.fasta import FastaReader
    from .options import PepperOptions
    from .pipeline.call_variant import _process_pool
    from .presets import set_parameters

    options = set_parameters(PepperOptions(
        ont_r9_guppy5_sup=True, sub_command="call_variant"))
    tmp = tempfile.mkdtemp(prefix="pepper_vcfbench_", dir=workdir)
    write_fasta(os.path.join(tmp, "ref.fa"),
                {"chr1": "ACGT" * 256})  # header only needs names/lengths
    fasta_handler = FastaReader(os.path.join(tmp, "ref.fa"))
    # synthetic dv candidates shaped like decode output (12-tuple)
    rng = np.random.RandomState(7)
    log_line(f"SYNTHESIZING {n_sites:,} SITES")
    positions = np.sort(rng.choice(contig_len, size=n_sites, replace=False))
    probs = rng.dirichlet(np.ones(3) * 0.6, size=n_sites)
    depths = rng.randint(20, 60, size=n_sites)
    supports = rng.randint(5, 40, size=n_sites)
    kinds = rng.randint(0, 3, size=n_sites)
    dv_dict = {}
    for i in range(n_sites):
        pos = int(positions[i])
        ref_allele, alt = (("A", "T"), ("A", "ACC"), ("ACC", "A"))[kinds[i]]
        p = probs[i]
        candidate = ("chr1", pos, pos + len(ref_allele), ref_allele,
                     [alt], [0, 1], int(depths[i]), [int(supports[i])],
                     float(p.max()), p, [float(p[1:].max())], bool(i % 5 == 0))
        dv_dict[("chr1", pos)] = [candidate]

    results = {}
    timings = {}
    for label, env, run_threads in (
            ("native, 1 thread", None, 1),
            (f"native, {threads} threads", None, threads),
            ("python engine, 1 core", "1", 1),
            (f"python engine, pool x{threads}", "1", threads)):
        out = os.path.join(tmp, label.replace(" ", "_").replace(",", ""))
        os.makedirs(out)
        if env:
            os.environ["PEPPER_PY_VCF"] = env
        pool = None
        if env and run_threads > 1:
            pool = _process_pool(run_threads)
            pool.submit(os.getpid).result()  # spin up outside the timer
        try:
            writer = VCFWriter(["chr1"], fasta_handler, "S", out, "FULL",
                               "PEP", "VC")
            with StageTimer(f"VCF WRITE ({label})", unit="records") as timer:
                totals = writer.write_vcf_records_parallel(
                    dv_dict, options, pool, run_threads)
                writer.close()
                timer.add(totals[0])
            results[label] = totals
            timings[label] = _stage(timer)
        finally:
            os.environ.pop("PEPPER_PY_VCF", None)
            if pool is not None:
                pool.shutdown()
    if len(set(results.values())) != 1:
        raise RuntimeError(f"VCF engines disagree: {results}")
    shutil.rmtree(tmp)
    return {"sites": n_sites, "totals": list(next(iter(results.values()))),
            "stages": timings}


def _event_regions(options, intervals, bam, fasta_handler, n_sample):
    """The Python walker's events of the first n_sample intervals, as the
    event flow takes them: (event_list, ref_channels, descriptor_list,
    region_sizes, aligned bases covered)."""
    from .io.bam import BamReader
    from .ops.device_windows import descriptors_from_candidates
    from .ops.pileup_ref import RegionalSummary, encode_reference_values

    bam_handler = BamReader(bam)
    event_list, ref_channels, descriptor_list, region_sizes = [], [], [], []
    covered = 0
    for contig, start, end in intervals[:n_sample]:
        reads = bam_handler.get_reads(contig, start, end, False, 0, 0)
        ref_seq = fasta_handler.get_reference_sequence(contig, start,
                                                       end + 1)
        summary = RegionalSummary(contig, start, end, ref_seq,
                                  matrix_backend="recorder")
        summary.generate_max_insert_summary(reads)
        holder = {}
        summary.matrix_backend = \
            lambda r, c, d, shape, holder=holder: (
                holder.__setitem__("events", (r, c, d))
                or np.zeros(shape, np.int64))
        summary.generate_summary(
            reads, min_snp_baseq=options.min_snp_baseq,
            min_indel_baseq=options.min_indel_baseq,
            snp_freq_threshold=options.snp_frequency,
            insert_freq_threshold=options.insert_frequency,
            delete_freq_threshold=options.delete_frequency,
            min_coverage_threshold=options.min_coverage_threshold,
            snp_candidate_freq_threshold=(
                options.snp_candidate_frequency_threshold),
            indel_candidate_freq_threshold=(
                options.indel_candidate_frequency_threshold),
            candidate_support_threshold=(
                options.candidate_support_threshold),
            skip_indels=False, candidate_region_start=start,
            candidate_region_end=end)
        if "events" not in holder or not summary.descriptor_rows:
            continue
        event_list.append(holder["events"])
        n_ref = end - start + 1
        values = np.asarray(encode_reference_values(ref_seq))
        if summary.total_observed_insert_bases:
            values = np.repeat(values,
                               1 + summary.max_observed_insert[:n_ref])
        ref_channels.append(values)
        descriptor_list.append(descriptors_from_candidates(
            summary.descriptor_rows, summary))
        region_sizes.append(summary.region_rows)
        covered += sum(len(reads.read_seq(i)) for i in range(reads.n_reads))
    return event_list, ref_channels, descriptor_list, region_sizes, covered


def bench_device(genome_mb: float = 5.0, threads: int | None = None,
                 device=None, workdir: str | None = None) -> dict:
    """Pileup-flow shootout on `device`: host windows -> runner vs the two
    fused flows (native images with the window gather on the device, and
    the event stream through the histogram kernel).  Every dispatch is a
    distinct execution (a different region batch) and the probability
    fetch is the timing barrier."""
    import torch

    from .device import resolve_device
    from .infer.device_runner import DeviceRegionRunner
    from .infer.runner import InferenceRunner
    from .io.fasta import FastaReader
    from .models.transducer import init_transducer_params
    from .ops.device_windows import classify_regions_events
    from .options import PepperOptions
    from .pipeline.call_variant import generate_windows
    from .pipeline.regions import build_intervals
    from .presets import set_parameters

    device = resolve_device(device)
    threads = threads or os.cpu_count() or 4
    length = int(genome_mb * 1_000_000)
    log_line(f"SIMULATING {genome_mb} Mb @ ~36x, {threads} THREADS, "
             f"DEVICE {device}")
    tmp = workdir or tempfile.mkdtemp(prefix="pepper_devbench_")
    bam, fasta, _, _ = _snp_scene(tmp, length, seed=5)

    def make_options(device_pileup):
        return set_parameters(PepperOptions(
            bam=bam, fasta=fasta, ont_r9_guppy5_sup=True,
            sub_command="call_variant", region="chrB", threads=threads,
            batch_size=4096, output_dir=tmp, device_pileup=device_pileup,
            region_size=10000))

    fasta_handler = FastaReader(fasta)
    intervals, _ = build_intervals([("chrB", None)], fasta_handler, 10000)
    params = init_transducer_params(torch.Generator().manual_seed(0))
    stages = {}

    # ---- A: host windows + padded-batch runner ----
    options = make_options(False)
    with StageTimer("A: HOST WINDOW GENERATION", unit="windows") as timer:
        windows = generate_windows(options, intervals, None, threads)
        timer.add(len(windows))
    stages["a_windows"] = _stage(timer)
    runner = InferenceRunner(params, batch_size=4096,
                             compute_dtype="bfloat16", device=device)
    runner.predict(windows[:4096])  # warmup
    with StageTimer("A: RUNNER INFERENCE", unit="windows") as timer:
        host_predictions = runner.predict(windows)
        timer.add(len(windows))
    stages["a_inference"] = _stage(timer)

    # ---- B: native image -> fused device windows ----
    options = make_options(True)
    with StageTimer("B: REGION PACKAGE GENERATION", unit="windows") as t:
        packages = generate_windows(options, intervals, None, threads)
        n_windows = sum(len(p.windows) for p in packages)
        t.add(n_windows)
    stages["b_packages"] = _stage(t)
    device_runner = DeviceRegionRunner(params, compute_dtype="bfloat16",
                                       region_batch=32, device=device)
    device_runner.predict(packages[:32])  # warmup
    with StageTimer("B: FUSED IMAGE DISPATCH (32 regions/dispatch)",
                    unit="windows") as timer:
        device_predictions = device_runner.predict(packages)
        timer.add(n_windows)
    stages["b_dispatch"] = _stage(timer)
    host_by_key = {(p.contig, p.position, tuple(p.candidates)): p
                   for p in host_predictions}
    agree = sum(
        1 for p in device_predictions
        if np.argmax(host_by_key[(p.contig, p.position,
                                  tuple(p.candidates))].prediction_base)
        == np.argmax(p.prediction_base))
    log_line(f"B vs A argmax agreement: {agree}/{len(device_predictions)}")

    # ---- C: event stream -> histogram kernel fused flow ----
    with StageTimer("C: PYTHON EVENT-STREAM GENERATION",
                    unit="aligned-bases") as timer:
        (event_list, ref_channels, descriptor_list, region_sizes,
         covered) = _event_regions(options, intervals, bam, fasta_handler,
                                   min(64, len(intervals)))
        timer.add(covered)
    stages["c_events"] = _stage(timer)
    k_events = sum(len(e[0]) for e in event_list)
    n_windows_c = sum(len(d.base_index) for d in descriptor_list)
    log_line(f"C: {len(event_list)} regions, {k_events:,} events, "
             f"{n_windows_c} windows")
    batch = min(8, len(event_list))
    probs = classify_regions_events(  # warmup
        params, event_list[:batch], ref_channels[:batch],
        descriptor_list[:batch], region_sizes[:batch], device=device)
    float(probs.sum())
    with StageTimer(f"C: FUSED EVENT DISPATCH ({batch} regions/dispatch)",
                    unit="windows") as timer:
        checksum = 0.0
        for i in range(0, len(event_list) - batch + 1, batch):
            probs = classify_regions_events(
                params, event_list[i:i + batch],
                ref_channels[i:i + batch], descriptor_list[i:i + batch],
                region_sizes[i:i + batch], device=device)
            checksum += float(probs.sum())  # host barrier
        timer.add(sum(len(d.base_index)
                      for d in descriptor_list[:len(event_list)
                                               // batch * batch]))
    stages["c_dispatch"] = _stage(timer)
    log_line(f"EVENTS PER WINDOW: {k_events / max(1, n_windows_c):,.0f}")
    return {"genome_mb": genome_mb, "threads": threads,
            "device": str(device), "windows": len(windows),
            "b_vs_a_argmax_agree": agree,
            "b_windows": len(device_predictions), "c_regions": len(event_list),
            "c_events": k_events, "c_windows": n_windows_c,
            "stages": stages}


def bench_consensus(num_devices: int = 1, batch: int = 512,
                    dtype: str = "float32", device=None,
                    n_short: int = 4, n_long: int = 16) -> dict:
    """Polish consensus positions/s and chunks/s, over num_devices local
    devices (the `--num_devices` serving path: contiguous row blocks, one
    a device).  N distinct perturbed batches are enqueued back to back and
    a checksum accumulated on the device is fetched once; the marginal
    rate over two lengths is the sustained device rate.  dtype "float32"
    runs consensus_scan (gru_direction_fused on cuda), "static" the int8
    tree through consensus_scan_static (gru_direction_fused_static), as
    the CLIs serve them; the JAX bench's bfloat16 inputs are not served
    by the port's consensus."""
    import torch

    from .device import resolve_device
    from .models.params import params_from_jax
    from .models.polish_gru import init_polish_params
    from .models.quantize import (polish_prepare_static,
                                  polish_quantize_params_static)
    from .parallel.mesh import local_devices
    from .polish.consensus import (SEQ_LENGTH, consensus_scan,
                                   consensus_scan_static)

    device = resolve_device(device)
    devices = local_devices(num_devices, device) or [device]
    if dtype not in ("float32", "static"):
        raise ValueError(f"consensus dtype {dtype!r}: float32 or static")
    static = dtype == "static"
    params = init_polish_params(torch.Generator().manual_seed(0))
    scan_fn = consensus_scan
    if static:
        params = polish_quantize_params_static(params)
        scan_fn = consensus_scan_static
    trees = [params_from_jax(params, d) for d in devices]
    if static:
        trees = [polish_prepare_static(tree) for tree in trees]
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randint(0, 40, size=(batch, SEQ_LENGTH, 10)))
    per = -(-batch // len(devices))
    blocks = [x[i * per:(i + 1) * per].to(device=d, dtype=torch.float32)
              for i, d in enumerate(devices)]

    def run(iters):
        totals = [torch.zeros((), dtype=torch.float32, device=d)
                  for d in devices]
        for i in range(iters):
            for total, tree, block in zip(totals, trees, blocks):
                _, labels, phred = scan_fn(tree, block + i)
                total += phred.sum() + labels.float().sum()
        return sum(float(total) for total in totals)  # the host barrier

    def timed(iters):
        run(iters)  # warmup
        best = float("inf")
        for _ in range(3):
            start = time.perf_counter()
            run(iters)
            best = min(best, time.perf_counter() - start)
        return best

    t_short, t_long = timed(n_short), timed(n_long)
    marginal = (t_long - t_short) / (n_long - n_short)
    if marginal <= 0:  # degenerate timing; fall back to the long-run rate
        marginal = t_long / n_long
    rate = batch * SEQ_LENGTH / marginal
    where = (f"{len(devices)} devices" if len(devices) > 1
             else "single device")
    log_line(f"CONSENSUS ({where}, batch {batch}, {dtype}): "
             f"{rate / 1e6:.1f}M positions/s sustained, "
             f"{batch / marginal:,.0f} chunks/s")
    # the JAX package's _cbench.py line
    print(f"B={batch} dtype={dtype}: {rate / 1e6:.1f} M positions/s "
          f"({marginal * 1e3:.2f} ms/batch)", flush=True)
    return {"devices": [str(d) for d in devices], "batch": batch,
            "dtype": dtype, "batch_ms": marginal * 1e3,
            "positions_per_s": rate, "chunks_per_s": batch / marginal}


def bench_polish_images(genome_kb: float = 500, error_model: str = "ont",
                        repeats: int = 2, workdir: str | None = None) -> dict:
    """Polish make_images throughput (1 kb windows @ ~40x, realignment on),
    one core."""
    from .io.bam import BamReader
    from .io.bam_writer import write_bam, write_fasta
    from .io.fasta import FastaReader
    from .polish.pipeline import build_polish_intervals, summarize_interval
    from .utils.simulate import random_reference, simulate_reads

    length = int(genome_kb * 1000)
    tmp = workdir or tempfile.mkdtemp(prefix="pepper_polishbench_")
    os.makedirs(tmp, exist_ok=True)
    ref = random_reference(length, seed=9)
    records = simulate_reads(ref, [[]], read_len=5000, stride=125,
                             error_model=error_model)
    bam = os.path.join(tmp, "r.bam")
    fasta = os.path.join(tmp, "d.fa")
    write_bam(bam, [("d", length)], records)
    write_fasta(fasta, {"d": ref})
    aligned = sum(len(r.seq) for r in records)
    log_line(f"POLISH IMAGES: {genome_kb} kb draft @ ~40x "
             f"({aligned:,} aligned bases, {error_model})")
    bam_handler = BamReader(bam)
    fasta_handler = FastaReader(fasta)
    intervals = build_polish_intervals([("d", None)], fasta_handler)
    best = float("inf")
    n_images = 0
    for _ in range(repeats):
        start = time.perf_counter()
        n_images = 0
        for contig, lo, hi in intervals:
            images, _, _, _ = summarize_interval(bam_handler, fasta_handler,
                                                 contig, lo, hi)
            n_images += len(images)
        best = min(best, time.perf_counter() - start)
    log_line(f"MAKE_IMAGES: {best:.2f} s "
             f"({aligned / best / 1e6:.2f}M aligned b/s/core), "
             f"{n_images} images")
    result = {"genome_kb": genome_kb, "error_model": error_model,
              "aligned_bases": aligned, "seconds": best,
              "aligned_per_s_core": aligned / best, "images": n_images,
              "images_per_s_core": n_images / best}
    import ctypes

    from .io.native import get_lib

    attempts = ctypes.c_longlong()
    hits = ctypes.c_longlong()
    get_lib().pepper_band_stats(ctypes.byref(attempts), ctypes.byref(hits))
    if attempts.value:
        log_line(f"BANDED REALIGN: {hits.value}/{attempts.value} "
                 "certified in-band")
        result["band_certified"] = [hits.value, attempts.value]
    return result


def bench_windows(genome_mb: float = 3.0, error_model: str = "ont",
                  repeats: int = 2, workdir: str | None = None) -> dict:
    """Single-core window-generation bench under a realistic error model:
    a diploid SNP genome at ~36x with ONT-like errors, timing (a) the BAM
    fetch+decode alone and (b) full create_region_summary (fetch + native
    pileup walk + window emission), one thread."""
    from .io.bam import BamReader
    from .io.fasta import FastaReader
    from .options import PepperOptions
    from .pipeline.call_variant import generate_windows
    from .pipeline.regions import build_intervals
    from .presets import set_parameters

    length = int(genome_mb * 1_000_000)
    tmp = workdir or tempfile.mkdtemp(prefix="pepper_winbench_")
    log_line(f"SIMULATING {genome_mb} Mb GENOME @ ~36x, "
             f"error_model={error_model}")
    bam, fasta, records, _ = _snp_scene(tmp, length, seed=3,
                                        error_model=error_model)
    aligned_bases = sum(len(r.seq) for r in records)
    log_line(f"READS: {len(records)}  ALIGNED BASES: {aligned_bases:,}")

    options = set_parameters(PepperOptions(
        bam=bam, fasta=fasta, ont_r9_guppy5_sup=True,
        sub_command="call_variant", region="chrB", threads=1,
        output_dir=tmp))
    fasta_handler = FastaReader(fasta)
    intervals, _ = build_intervals([("chrB", None)], fasta_handler,
                                   options.region_size)

    # (a) BAM fetch + decode alone
    best_fetch = float("inf")
    for _ in range(repeats):
        reader = BamReader(bam)
        start = time.perf_counter()
        total = 0
        for contig, lo, hi in intervals:
            batch = reader.get_reads(contig, max(0, lo - 100), hi + 100,
                                     False, options.min_mapq,
                                     options.min_snp_baseq)
            total += int(batch.seq_offsets[-1])
        best_fetch = min(best_fetch, time.perf_counter() - start)
    log_line(f"BAM FETCH: {best_fetch:.2f} s "
             f"({aligned_bases / best_fetch / 1e6:.1f}M aligned b/s)")

    # (b) full window generation, one thread
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        windows = generate_windows(options, intervals, None, 1)
        best = min(best, time.perf_counter() - start)
    log_line(f"WINDOW GENERATION (1 thread): {best:.2f} s "
             f"({aligned_bases / best / 1e6:.1f}M aligned b/s/core), "
             f"{len(windows)} windows")
    return {"genome_mb": genome_mb, "error_model": error_model,
            "aligned_bases": aligned_bases, "fetch_seconds": best_fetch,
            "fetch_aligned_per_s": aligned_bases / best_fetch,
            "seconds": best, "aligned_per_s_core": aligned_bases / best,
            "windows": len(windows), "windows_per_s_core": len(windows) / best}


def main(argv=None) -> dict:
    from .device import pop_device_arg

    argv, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    mode = argv[0] if argv else None
    rest = argv[1:] if mode in ("consensus", "vcf", "polish", "windows",
                                "device") else argv

    def arg(i, kind, default):
        return kind(rest[i]) if len(rest) > i else default

    cores = os.cpu_count() or 4
    if mode == "consensus":
        result = bench_consensus(arg(0, int, 1), arg(1, int, 512),
                                 arg(2, str, "float32"), device=device)
    elif mode == "vcf":
        result = bench_vcf_only(arg(0, int, 500_000), arg(1, int, cores))
    elif mode == "polish":
        result = bench_polish_images(arg(0, float, 500), arg(1, str, "ont"),
                                     arg(2, int, 2))
    elif mode == "windows":
        result = bench_windows(arg(0, float, 3.0), arg(1, str, "ont"),
                               arg(2, int, 2))
    elif mode == "device":
        result = bench_device(arg(0, float, 5.0), arg(1, int, cores),
                              device=device)
    else:
        result = main_stages(arg(0, float, 1.0), arg(1, int, cores),
                             device=device)
    log_line(f"KERNEL LAUNCHES: {kernel_launches()}")
    return result

if __name__ == "__main__":
    main()
