"""Assembly polishing: images -> consensus -> stitch (reference
pepper/modules/python/polish.py:91-117), the port of the JAX package's
polish/pipeline.py.

The JAX package's `polish` passes images and predictions between its three
stages through HDF5 files (polish/datastore.py).  The port's `polish` runs
them in one process without h5py: the images stay in memory, made by
--threads worker processes that split the intervals as the JAX package's
make_polish_images does, and the predictions go into PredictionStore, an
in-memory store with PolishPredictionStore's writing and ordering rules,
so the stitched FASTA is byte-equal.  The staged subcommands
(make_polish_images, call_consensus, perform_stitch) and polish_sharded
write and read the JAX package's HDF5 files and need h5py.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import time

import numpy as np

from ..device import resolve_device
from ..io.bam import BamReader
from ..io.fasta import FastaReader
from ..options import PolishImageOptions
from ..pipeline.regions import log_info, natural_key
from ..utils import profiling
from .stitch import stitch_contig
from .summary import PolishSummary, chunk_images, chunk_images_train

MIN_IMAGE_OVERLAP = 100  # pepper ImageSizeOptions.MIN_IMAGE_OVERLAP
MAX_READS = PolishImageOptions.MAX_READS_IN_REGION  # 1500


def get_polish_chromosome_list(region, fasta_handler, bam_handler,
                               region_bed=None):
    """Contig selection for polish mode (pepper ImageGenerationUI
    get_chromosome_list: no decoy exclusion — drafts are arbitrary)."""
    if not region and not region_bed:
        common = (set(fasta_handler.get_chromosome_names())
                  & set(bam_handler.get_chromosome_names()))
        if not common:
            raise ValueError("NO COMMON CONTIGS FOUND BETWEEN THE BAM FILE "
                             "AND THE FASTA FILE.")
        return [(contig, None) for contig in sorted(common, key=natural_key)]
    if region_bed:
        chromosome_name_list = []
        with open(region_bed) as fp:
            for line in fp:
                parts = line.rstrip().split("\t")
                if len(parts) >= 3:
                    chromosome_name_list.append(
                        (parts[0], sorted([int(parts[1]), int(parts[2])])))
        return chromosome_name_list
    chromosome_name_list = []
    for name in (n.strip() for n in region.strip().split(",")):
        reg = None
        if ":" in name:
            name, region_str = name.split(":", 1)
            bounds = [int(p) for p in region_str.strip().split("-")]
            reg = bounds
        chromosome_name_list.append((name, reg))
    return chromosome_name_list


def build_polish_intervals(chr_list, fasta_handler, max_size: int = 1000):
    """1kb intervals with 100bp overlap halos
    (pepper ImageGenerationUI.py:269-272)."""
    all_intervals = []
    for chr_name, region in chr_list:
        if not region:
            interval_start = 0
            interval_end = (
                fasta_handler.get_chromosome_sequence_length(chr_name) - 1)
        else:
            interval_start = max(0, region[0])
            interval_end = min(
                region[1],
                fasta_handler.get_chromosome_sequence_length(chr_name) - 1)
        for pos in range(interval_start, interval_end, max_size):
            pos_start = max(interval_start, pos - MIN_IMAGE_OVERLAP)
            pos_end = min(interval_end, pos + max_size + MIN_IMAGE_OVERLAP)
            all_intervals.append((chr_name, pos_start, pos_end))
    return all_intervals


def reservoir_downsample_indices(n_reads: int, total_allowed: int,
                                 seed: int = 2719747673):
    if n_reads <= total_allowed:
        return None
    random = np.random.RandomState(seed)
    sample = []
    for i in range(n_reads):
        if len(sample) < total_allowed:
            sample.append(i)
        else:
            j = random.randint(0, i + 1)
            if j < total_allowed:
                sample[j] = i
    return sample


def summarize_interval(bam_handler, fasta_handler, contig, start, end,
                       downsample_rate: float = 1.0,
                       realignment: bool = True):
    """One interval -> (images, labels, positions, chunk_ids)
    (pepper AlignmentSummarizer.create_summary inference path :295-358;
    the local-realignment stage mirrors reads_to_reference_realignment
    :159-177)."""
    reads = bam_handler.get_reads(contig, max(0, start), end, False, 0, 0)
    if reads.n_reads == 0:
        return [], [], [], []
    sample = reservoir_downsample_indices(reads.n_reads, MAX_READS)
    if sample is not None:
        reads = reads.subset(sample)
    if realignment and reads.n_reads > 0:
        from .realign import ALIGNMENT_SAFE_BASES, realign_reads

        align_end = end + ALIGNMENT_SAFE_BASES
        align_ref = fasta_handler.get_reference_sequence(contig, start,
                                                         align_end)
        reads = realign_reads(reads, align_ref, start, align_end)
    ref_seq = fasta_handler.get_reference_sequence(contig, start, end + 1)
    expected = end - start + 1
    if len(ref_seq) < expected:
        ref_seq += "N" * (expected - len(ref_seq))
    summary = PolishSummary(ref_seq, contig, start, end)
    summary.generate_summary(reads)
    return chunk_images(summary, PolishImageOptions.SEQ_LENGTH,
                        PolishImageOptions.SEQ_OVERLAP)


def get_overlap_between_ranges(range_a, range_b):
    if range_a[1] > range_b[0]:
        return range_b[0], range_a[1]
    return None


def remove_conflicting_regions(regions, region_start, region_end,
                               min_length=1000, length_ratio=2.0,
                               overlap_fraction=0.5):
    """Medaka-style truth-alignment conflict resolution
    (pepper AlignmentSummarizer.py:116-157): overlapping truth regions are
    trimmed, discarded, or arbitrated by length ratio.  regions: mutable
    lists [start, end, payload, is_kept]."""
    import itertools
    from operator import itemgetter

    for reg_a, reg_b in itertools.combinations(regions, 2):
        el1, el2 = sorted((reg_a, reg_b), key=itemgetter(0))
        overlap = get_overlap_between_ranges(el1, el2)
        if overlap is None:
            continue
        ovlp_start, ovlp_end = overlap
        s, l = sorted((reg_a, reg_b),
                      key=lambda element: element[1] - element[0])
        length_ratio_ij = (l[1] - l[0]) / max(1, s[1] - s[0])
        overlap_fraction_ij = (ovlp_end - ovlp_start) / max(1, s[1] - s[0])
        if length_ratio_ij < length_ratio:
            if overlap_fraction_ij >= overlap_fraction:
                s[3] = False
                l[3] = False
            else:
                el1[1] = ovlp_start
                el2[0] = ovlp_end
        else:
            if overlap_fraction_ij >= overlap_fraction:
                s[3] = False
            else:
                el2[0] = ovlp_end

    for al in regions:
        al[0] = max(region_start, al[0])
        al[1] = min(region_end, al[1])
    filtered = [al for al in regions
                if al[3] and al[1] - al[0] >= min_length]
    filtered.sort(key=lambda al: al[0])
    return filtered


def summarize_interval_train(bam_handler, truth_bam_handler, fasta_handler,
                             contig, start, end,
                             downsample_rate: float = 1.0,
                             realignment: bool = True,
                             min_truth_length: int = 1000):
    """Train-mode polish summaries: truth reads define confident regions
    (conflict-filtered), labels projected from the realigned truth read
    (pepper AlignmentSummarizer.create_summary train branch :187-294)."""
    from ..options import TruthFilterOptions
    from .realign import ALIGNMENT_SAFE_BASES, realign_reads

    truth_reads = truth_bam_handler.get_reads(
        contig, start, end, TruthFilterOptions.INCLUDE_SUPPLEMENTARY,
        TruthFilterOptions.MIN_MAPQ, TruthFilterOptions.MIN_BASEQ)
    if truth_reads.n_reads == 0:
        return [], [], [], []
    if realignment:
        align_ref = fasta_handler.get_reference_sequence(
            contig, start, end + ALIGNMENT_SAFE_BASES)
        truth_reads = realign_reads(truth_reads, align_ref, start,
                                    end + ALIGNMENT_SAFE_BASES)

    truth_regions = [[int(truth_reads.pos[i]),
                      int(truth_reads.pos_end[i]) - 1, i, True]
                     for i in range(truth_reads.n_reads)]
    truth_regions = remove_conflicting_regions(
        truth_regions, start, end, min_length=min_truth_length)

    all_images, all_labels, all_positions, all_chunk_ids = [], [], [], []
    for region_start, region_end, truth_index, _ in truth_regions:
        ref_start, ref_end = region_start, region_end + 1
        ref_seq = fasta_handler.get_reference_sequence(contig, ref_start,
                                                       ref_end + 1)
        expected = ref_end - ref_start + 1
        if len(ref_seq) < expected:
            ref_seq += "N" * (expected - len(ref_seq))
        reads = bam_handler.get_reads(contig, max(0, region_start),
                                      region_end, False, 0, 0)
        if reads.n_reads == 0:
            continue
        sample = reservoir_downsample_indices(
            reads.n_reads, int(min(MAX_READS,
                                   downsample_rate * reads.n_reads)))
        if sample is not None:
            reads = reads.subset(sample)
        if realignment:
            align_ref = fasta_handler.get_reference_sequence(
                contig, region_start, region_end + ALIGNMENT_SAFE_BASES)
            reads = realign_reads(reads, align_ref, region_start,
                                  region_end + ALIGNMENT_SAFE_BASES)
        summary = PolishSummary(ref_seq, contig, ref_start, ref_end)
        summary.generate_train_summary(reads, truth_reads, truth_index)
        images, labels, positions, chunk_ids = chunk_images_train(
            summary, PolishImageOptions.SEQ_LENGTH,
            PolishImageOptions.SEQ_OVERLAP)
        all_images.extend(images)
        all_labels.extend(labels)
        all_positions.extend(positions)
        all_chunk_ids.extend(chunk_ids)
    return all_images, all_labels, all_positions, all_chunk_ids


def _train_chunks(options, truth_bam: str, min_truth_length: int):
    """Yield every labelled chunk in interval order, as
    PolishImageStore.write_summary takes it: (region, image, label,
    position, index, chunk_id, summary name)."""
    bam_handler = BamReader(options.bam)
    truth_handler = BamReader(truth_bam)
    fasta_handler = FastaReader(options.fasta)
    chr_list = get_polish_chromosome_list(options.region, fasta_handler,
                                          bam_handler, options.region_bed)
    for contig, start, end in build_polish_intervals(chr_list,
                                                     fasta_handler):
        images, labels, positions, chunk_ids = summarize_interval_train(
            bam_handler, truth_handler, fasta_handler, contig, start, end,
            options.downsample_rate,
            realignment=getattr(options, "realignment", True),
            min_truth_length=min_truth_length)
        for i, image in enumerate(images):
            yield ((contig, start, end), image, labels[i],
                   positions[i][:, 0], positions[i][:, 1], chunk_ids[i],
                   f"{contig}_{start}_{end}_{chunk_ids[i]}_{i}")


def make_polish_train_images(options, truth_bam: str, output_dir: str,
                             min_truth_length: int = 1000):
    """Labeled polish images for training (truth-read supervision), one
    HDF5 file in the JAX package's layout (needs h5py)."""
    from .datastore import PolishImageStore

    os.makedirs(output_dir, exist_ok=True)
    timestr = time.strftime("%m%d%Y_%H%M%S")
    file_name = os.path.join(output_dir,
                             f"pepper_train_images_{timestr}.hdf")
    total = 0
    with PolishImageStore(file_name, "w") as store:
        for chunk in _train_chunks(options, truth_bam, min_truth_length):
            store.write_summary(*chunk)
            total += 1
    log_info(f"FINISHED TRAIN IMAGE GENERATION: {total} CHUNKS")
    return file_name


def polish_train_arrays(options, truth_bam: str,
                        min_truth_length: int = 1000):
    """make_polish_train_images' chunks in memory, with no HDF5 store:
    (images float32 (N, 1000, 10), labels int32 (N, 1000)) in the order
    train_polish_model reads its file back (polish/train.py
    load_polish_images): each name once, the first written, sorted by name
    as HDF5 lists a group's members."""
    chunks = {}
    for _, image, label, *_, name in _train_chunks(options, truth_bam,
                                                   min_truth_length):
        chunks.setdefault(name, (np.asarray(image, np.uint8),
                                 np.asarray(label, np.uint8)))
    if not chunks:
        raise ValueError("no labelled polish chunks in the given regions")
    names = sorted(chunks)
    log_info(f"FINISHED TRAIN IMAGE GENERATION: {len(names)} CHUNKS")
    return (np.stack([chunks[n][0] for n in names]).astype(np.float32),
            np.stack([chunks[n][1] for n in names]).astype(np.int32))


class PredictionStore:
    """In-memory counterpart of the JAX package's PolishPredictionStore
    (polish/datastore.py:66-130), with its rules: the first write of a
    chunk name wins; prefixes ("contig-start-end") and chunk ids are
    listed sorted as strings, the reference's quirk (Stitch.py:50 sorts
    HDF5 keys), which decides the override order when overlapping chunks
    disagree and chunk ids reach 10; bases and phred (clipped to 0..255)
    are stored as uint8."""

    def __init__(self):
        self._contigs: dict = {}
        self._names: set = set()

    def write_prediction(self, contig, contig_start, contig_end, chunk_id,
                         position, index, predicted_bases, phred_score):
        prefix = f"{contig}-{contig_start}-{contig_end}"
        name = f"{contig}{prefix}{chunk_id}"
        groups = self._contigs.setdefault(contig, {})
        if prefix not in groups:
            groups[prefix] = (int(contig_start), int(contig_end), {})
        if name in self._names:
            return
        self._names.add(name)
        chunks = groups[prefix][2]
        chunks.setdefault(str(chunk_id), (
            np.asarray(position, np.int64), np.asarray(index, np.int64),
            np.asarray(predicted_bases, np.uint8),
            np.asarray(np.clip(phred_score, 0, 255), np.uint8)))

    def contigs(self):
        return sorted(self._contigs)

    def chunk_groups(self, contig):
        """Yields (prefix, contig_start, contig_end, chunk_records) where
        chunk_records are (region_start, positions (L, 2), labels)."""
        groups = self._contigs[contig]
        for prefix in sorted(groups):
            contig_start, contig_end, chunks = groups[prefix]
            records = [(contig_start,
                        np.stack([chunks[key][0], chunks[key][1]], axis=1),
                        chunks[key][2])
                       for key in sorted(chunks)]
            yield prefix, contig_start, contig_end, records


_worker_handles: dict = {}


def _image_worker(args):
    """One worker process: its share of the intervals (i % n_workers ==
    process_id) -> image records (name, contig, start, end, chunk_id,
    image, position, index), each name once, sorted by name as the JAX
    package's HDF5 image file lists them.  Host code only: it must never
    touch torch.cuda."""
    options, intervals, process_id, n_workers = args
    key = (os.getpid(), options.bam, options.fasta)
    if key not in _worker_handles:
        _worker_handles.clear()      # drop handles inherited over fork
        _worker_handles[key] = (BamReader(options.bam),
                                FastaReader(options.fasta))
    bam_handler, fasta_handler = _worker_handles[key]
    records = {}
    for i, (contig, start, end) in enumerate(intervals):
        if i % n_workers != process_id:
            continue
        images, _, positions, chunk_ids = summarize_interval(
            bam_handler, fasta_handler, contig, start, end,
            options.downsample_rate,
            realignment=getattr(options, "realignment", True))
        for image, pos, chunk_id in zip(images, positions, chunk_ids):
            name = f"{contig}_{start}_{end}_{chunk_id}"
            records.setdefault(name, (contig, start, end, chunk_id, image,
                                      pos[:, 0], pos[:, 1]))
    return [records[name] for name in sorted(records)]


def polish_image_shares(options, intervals):
    """Image records of every interval, one list per worker process, the
    lists in the order the JAX package's call_consensus reads its image
    files (sorted by file name, so worker 10 before worker 2)."""
    n_workers = max(1, min(getattr(options, "threads", 1), len(intervals)))
    tasks = [(options, intervals, process_id, n_workers)
             for process_id in range(n_workers)]
    if n_workers == 1:
        shares = [_image_worker(tasks[0])]
    else:
        # fork: the workers run host code only and start without a fresh
        # torch import
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=n_workers,
                mp_context=multiprocessing.get_context("fork")) as pool:
            shares = list(pool.map(_image_worker, tasks))
    # the files are pepper_images_thread_<id>_<time>.hdf
    order = sorted(range(n_workers), key=lambda process_id: f"{process_id}_")
    return [shares[process_id] for process_id in order if shares[process_id]]


def _quantize_mode(options):
    return (getattr(options, "quantize_mode", None)
            if getattr(options, "quantized", False) else None)


def consensus_into(options, shares, params, store, device, devices=None,
                   quantize_mode=None):
    """Each share's image records -> labels and phred -> the store (the
    in-memory PredictionStore or an HDF5 PolishPredictionStore), one
    consensus_predict call a share as the JAX package's call_consensus
    makes one a file."""
    for records in shares:
        image_stack = np.stack([record[4] for record in records])
        if getattr(options, "dry", False):
            from .consensus import dry_consensus_labels

            labels, phred = dry_consensus_labels(image_stack)
        else:
            from .consensus import consensus_predict

            labels, phred = consensus_predict(
                params, image_stack, batch_size=options.batch_size,
                quantize_mode=quantize_mode, device=device, devices=devices)
        for i, (contig, start, end, chunk_id, _, position, index) in \
                enumerate(records):
            store.write_prediction(contig, start, end, chunk_id, position,
                                   index, labels[i], np.clip(phred[i], 0,
                                                             255))


def stitch(store, output_path: str):
    """Predictions -> polished consensus FASTA (perform_stitch.py:44-84)."""
    fasta_path = output_path + "_pepper_polished.fa"
    os.makedirs(os.path.dirname(os.path.abspath(fasta_path)), exist_ok=True)
    with open(fasta_path, "w") as fasta_out:
        for contig in sorted(store.contigs(), key=natural_key):
            log_info(f"PROCESSING CONTIG: {contig}")
            groups = [(c_start, c_end, records) for _, c_start, c_end, records
                      in store.chunk_groups(contig)]
            sequence = stitch_contig(groups)
            log_info(f"FINISHED PROCESSING {contig}, POLISHED SEQUENCE "
                     f"LENGTH: {len(sequence)}.")
            if sequence:
                fasta_out.write(f">{contig}\n{sequence}\n")
    return fasta_path


def _consensus_devices(options, device, devices=None):
    """The devices the consensus runs data parallel over, or None (one
    device): `devices` where given, else --num_devices resolved against
    `device`'s local count, as call_variant resolves it.  Dry runs never
    touch a device."""
    if getattr(options, "dry", False):
        return None
    if devices is None:
        from ..parallel.mesh import local_devices

        devices = local_devices(getattr(options, "num_devices", 1), device)
    return devices if devices and len(devices) > 1 else None


def polish(options, params, device=None, devices=None):
    """Full polish pipeline (polish.py:91-117) in one process: images,
    consensus on `device` (cuda unless given) or data parallel over
    --num_devices local GPUs (or the list `devices`), stitch.  params: the
    float polish tree (numpy arrays or tensors); None with options.dry.
    Returns the FASTA path,
    options.output_dir/consensus_pepper_polished.fa."""
    device = resolve_device(device if devices is None else devices[0])
    devices = _consensus_devices(options, device, devices)
    output_dir = options.output_dir
    os.makedirs(output_dir, exist_ok=True)
    log_info(f"RUN-ID: {time.strftime('%m%d%Y_%H%M%S')}")
    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)
    chr_list = get_polish_chromosome_list(options.region, fasta_handler,
                                          bam_handler, options.region_bed)
    intervals = build_polish_intervals(chr_list, fasta_handler)
    log_info(f"TOTAL CONTIGS: {len(chr_list)} TOTAL INTERVALS: "
             f"{len(intervals)}")
    log_info("STEP 1: GENERATING IMAGES")
    shares = polish_image_shares(options, intervals)
    log_info("STEP 2: RUNNING INFERENCE")
    store = PredictionStore()
    rows_before = profiling.padded_rows()["consensus"]
    consensus_into(options, shares, params, store, device, devices,
                   _quantize_mode(options))
    log_info("FINISHED INFERENCE: "
             + profiling.padded_line("consensus", rows_before))
    log_info("STEP 3: RUNNING STITCH")
    return stitch(store, os.path.join(output_dir, "consensus"))


# ------------------------------------------------ the staged HDF5 flow


def _polish_image_worker(args):
    """One worker process: its interval share -> one HDF5 file (the
    reference's image_generator, pepper ImageGenerationUI.py:192-233).
    Host code only."""
    from .datastore import PolishImageStore

    options, intervals, output_dir, process_id, n_workers, timestr = args
    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)
    file_name = os.path.join(
        output_dir, f"pepper_images_thread_{process_id}_{timestr}.hdf")
    my_intervals = [interval for i, interval in enumerate(intervals)
                    if i % n_workers == process_id]
    written = 0
    with PolishImageStore(file_name, "w") as store:
        for contig, start, end in my_intervals:
            images, labels, positions, chunk_ids = summarize_interval(
                bam_handler, fasta_handler, contig, start, end,
                options.downsample_rate,
                realignment=getattr(options, "realignment", True))
            region = (contig, start, end)
            for i, image in enumerate(images):
                name = f"{contig}_{start}_{end}_{chunk_ids[i]}"
                store.write_summary(region, image, labels[i],
                                    positions[i][:, 0], positions[i][:, 1],
                                    chunk_ids[i], name)
                written += 1
    if written == 0:
        os.remove(file_name)
        return None
    return file_name


def make_polish_images(options, output_dir: str):
    """The polish make_images stage: one HDF5 image file per worker
    process, the JAX package's layout (polish/datastore.py)."""
    os.makedirs(output_dir, exist_ok=True)
    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)
    chr_list = get_polish_chromosome_list(options.region, fasta_handler,
                                          bam_handler, options.region_bed)
    intervals = build_polish_intervals(chr_list, fasta_handler)
    log_info(f"TOTAL CONTIGS: {len(chr_list)} TOTAL INTERVALS: "
             f"{len(intervals)}")
    timestr = time.strftime("%m%d%Y_%H%M%S")
    n_workers = max(1, min(getattr(options, "threads", 1), len(intervals)))
    tasks = [(options, intervals, output_dir, process_id, n_workers,
              timestr) for process_id in range(n_workers)]
    if n_workers == 1:
        files = [_polish_image_worker(tasks[0])]
    else:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=n_workers,
                mp_context=multiprocessing.get_context("fork")) as pool:
            files = list(pool.map(_polish_image_worker, tasks))
    files = [f for f in files if f]
    log_info("FINISHED IMAGE GENERATION")
    return files[0] if len(files) == 1 else files


def call_consensus(options, image_dir: str, output_dir: str, params,
                   device=None, devices=None):
    """Images HDF5 -> sliding-window GRU predictions HDF5, one
    consensus_predict call an image file (sorted by file name), on
    `device` (cuda unless given) or data parallel as polish runs."""
    from .datastore import PolishImageStore, PolishPredictionStore

    device = resolve_device(device if devices is None else devices[0])
    devices = _consensus_devices(options, device, devices)
    os.makedirs(output_dir, exist_ok=True)
    output_file = os.path.join(output_dir, "pepper_prediction_0.hdf")
    image_files = sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir)
        if f.endswith((".hdf", ".hdf5", ".h5")))
    rows_before = profiling.padded_rows()["consensus"]
    with PolishPredictionStore(output_file, "w") as store:
        for image_file in image_files:
            with PolishImageStore(image_file, "r") as images:
                records = [images.read_summary(name)
                           for name in images.summary_names()]
            if not records:
                continue
            consensus_into(options, [[
                (r["contig"], r["region_start"], r["region_end"],
                 r["chunk_id"], r["image"], r["position"], r["index"])
                for r in records]], params, store, device, devices,
                _quantize_mode(options))
    log_info("FINISHED PREDICTION: "
             + profiling.padded_line("consensus", rows_before))
    return output_file


def perform_stitch(prediction_dir: str, output_path: str):
    """Predictions HDF5 -> polished consensus FASTA
    (perform_stitch.py:44-84)."""
    from .datastore import PolishPredictionStore

    prediction_files = sorted(
        os.path.join(prediction_dir, f) for f in os.listdir(prediction_dir)
        if f.endswith(".hdf"))
    all_contigs = set()
    for prediction_file in prediction_files:
        with PolishPredictionStore(prediction_file, "r") as store:
            all_contigs.update(store.contigs())

    fasta_path = output_path + "_pepper_polished.fa"
    os.makedirs(os.path.dirname(os.path.abspath(fasta_path)), exist_ok=True)
    with open(fasta_path, "w") as fasta_out:
        for contig in sorted(all_contigs, key=natural_key):
            log_info(f"PROCESSING CONTIG: {contig}")
            groups = []
            for prediction_file in prediction_files:
                with PolishPredictionStore(prediction_file, "r") as store:
                    if contig not in store.contigs():
                        continue
                    for _, c_start, c_end, records in store.chunk_groups(
                            contig):
                        groups.append((c_start, c_end, records))
            sequence = stitch_contig(groups)
            log_info(f"FINISHED PROCESSING {contig}, POLISHED SEQUENCE "
                     f"LENGTH: {len(sequence)}.")
            if sequence:
                fasta_out.write(f">{contig}\n{sequence}\n")
    return fasta_path


def polish_sharded(options, params, manifest_dir=None, device=None,
                   devices=None):
    """Multi-process / resumable polish: interval claims + done markers as
    in call_variant_sharded; per-rank consensus predictions in HDF5, rank-0
    stitch.  As the JAX package's polish_sharded, the consensus runs the
    float tree whatever --quantized says (ROADMAP.md, reference notes)."""
    from ..parallel.dist import (RegionManifest, barrier, process_count,
                                 process_index, shard_intervals)
    from .datastore import PolishPredictionStore

    rank, world = process_index(), process_count()
    device = resolve_device(device if devices is None else devices[0])
    devices = _consensus_devices(options, device, devices)
    os.makedirs(options.output_dir, exist_ok=True)
    manifest_dir = manifest_dir or os.path.join(options.output_dir,
                                                "manifest")
    prediction_dir = os.path.join(options.output_dir, "predictions")
    os.makedirs(prediction_dir, exist_ok=True)

    bam_handler = BamReader(options.bam)
    fasta_handler = FastaReader(options.fasta)
    chr_list = get_polish_chromosome_list(options.region, fasta_handler,
                                          bam_handler, options.region_bed)
    intervals = build_polish_intervals(chr_list, fasta_handler)

    manifest = RegionManifest(manifest_dir)
    if rank == 0:
        manifest.write(intervals)
    barrier("polish-manifest")

    my_intervals = shard_intervals(intervals, rank, world)
    pending = [i for i in my_intervals if not manifest.is_done(i)]
    log_info(f"HOST {rank}/{world}: "
             f"{len(pending)}/{len(my_intervals)} INTERVALS PENDING")

    output_file = os.path.join(prediction_dir,
                               f"pepper_prediction_{rank}.hdf")
    mode = "a" if os.path.exists(output_file) else "w"
    with PolishPredictionStore(output_file, mode) as store:
        for contig, start, end in pending:
            images, _, positions, chunk_ids = summarize_interval(
                bam_handler, fasta_handler, contig, start, end,
                options.downsample_rate,
                realignment=getattr(options, "realignment", True))
            if images:
                consensus_into(options, [[
                    (contig, start, end, chunk_id, image, pos[:, 0],
                     pos[:, 1])
                    for image, pos, chunk_id in zip(images, positions,
                                                    chunk_ids)]],
                    params, store, device, devices)
            manifest.mark_done((contig, start, end))

    barrier("polish-predictions")
    if rank == 0:
        return perform_stitch(prediction_dir,
                              os.path.join(options.output_dir, "consensus"))
    return None
