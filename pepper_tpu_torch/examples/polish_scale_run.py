"""Mb-scale polish acceptance run: simulate a draft assembly with
realistic scattered errors (~3/kb), ONT-error reads off the TRUE sequence,
train the consensus GRU on a small scene, polish the full draft through
the production pipeline, and report identity/QV before and after plus
wall time.  The port of the JAX package's examples/polish_scale_run.py;
training takes its chunks in memory (polish/pipeline.py
polish_train_arrays, make_polish_train_images' chunks in its order).

Matches the reference's polish contract — consensus quality through the
full images -> consensus -> stitch pipeline
(pepper/modules/python/polish.py:91-117, models/predict.py:83-97).

  python -m pepper_tpu_torch.examples.polish_scale_run [test_mb] [threads] \
      [error_model] [quantized] [--device cpu]

error_model: "ont" (default) or "ont_str"; quantized: "static" serves the
consensus through the int8 path (--quantized on the CLI).
"""

from __future__ import annotations

import math
import os
import re
import sys
import tempfile
import time

import numpy as np

from ..device import pop_device_arg, resolve_device
from ..io.bam_writer import BamRecord, write_bam, write_fasta
from ..utils.profiling import StageTimer, kernel_launches, log_line
from ..utils.simulate import (apply_variants, random_reference,
                              read_from_haplotype, simulate_reads)


def build_polish_scene(base, name, length, seed, error_model="ont",
                       error_every=300, read_len=5000, stride=125):
    """Draft with scattered errors (~1/error_every bp: SNP/INS/DEL mix);
    ONT-error reads simulated from the TRUE sequence; truth reads = the
    true sequence aligned to the draft in 100 kb pieces."""
    rng = np.random.RandomState(seed)
    draft = random_reference(length, seed=seed)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}
    variants = []
    for pos in range(300, length - 300, error_every):
        kind = rng.randint(3)
        p = pos + int(rng.randint(0, min(100, error_every // 3)))
        if kind == 0:
            variants.append((p, draft[p], alt[draft[p]]))
        elif kind == 1:
            insert = "".join("ACGT"[i]
                             for i in rng.randint(0, 4,
                                                  size=rng.randint(1, 3)))
            variants.append((p, draft[p], draft[p] + insert))
        else:
            del_len = int(rng.randint(1, 3))
            variants.append((p, draft[p:p + del_len + 1], draft[p]))
    true_segments = apply_variants(draft, variants)
    true_seq = "".join(alt_seq for _, _, alt_seq in true_segments)

    reads = simulate_reads(draft, [variants, variants], read_len=read_len,
                           stride=stride, name_prefix=name,
                           error_model=error_model)
    # truth reads: exact true-vs-draft alignments in 100 kb pieces (the
    # reference's truth-assembly-to-draft alignment role)
    seg_positions = [s[0] for s in true_segments]
    truth_records = []
    piece = 100_000
    for start in range(0, length - 1000, piece - 2000):
        span = min(piece, length - start)
        seq, cigar = read_from_haplotype(draft, true_segments, start, span,
                                         seg_positions)
        truth_records.append(BamRecord(
            f"truth_{name}_{start}", 0, start, 60, cigar, seq,
            [60] * len(seq)))

    bam = os.path.join(base, f"{name}_reads.bam")
    truth_bam = os.path.join(base, f"{name}_truth.bam")
    fasta = os.path.join(base, f"{name}_draft.fa")
    write_bam(bam, [("ctg", length)], reads)
    write_bam(truth_bam, [("ctg", length)], truth_records)
    write_fasta(fasta, {"ctg": draft})
    return dict(bam=bam, truth_bam=truth_bam, fasta=fasta, draft=draft,
                truth=true_seq)


def chunked_error_count(truth: str, other: str, chunk=2000, slack=250):
    """Alignment-anchored error count of `other` vs `truth` at Mb scale:
    align consecutive truth chunks against a sliding window of `other`
    with the native SW engine, count X/I/D bases, and advance both
    cursors from the alignment footprint (drift-tolerant anchoring)."""
    from ..io.align import Aligner

    aligner = Aligner(4, 6, 8, 2)  # reference scoring (aligner.h:22-28)
    errors = 0
    aligned_bases = 0
    t_cur = 0
    o_cur = 0
    while t_cur + 200 < len(truth):
        t_chunk = truth[t_cur:t_cur + chunk]
        o_lo = max(0, o_cur - slack)
        o_chunk = other[o_lo:o_cur + chunk + slack]
        if not o_chunk:
            errors += len(truth) - t_cur
            aligned_bases += len(truth) - t_cur
            break
        aligner.set_reference_sequence(o_chunk)
        result = aligner.align(t_chunk)
        if result.best_score <= 0:
            errors += len(t_chunk)
            aligned_bases += len(t_chunk)
            t_cur += len(t_chunk)
            o_cur += len(t_chunk)
            continue
        ops = re.findall(r"(\d+)([MIDNSHP=X])", result.cigar_string)
        q_span = 0
        r_span = 0
        chunk_err = 0
        for count, op in ops:
            count = int(count)
            if op in ("=", "M"):
                q_span += count
                r_span += count
            elif op == "X":
                q_span += count
                r_span += count
                chunk_err += count
            elif op in ("I", "S"):
                q_span += count
                if op == "I":
                    chunk_err += count
            elif op == "D":
                r_span += count
                chunk_err += count
        # unaligned query head/tail count as errors (clipped truth bases)
        chunk_err += int(result.query_begin) + (len(t_chunk) - 1
                                                - int(result.query_end))
        errors += chunk_err
        aligned_bases += len(t_chunk)
        t_cur += len(t_chunk)
        o_cur = o_lo + int(result.reference_end) + 1
    return errors, aligned_bases


def qv(errors: int, total: int) -> float:
    rate = max(errors, 0.5) / max(1, total)  # 0.5-error floor caps QV
    return -10.0 * math.log10(rate)


def run(test_mb=10.0, threads=None, error_model="ont", quantized=False,
        device=None, train_mb=1.0, epochs=4, base=None):
    """Train on a train_mb scene (the JAX run's 1 Mb), polish a test_mb
    draft.  Returns the draft's and the polished sequence's (errors,
    bases, identity, QV), the polish wall seconds and the run's
    directory."""
    from ..models.checkpoint import load_params
    from ..options import PepperOptions
    from ..polish.pipeline import polish, polish_train_arrays
    from ..polish.train import train_polish_on_arrays

    device = resolve_device(device)
    threads = threads or os.cpu_count() or 4
    base = base or tempfile.mkdtemp(prefix="pepper_polish_scale_")
    os.makedirs(base, exist_ok=True)
    with StageTimer(f"SIMULATE TRAIN SCENE ({train_mb} Mb draft, "
                    "~3 err/kb)"):
        train = build_polish_scene(base, "train", int(train_mb * 1_000_000),
                                   seed=5, error_model=error_model)
    with StageTimer(f"SIMULATE TEST SCENE ({test_mb} Mb draft)"):
        test = build_polish_scene(base, "test",
                                  int(test_mb * 1_000_000), seed=9,
                                  error_model=error_model)

    options = PepperOptions(bam=train["bam"], fasta=train["fasta"],
                            threads=threads)
    with StageTimer("POLISH TRAIN IMAGES", unit="chunks") as timer:
        images, labels = polish_train_arrays(options, train["truth_bam"])
        timer.add(len(images))
    with StageTimer("TBPTT TRAINING", unit="chunks") as timer:
        model_path = train_polish_on_arrays(
            PepperOptions(), images, labels,
            os.path.join(base, "polish_run"), epochs=epochs,
            learning_rate=1e-3, batch_size=64, holdout_fraction=0.1,
            device=device)
        timer.add(epochs * len(images))
    params, _ = load_params(model_path)

    polish_options = PepperOptions(
        bam=test["bam"], fasta=test["fasta"],
        output_dir=os.path.join(base, "polish_out"), threads=threads,
        batch_size=128)
    polish_options.quantized = quantized
    polish_options.quantize_mode = "static"
    start = time.perf_counter()
    with StageTimer(f"POLISH ({test_mb} Mb, production pipeline)"):
        fasta_path = polish(polish_options, params=params, device=device)
    wall = time.perf_counter() - start
    with open(fasta_path) as f:
        lines = f.read().strip().split("\n")
    polished = "".join(line for line in lines if not line.startswith(">"))

    with StageTimer("SCORING (chunk-anchored alignment)"):
        draft_err, draft_n = chunked_error_count(test["truth"],
                                                 test["draft"])
        pol_err, pol_n = chunked_error_count(test["truth"], polished)
    log_line(f"DRAFT:    {draft_err:,} errors / {draft_n:,} bases "
             f"(identity {1 - draft_err / draft_n:.6f}, "
             f"QV {qv(draft_err, draft_n):.1f})")
    log_line(f"POLISHED: {pol_err:,} errors / {pol_n:,} bases "
             f"(identity {1 - pol_err / pol_n:.6f}, "
             f"QV {qv(pol_err, pol_n):.1f})")
    log_line(f"POLISH WALL: {wall:.1f} s "
             f"({'static-int8' if quantized else 'float'} consensus, "
             f"{threads} threads)")
    log_line(f"KERNEL LAUNCHES: {kernel_launches()}")
    log_line(f"OUTPUT: {base}")

    def score(errors, n):
        return {"errors": errors, "bases": n, "identity": 1 - errors / n,
                "qv": qv(errors, n)}

    return {"draft": score(draft_err, draft_n),
            "polished": score(pol_err, pol_n), "polish_wall_s": wall,
            "train_chunks": len(images), "base": base}


def main(argv=None):
    argv, device = pop_device_arg(sys.argv[1:] if argv is None else argv)
    test_mb = float(argv[0]) if len(argv) > 0 else 10.0
    threads = int(argv[1]) if len(argv) > 1 else (os.cpu_count() or 4)
    error_model = argv[2] if len(argv) > 2 else "ont"
    quantized = len(argv) > 3 and argv[3] == "static"
    return run(test_mb, threads, error_model, quantized, device=device)


if __name__ == "__main__":
    main()
