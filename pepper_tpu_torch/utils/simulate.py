"""Haplotype-aware read simulator for end-to-end tests, benches and the
simulated example runs: builds BamRecords with correct CIGARs from a
reference plus a variant list.  A copy of the JAX package's
tests/simulate.py; only the imports differ (the port's io/bam_writer.py),
and the same seeds give the same references, reads and files."""

from __future__ import annotations

import numpy as np

from ..io.bam_writer import BamRecord


def apply_variants(ref: str, variants):
    """variants: list of (pos, ref_allele, alt_allele) 0-based, VCF-style
    (indels anchored).  Returns segment list [(ref_pos, ref_len, alt_seq)]
    covering the genome in order."""
    segments = []
    cursor = 0
    for pos, ref_allele, alt_allele in sorted(variants):
        if cursor < pos:
            segments.append((cursor, pos - cursor, ref[cursor:pos]))
        segments.append((pos, len(ref_allele), alt_allele))
        cursor = pos + len(ref_allele)
    if cursor < len(ref):
        segments.append((cursor, len(ref) - cursor, ref[cursor:]))
    return segments


def read_from_haplotype(ref: str, segments, ref_start: int, ref_span: int,
                        seg_positions=None):
    """Extract (seq, cigar) for a read covering reference coordinates
    [ref_start, ref_start+ref_span).  seg_positions: optional precomputed
    [seg[0] for seg in segments] to make the overlap seek O(log n)."""
    import bisect

    ref_end = ref_start + ref_span
    seq_parts = []
    cigar_parts = []

    def add_cigar(op, length):
        if length <= 0:
            return
        if cigar_parts and cigar_parts[-1][0] == op:
            cigar_parts[-1][1] += length
        else:
            cigar_parts.append([op, length])

    if seg_positions is None:
        seg_positions = [s[0] for s in segments]
    # segments are position-sorted; skip straight to the first overlap
    first = max(0, bisect.bisect_right(seg_positions, ref_start) - 1)
    for seg_pos, seg_ref_len, seg_alt in segments[first:]:
        if seg_pos >= ref_end:
            break
        seg_end = seg_pos + seg_ref_len
        if seg_end <= ref_start or seg_pos >= ref_end:
            continue
        if seg_ref_len == len(seg_alt):
            # match segment (possibly SNP): clip to read bounds
            lo = max(seg_pos, ref_start)
            hi = min(seg_end, ref_end)
            seq_parts.append(seg_alt[lo - seg_pos:hi - seg_pos])
            add_cigar("M", hi - lo)
        elif seg_ref_len < len(seg_alt):
            # insertion (anchored: first base matches ref anchor)
            if seg_pos < ref_start or seg_end > ref_end:
                # read boundary cuts the event: emit anchor matches only
                lo = max(seg_pos, ref_start)
                hi = min(seg_end, ref_end)
                seq_parts.append(seg_alt[lo - seg_pos:hi - seg_pos])
                add_cigar("M", hi - lo)
            else:
                seq_parts.append(seg_alt[0])
                add_cigar("M", 1)
                seq_parts.append(seg_alt[1:])
                add_cigar("I", len(seg_alt) - 1)
                add_cigar("M", seg_ref_len - 1)  # 0 for standard insertion
        else:
            # deletion: anchor base + deleted span
            if seg_pos < ref_start or seg_end > ref_end:
                lo = max(seg_pos, ref_start)
                hi = min(seg_end, ref_end)
                if seg_pos >= ref_start:
                    seq_parts.append(seg_alt)
                    add_cigar("M", len(seg_alt))
                    add_cigar("D", hi - (seg_pos + len(seg_alt)))
                else:
                    add_cigar("D", hi - lo)
            else:
                seq_parts.append(seg_alt)
                add_cigar("M", len(seg_alt))
                add_cigar("D", seg_ref_len - len(seg_alt))
    seq = "".join(seq_parts)
    cigar = "".join(f"{length}{op}" for op, length in cigar_parts)
    return seq, cigar


# ---------------------------------------------------------------------------
# ONT-realistic read-error model.
#
# The uniform-substitution model (error_model="uniform") cannot stress the
# pipeline the way real ONT data does: ONT errors are dominated by
# homopolymer length miscounts (indels whose rate grows steeply with run
# length), are strand-biased, and carry quality values correlated with
# error probability.  This is exactly the regime behind the reference's
# published INDEL F1 of 0.77-0.88 vs ~0.99 for SNPs
# (the reference's docs/pipeline_docker/ONT_variant_calling.md:
# 149-154).
# error_model="ont" implements that process.
# ---------------------------------------------------------------------------

ONT_ERROR_DEFAULTS = dict(
    sub_rate=0.012,          # fwd-strand per-base substitution probability
    strand_sub_factor=1.5,   # rev-strand substitution multiplier
    ins_rate=0.004,          # baseline per-base insertion probability
    del_rate=0.008,          # baseline per-base deletion probability
    strand_indel_factor=1.25,  # rev-strand indel multiplier
    hp_alpha=0.55,           # indel rate *= 1 + alpha*(run_len-1)^1.5
    hp_cap=45.0,             # cap on the homopolymer factor
    qual_correct_mean=21.0,  # mean qual of correct bases
    qual_correct_sd=5.0,
    qual_error_mean=7.0,     # mean qual of erroneous bases
    qual_error_sd=2.5,
    qual_hp_penalty=4.0,     # quals drop inside homopolymer runs >= 4
    str_alpha=0.0,           # di/tri tandem-repeat indel scaling (off in
    str_cap=30.0,            # the plain "ont" model; see ONT_STR_PARAMS)
)

# The "ont_str" model: real ONT error also concentrates in di/tri-nt short
# tandem repeats (the context behind the reference's hardest documented
# failure mode, INDEL F1 0.77 at 30x —
# docs/performance_evaluation/Oxford_nanopore_r9_whole_genome.md:40-43):
# indel rates scale with the repeat COPY count the same way homopolymer
# rates scale with run length.
ONT_STR_PARAMS = dict(ONT_ERROR_DEFAULTS, str_alpha=0.45)


def _read_tandem_copies(codes: np.ndarray) -> np.ndarray:
    """Per-base tandem-repeat copy count for unit sizes 2 and 3 (max over
    units; 1.0 outside repeats).  A run of L consecutive positions with
    codes[i] == codes[i-u] spans L+u bases of a repeat with (L+u)/u
    copies; only runs with >= 2 full copies (L >= u) count."""
    n = len(codes)
    copies = np.ones(n, np.float64)
    for unit in (2, 3):
        if n <= 2 * unit:
            continue
        eq = codes[unit:] == codes[:-unit]
        edges = np.flatnonzero(np.diff(
            np.concatenate(([False], eq, [False])).astype(np.int8)))
        starts, ends = edges[::2], edges[1::2]
        lengths = ends - starts
        keep = lengths >= unit  # at least 2 full copies
        if not keep.any():
            continue
        starts, lengths = starts[keep], lengths[keep]
        spans = lengths + unit
        values = (lengths + unit) / unit
        # fully vectorized max-assign over the (possibly overlapping) spans
        total = int(spans.sum())
        offsets = np.concatenate(([0], np.cumsum(spans)[:-1]))
        idx = (np.repeat(starts - offsets, spans) + np.arange(total))
        np.maximum.at(copies, idx, np.repeat(values, spans))
    return copies


def _read_run_lengths(codes: np.ndarray) -> np.ndarray:
    """Per-base homopolymer run length of the read's own sequence."""
    if len(codes) == 0:
        return np.zeros(0, np.int64)
    boundaries = np.flatnonzero(np.diff(codes) != 0) + 1
    starts = np.concatenate([[0], boundaries])
    lengths = np.diff(np.concatenate([starts, [len(codes)]]))
    return np.repeat(lengths, lengths)


def apply_ont_errors(seq, cigar_parts, rng, reverse_strand,
                     params=ONT_ERROR_DEFAULTS):
    """Apply the ONT error process to one read.

    seq: the error-free haplotype read sequence; cigar_parts: [(op, len)]
    vs the reference.  Returns (seq, cigar_parts, quals) with error
    substitutions, run-length-dependent insertions/deletions merged into
    the CIGAR (deletions only consume M bases so reference coordinates
    stay exact), and correlated qualities."""
    n = len(seq)
    if n == 0:
        return seq, cigar_parts, []
    codes = np.frombuffer(seq.encode("latin-1"), np.uint8)
    run_len = _read_run_lengths(codes)
    hp_factor = np.minimum(
        1.0 + params["hp_alpha"] * np.maximum(run_len - 1, 0) ** 1.5,
        params["hp_cap"])
    if params.get("str_alpha", 0.0) > 0.0:
        tandem_copies = _read_tandem_copies(codes)
        str_factor = np.minimum(
            1.0 + params["str_alpha"] *
            np.maximum(tandem_copies - 1, 0) ** 1.5,
            params.get("str_cap", 30.0))
        # max, not product: a homopolymer is the unit-1 repeat — don't
        # double-count the same context
        hp_factor = np.maximum(hp_factor, str_factor)

    strand_sub = params["strand_sub_factor"] if reverse_strand else 1.0
    strand_indel = params["strand_indel_factor"] if reverse_strand else 1.0
    draws = rng.rand(3, n)
    sub_mask = draws[0] < params["sub_rate"] * strand_sub
    ins_mask = draws[1] < np.minimum(
        params["ins_rate"] * strand_indel * hp_factor, 0.45)
    del_mask = draws[2] < np.minimum(
        params["del_rate"] * strand_indel * hp_factor, 0.45)
    # a base is one of: substituted, duplicated (insertion), deleted
    ins_mask &= ~del_mask
    sub_mask &= ~(del_mask | ins_mask)

    # substitutions in place (vectorized): shift to a different base
    if sub_mask.any():
        acgt = np.frombuffer(b"ACGT", np.uint8)
        base_index = np.searchsorted(np.sort(acgt), codes[sub_mask])
        shift = rng.randint(1, 4, size=int(sub_mask.sum()))
        codes = codes.copy()
        codes[sub_mask] = acgt[(base_index + shift) % 4]

    # deletions may only eat M bases (so the CIGAR walk below stays exact);
    # insertions duplicate the current base (ONT over-count)
    quals_correct = np.clip(np.round(
        rng.normal(params["qual_correct_mean"], params["qual_correct_sd"],
                   n)), 2, 50).astype(np.int64)
    quals_correct[run_len >= 4] = np.maximum(
        quals_correct[run_len >= 4] - int(params["qual_hp_penalty"]), 2)
    quals_error = np.clip(np.round(
        rng.normal(params["qual_error_mean"], params["qual_error_sd"],
                   n)), 2, 50).astype(np.int64)
    qual_of = np.where(sub_mask | ins_mask | del_mask, quals_error,
                       quals_correct)

    out_seq = []
    out_quals = []
    out_cigar = []

    def add_op(op, length):
        if length <= 0:
            return
        if out_cigar and out_cigar[-1][0] == op:
            out_cigar[-1][1] += length
        else:
            out_cigar.append([op, length])

    read_pos = 0
    for op, length in cigar_parts:
        if op in ("M", "=", "X"):
            lo, hi = read_pos, read_pos + length
            events = np.flatnonzero(ins_mask[lo:hi] | del_mask[lo:hi]) + lo
            cursor = lo
            for event in events:
                if event > cursor:
                    out_seq.append(codes[cursor:event])
                    out_quals.append(qual_of[cursor:event])
                    add_op("M", int(event - cursor))
                if del_mask[event]:
                    add_op("D", 1)          # base missing from the read
                else:
                    out_seq.append(codes[event:event + 1])
                    out_quals.append(qual_of[event:event + 1])
                    add_op("M", 1)
                    out_seq.append(codes[event:event + 1])
                    out_quals.append(qual_of[event:event + 1])
                    add_op("I", 1)          # duplicated base
                cursor = event + 1
            if hi > cursor:
                out_seq.append(codes[cursor:hi])
                out_quals.append(qual_of[cursor:hi])
                add_op("M", int(hi - cursor))
            read_pos = hi
        elif op == "I":
            out_seq.append(codes[read_pos:read_pos + length])
            out_quals.append(qual_of[read_pos:read_pos + length])
            add_op("I", length)
            read_pos += length
        else:  # D (and N): reference-consuming, no read bases
            add_op(op, length)

    new_codes = (np.concatenate(out_seq) if out_seq
                 else np.zeros(0, np.uint8))
    new_quals = (np.concatenate(out_quals) if out_quals
                 else np.zeros(0, np.int64))
    return (new_codes.tobytes().decode("latin-1"),
            [(op, length) for op, length in out_cigar],
            new_quals.tolist())


def _parse_cigar(cigar: str):
    parts = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            parts.append((ch, int(num)))
            num = ""
    return parts


def simulate_reads(ref: str, haplotypes, read_len=300, stride=50, mapq=60,
                   qual=30, name_prefix="sim", strides=None,
                   error_rate=0.0, error_seed=1234, error_model="uniform",
                   ont_params=ONT_ERROR_DEFAULTS, dropout_regions=None):
    """Tile reads across the genome alternating haplotypes/strands.
    strides: optional per-haplotype stride list (coverage weighting).
    error_model="uniform": per-base substitutions at error_rate with low
    quality (7) at the erroneous bases.  error_model="ont": the
    homopolymer-scaled, strand-biased substitution+indel process with
    correlated qualities (see apply_ont_errors); error_rate is ignored.
    dropout_regions: optional [(start, end, keep_prob)] coverage-dropout
    windows — reads STARTING inside a window survive only with keep_prob
    (models mappability/coverage holes in real data)."""
    records = []
    count = 0
    error_rng = np.random.RandomState(error_seed)
    for hap_index, variants in enumerate(haplotypes):
        segments = apply_variants(ref, variants)
        seg_positions = [s[0] for s in segments]
        hap_stride = strides[hap_index] if strides else stride
        for start in range(0, len(ref) - read_len + 1, hap_stride):
            if dropout_regions:
                dropped = False
                for lo, hi, keep_prob in dropout_regions:
                    if lo <= start < hi:
                        dropped = error_rng.rand() >= keep_prob
                        break
                if dropped:
                    count += 1  # keep strand/hap phase deterministic
                    continue
            seq, cigar = read_from_haplotype(ref, segments, start, read_len,
                                             seg_positions)
            flag = 0x10 if count % 2 else 0
            if error_model == "ont":
                new_seq, cigar_parts, quals = apply_ont_errors(
                    seq, _parse_cigar(cigar), error_rng, bool(flag & 0x10),
                    ont_params)
                seq = new_seq
                cigar = "".join(f"{length}{op}"
                                for op, length in cigar_parts)
            else:
                quals = [qual] * len(seq)
                if error_rate > 0:
                    seq_list = list(seq)
                    n_errors = error_rng.binomial(len(seq), error_rate)
                    for idx in error_rng.randint(0, len(seq),
                                                 size=n_errors):
                        seq_list[idx] = "ACGT"[error_rng.randint(4)]
                        quals[idx] = 7
                    seq = "".join(seq_list)
            records.append(BamRecord(
                name=f"{name_prefix}_{hap_index}_{count}", ref_id=0,
                pos=start, mapq=mapq, cigar=cigar, seq=seq,
                qual=quals, flag=flag,
                hp=(hap_index + 1) if hap_index < 2 else 0))
            count += 1
    records.sort(key=lambda r: r.pos)
    return records


def random_reference(length=2000, seed=11):
    rng = np.random.RandomState(seed)
    return "".join("ACGT"[i] for i in rng.randint(0, 4, size=length))


def write_truth_vcf(path: str, contig: str, contig_len: int, variants):
    """variants: list of (pos, ref, alt, gt_string like '0|1')."""
    lines = [
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        f"##contig=<ID={contig},length={contig_len}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
    ]
    for pos, ref_allele, alt_allele, gt in sorted(variants):
        lines.append(f"{contig}\t{pos + 1}\t.\t{ref_allele}\t{alt_allele}"
                     f"\t60\tPASS\t.\tGT\t{gt}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Mixed-type genomes (SNP + INS + DEL incl. homopolymer-adjacent sites) for
# the trained-model acceptance harnesses. The reference's published contract
# is per-type F1 tables (docs/pipeline_docker/ONT_variant_calling.md:149-154);
# these builders are the synthetic stand-in.
# ---------------------------------------------------------------------------

def reference_with_homopolymers(length, seed, run_every=1500,
                                run_lens=(5, 10)):
    """Random reference with planted homopolymer runs (the hard indel
    context: the decoder switches to its low-complexity gates there).
    Returns (ref, [(run_start, run_len, base), ...])."""
    rng = np.random.RandomState(seed + 7)
    ref = list(random_reference(length, seed=seed))
    runs = []
    step = max(run_every, 300)
    for start in range(700, length - 700, step):
        jitter = int(rng.randint(0, max(1, step // 3)))
        s = start + jitter
        run_len = int(rng.randint(run_lens[0], run_lens[1] + 1))
        if s + run_len >= length - 700:
            continue
        base = "ACGT"[rng.randint(4)]
        ref[s:s + run_len] = base * run_len
        runs.append((s, run_len, base))
    return "".join(ref), runs


def reference_with_repeats(length, seed, run_every=1500, run_lens=(5, 10),
                           str_every=1500, str_units=(2, 3),
                           str_copies=(4, 8)):
    """Homopolymer-planted reference plus interleaved di/tri-nucleotide
    short tandem repeats (the other hard-indel context).  Returns
    (ref, hp_runs, str_runs) with str_runs = [(start, unit_len, copies)]."""
    ref, hp_runs = reference_with_homopolymers(length, seed,
                                               run_every=run_every,
                                               run_lens=run_lens)
    rng = np.random.RandomState(seed + 23)
    ref = list(ref)
    str_runs = []
    step = max(str_every, 300)
    for start in range(700 + step // 2, length - 700, step):
        jitter = int(rng.randint(0, max(1, step // 3)))
        s = start + jitter
        unit_len = int(str_units[rng.randint(len(str_units))])
        copies = int(rng.randint(str_copies[0], str_copies[1] + 1))
        span = unit_len * copies
        if s + span >= length - 700:
            continue
        if any(hs - 40 <= s <= hs + hl + 40 for hs, hl, _ in hp_runs):
            continue
        unit = "".join("ACGT"[k] for k in rng.randint(0, 4, unit_len))
        if len(set(unit)) == 1:  # degenerate unit would be a homopolymer
            other = "ACGT"[("ACGT".index(unit[0]) + 1) % 4]
            unit = unit[:-1] + other
        ref[s:s + span] = unit * copies
        str_runs.append((s, unit_len, copies))
    return "".join(ref), hp_runs, str_runs


def make_mixed_variants(ref, hp_runs, n_variants, n_noise, seed,
                        min_pos=500, spacing=40, max_indel=10,
                        str_runs=()):
    """Truth variants (pos, ref_allele, alt_allele, gt) + noise triples.

    Composition: ~50% SNP / 25% INS / 25% DEL with indel lengths 1..10,
    plus homopolymer-adjacent indels anchored directly before planted runs
    (insertions extend the run base; deletions eat into the run)."""
    length = len(ref)
    rng = np.random.RandomState(seed + 13)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}
    variants = []

    blocked = np.zeros(length, bool)
    for i, (s, run_len, base) in enumerate(hp_runs):
        if s - 1 < min_pos or s + run_len > length - min_pos:
            continue
        blocked[max(0, s - 2 * spacing):s + run_len + 2 * spacing] = True
        if i % 2:
            continue                       # leave half the runs variant-free
        p = s - 1                          # anchor just before the run
        gt = "1|1" if len(variants) % 3 == 0 else "1|0"
        if i % 4 == 0:                     # run-extending insertion
            ins_len = int(rng.randint(1, 5))
            variants.append((p, ref[p], ref[p] + base * ins_len, gt))
        else:                              # deletion into the run
            del_len = int(rng.randint(1, min(max_indel, run_len)))
            variants.append((p, ref[p:p + del_len + 1], ref[p], gt))
    # STR-anchored repeat-unit indels (the classic hard case: +/- one full
    # copy of the repeat unit, anchored just before the run)
    for i, (s, unit_len, copies) in enumerate(str_runs):
        if s - 1 < min_pos or s + unit_len * copies > length - min_pos:
            continue
        blocked[max(0, s - 2 * spacing):
                s + unit_len * copies + 2 * spacing] = True
        if i % 2:
            continue                       # leave half the STRs variant-free
        p = s - 1
        gt = "1|1" if len(variants) % 3 == 0 else "1|0"
        unit = ref[s:s + unit_len]
        if i % 4 == 0:                     # insert one extra unit copy
            variants.append((p, ref[p], ref[p] + unit, gt))
        else:                              # delete the first unit copy
            variants.append((p, ref[p:p + unit_len + 1], ref[p], gt))
    n_hp = len(variants)

    grid = [int(p) for p in np.arange(min_pos, length - min_pos, spacing)
            if not blocked[p]]
    grid = [grid[i] for i in rng.permutation(len(grid))]
    n_general = max(0, n_variants - n_hp)
    if n_general + n_noise > len(grid):
        raise ValueError("genome too small for requested variant count")
    general = sorted(grid[:n_general])
    noise_positions = sorted(grid[n_general:n_general + n_noise])

    for j, p in enumerate(general):
        gt = "1|1" if (n_hp + j) % 3 == 0 else "1|0"
        kind = j % 4
        if kind in (0, 1):                 # SNP
            variants.append((p, ref[p], alt[ref[p]], gt))
        elif kind == 2:                    # insertion, length 1..max_indel
            ins_len = j % max_indel + 1
            ins = "".join("ACGT"[k]
                          for k in rng.randint(0, 4, ins_len))
            variants.append((p, ref[p], ref[p] + ins, gt))
        else:                              # deletion, length 1..max_indel
            del_len = j % max_indel + 1
            variants.append((p, ref[p:p + del_len + 1], ref[p], gt))
    variants.sort()

    noise = []
    for j, p in enumerate(noise_positions):
        kind = j % 4
        if kind in (0, 1):
            noise.append((p, ref[p], alt[ref[p]]))
        elif kind == 2:
            ins_len = j % max_indel + 1
            ins = "".join("ACGT"[k] for k in rng.randint(0, 4, ins_len))
            noise.append((p, ref[p], ref[p] + ins))
        else:
            del_len = j % max_indel + 1
            noise.append((p, ref[p:p + del_len + 1], ref[p]))
    return variants, noise


def build_mixed_genome(base, name, length, n_variants, n_noise, seed,
                       read_len=2000, strides=(160, 160, 550),
                       error_rate=0.03, contig="chrA", run_every=1500,
                       error_model="uniform"):
    """Simulated genome directory (BAM/FASTA/truth VCF/BED) with mixed
    SNP/INS/DEL truth incl. homopolymer-adjacent indels and a low-coverage
    systematic-noise read population, plus sequencing errors
    (error_model="uniform" substitutions, "ont" — see apply_ont_errors —
    or "ont_str": the ONT process extended with di/tri-nt tandem repeats
    carrying repeat-unit truth indels, copy-count-scaled STR errors and
    random coverage-dropout windows)."""
    import os

    from ..io.bam_writer import write_bam, write_fasta

    str_runs = ()
    dropout_regions = None
    read_error_model = error_model
    ont_params = ONT_ERROR_DEFAULTS
    if error_model == "ont_str":
        ref, hp_runs, str_runs = reference_with_repeats(
            length, seed, run_every=run_every, str_every=run_every)
        read_error_model = "ont"
        ont_params = ONT_STR_PARAMS
        # a ~2 kb low-coverage hole every ~1.5 Mb (keep 25% of reads)
        drop_rng = np.random.RandomState(seed + 41)
        dropout_regions = []
        for center in range(750_000, max(0, length - 5_000), 1_500_000):
            start = center + int(drop_rng.randint(0, 200_000))
            width = int(drop_rng.randint(1_000, 3_000))
            if start + width < length:
                dropout_regions.append((start, start + width, 0.25))
    else:
        ref, hp_runs = reference_with_homopolymers(length, seed,
                                                   run_every=run_every)
    variants, noise = make_mixed_variants(ref, hp_runs, n_variants, n_noise,
                                          seed, str_runs=str_runs)
    hap1 = [(p, r, a) for p, r, a, g in variants]
    hap2 = [(p, r, a) for p, r, a, g in variants if g == "1|1"]
    records = simulate_reads(ref, [hap1, hap2, noise], read_len=read_len,
                             strides=list(strides), name_prefix=name,
                             error_rate=error_rate, error_seed=seed,
                             error_model=read_error_model,
                             ont_params=ont_params,
                             dropout_regions=dropout_regions)
    directory = os.path.join(base, name)
    os.makedirs(directory, exist_ok=True)
    bam = os.path.join(directory, "reads.bam")
    fasta = os.path.join(directory, "ref.fa")
    truth = os.path.join(directory, "truth.vcf")
    bed = os.path.join(directory, "conf.bed")
    write_bam(bam, [(contig, length)], records)
    write_fasta(fasta, {contig: ref})
    write_truth_vcf(truth, contig, length, variants)
    with open(bed, "w") as f:
        f.write(f"{contig}\t0\t{length}\n")
    return dict(bam=bam, fasta=fasta, truth=truth, bed=bed,
                variants=variants, noise=noise, ref=ref, contig=contig)


def variant_type(ref_allele: str, alt_allele: str) -> str:
    if len(ref_allele) == len(alt_allele):
        return "SNP"
    return "INS" if len(alt_allele) > len(ref_allele) else "DEL"


def score_vcf_by_type(vcf_path, variants):
    """Per-type recall/precision/GT-concordance of a called VCF against the
    simulated truth (positional match + exact allele match)."""
    import gzip

    called = {}
    opener = gzip.open if vcf_path.endswith(".gz") else open
    with opener(vcf_path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip().split("\t")
            sample = dict(zip(fields[8].split(":"), fields[9].split(":")))
            called[int(fields[1]) - 1] = (fields[3], fields[4],
                                          sample["GT"])

    truth_positions = {p for p, _, _, _ in variants}
    types = ("SNP", "INS", "DEL")
    stats = {t: dict(tp=0, fn=0, fp=0, gt_ok=0, n=0) for t in types}
    for pos, ref_a, alt_a, genotype in variants:
        kind = variant_type(ref_a, alt_a)
        stats[kind]["n"] += 1
        hit = False
        gt = None
        if pos in called:
            ref_c, alts_c, gt = called[pos]
            if gt != "0/0":
                if kind == "DEL":
                    hit = (ref_c == ref_a
                           and alt_a in alts_c.split(","))
                else:
                    hit = alt_a in alts_c.split(",")
        if hit:
            stats[kind]["tp"] += 1
            expected = "1/1" if genotype == "1|1" else "0/1"
            stats[kind]["gt_ok"] += int(gt == expected)
        else:
            stats[kind]["fn"] += 1
    for pos, (ref_c, alts_c, gt) in called.items():
        if gt == "0/0" or pos in truth_positions:
            continue
        stats[variant_type(ref_c, alts_c.split(",")[0])]["fp"] += 1

    for kind in types:
        s = stats[kind]
        s["recall"] = s["tp"] / max(1, s["n"])
        s["precision"] = s["tp"] / max(1, s["tp"] + s["fp"])
        s["gt_concordance"] = s["gt_ok"] / max(1, s["tp"])
    total_tp = sum(stats[t]["tp"] for t in types)
    total_fp = sum(stats[t]["fp"] for t in types)
    total_n = sum(stats[t]["n"] for t in types)
    total_gt = sum(stats[t]["gt_ok"] for t in types)
    stats["ALL"] = dict(
        tp=total_tp, fp=total_fp, n=total_n, gt_ok=total_gt,
        fn=total_n - total_tp,
        recall=total_tp / max(1, total_n),
        precision=total_tp / max(1, total_tp + total_fp),
        gt_concordance=total_gt / max(1, total_tp))
    return stats
