"""Debug renderers: aligned text views of pileup matrices and reads.

Equivalents of the reference's C++ debug_print_matrix /
debug_candidate_summary (region_summary.cpp:919-1054) and the Python
helper/generate_pileup_from_reads.py — used for eyeballing encodings when
chasing candidate-parity bugs."""

from __future__ import annotations

import numpy as np

from ..options import ImageOptions

COLUMN_NAMES_26 = [
    "REFB:", "SNPS:", "INSS:", "DELS:", "REFF:", "SNPF:", "INSF:", "DELF:",
    "AFRW:", "CFRW:", "GFRW:", "TFRW:", "IFRW:", "DFRW:", "*FRW:", "REFR:",
    "SNPR:", "INSR:", "DELR:", "AREV:", "CREV:", "GREV:", "TREV:", "IREV:",
    "DREV:", "*REV:",
]


def render_matrix(image: np.ndarray, reference_sequence: str = "",
                  positions=None, column_names=None) -> str:
    """Transposed text rendering of a (rows, features) image matrix
    (debug_print_matrix layout: one line per feature channel)."""
    rows, features = image.shape
    if column_names is None:
        column_names = (COLUMN_NAMES_26 if features == 26
                        else [f"C{j:02d}:" for j in range(features)])
    lines = []
    if reference_sequence:
        lines.append("REF:\t" + "\t".join(f"  {b}" for b in
                                          reference_sequence[:rows]))
    if positions is not None:
        lines.append("POS:\t" + "\t".join(f"{int(p) % 100:3d}"
                                          for p in positions[:rows]))
    for j in range(features):
        values = "\t".join(f"{int(image[i, j]):3d}" for i in range(rows))
        lines.append(f"{column_names[j]}\t{values}")
    return "\n".join(lines)


def render_candidate_window(window, reference_sequence: str = "") -> str:
    """Candidate-window dump (debug_candidate_summary equivalent)."""
    header = [
        "------------- CANDIDATE PILEUP",
        f"Contig: {window.contig}",
        f"Position: {window.position}",
        f"Depth: {window.depth}",
        f"Candidates: {window.candidates} x{window.candidate_frequency}",
        f"Type label: {window.type_label}",
        f"Base label: {window.base_label} "
        f"{ImageOptions.DECODED_BASE_LABELS[window.base_label]}",
    ]
    return "\n".join(header) + "\n" + render_matrix(window.image,
                                                    reference_sequence)


def render_reads(batch, reference_sequence: str, ref_start: int,
                 ref_end: int, max_reads: int = 50) -> str:
    """Text pileup of reads against the reference
    (helper/generate_pileup_from_reads.py role): one row per read, '.' for
    match, base for mismatch, '*' for deletion, lowercase following an
    insertion anchor."""
    from ..io.bam import (OP_DEL, OP_DIFF, OP_EQUAL, OP_INS, OP_MATCH,
                          OP_REF_SKIP, OP_SOFT_CLIP)

    width = ref_end - ref_start + 1
    lines = ["REF: " + reference_sequence[:width]]
    for r in range(min(batch.n_reads, max_reads)):
        row = [" "] * width
        seq = batch.read_seq(r)
        read_index = 0
        ref_position = int(batch.pos[r])
        for op, length in batch.read_cigar(r):
            if op in (OP_MATCH, OP_EQUAL, OP_DIFF):
                for _ in range(length):
                    if ref_start <= ref_position <= ref_end:
                        ref_base = reference_sequence[
                            ref_position - ref_start]
                        base = seq[read_index]
                        row[ref_position - ref_start] = (
                            "." if base == ref_base else base)
                    read_index += 1
                    ref_position += 1
            elif op == OP_INS:
                anchor = ref_position - 1
                if ref_start <= anchor <= ref_end:
                    row[anchor - ref_start] = \
                        row[anchor - ref_start].lower() or "+"
                read_index += length
            elif op in (OP_DEL, OP_REF_SKIP):
                for i in range(length):
                    if ref_start <= ref_position + i <= ref_end:
                        row[ref_position + i - ref_start] = "*"
                ref_position += length
            elif op == OP_SOFT_CLIP:
                read_index += length
        strand = "-" if batch.is_reverse[r] else "+"
        lines.append(f"{strand}    " + "".join(row))
    return "\n".join(lines)
