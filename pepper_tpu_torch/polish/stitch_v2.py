"""Alignment-based chunk stitching (the reference's StitchV2.py:50-164):
overlapping consensus chunks are joined by locally aligning the right
chunk's head against the left chunk's tail and cutting at the first
confident (>=5 match) anchor; unalignable overlaps are joined with 10 Ns."""

from __future__ import annotations

import re

from ..io.align import Aligner

MATCH_PENALTY = 4
MISMATCH_PENALTY = 6
GAP_PENALTY = 8
GAP_EXTEND_PENALTY = 2
BASE_ERROR_RATE = 0.0


def get_confident_positions(alignment):
    """First >=5-long match anchor -> (ref_index, read_index)
    (StitchV2.py:50-93)."""
    cigar_string = alignment.cigar_string.replace("=", "M").replace("X", "M")
    cigar_tuples = re.findall(r"(\d+)(\w)", cigar_string)

    grouped = []
    prev_len, prev_op = 0, None
    for cigar_len, cigar_op in cigar_tuples:
        if prev_op is None:
            prev_op, prev_len = cigar_op, int(cigar_len)
        elif prev_op == cigar_op:
            prev_len += int(cigar_len)
        else:
            grouped.append((prev_op, prev_len))
            prev_op, prev_len = cigar_op, int(cigar_len)
    if prev_op is not None:
        grouped.append((prev_op, prev_len))

    ref_index = alignment.reference_begin
    read_index = 0
    for cigar_op, cigar_len in grouped:
        if cigar_op == "M" and cigar_len >= 5:
            return ref_index, read_index
        if cigar_op in ("S", "I"):
            read_index += cigar_len
        elif cigar_op == "D":
            ref_index += cigar_len
        elif cigar_op == "M":
            ref_index += cigar_len
            read_index += cigar_len
        else:
            raise ValueError(
                f"INVALID CIGAR OPERATION ENCOUNTERED WHILE STITCHING: "
                f"{cigar_op}")
    return -1, -1


def alignment_stitch(sequence_chunks):
    """sequence_chunks: [(contig, start, end, sequence)] ->
    (contig, start, end, stitched_sequence) (StitchV2.py:96-164)."""
    sequence_chunks = sorted(sequence_chunks,
                             key=lambda element: (element[1], element[2]))
    contig, running_start, running_end, running_sequence = sequence_chunks[0]

    aligner = Aligner(MATCH_PENALTY, MISMATCH_PENALTY, GAP_PENALTY,
                      GAP_EXTEND_PENALTY)
    for i in range(1, len(sequence_chunks)):
        _, this_start, this_end, this_sequence = sequence_chunks[i]
        if this_start < running_end:
            overlap_bases = running_end - this_start
            overlap_bases = overlap_bases + int(overlap_bases
                                                * BASE_ERROR_RATE)
            reference_sequence = running_sequence[-overlap_bases:]
            read_sequence = this_sequence[:overlap_bases]

            aligner.set_reference_sequence(reference_sequence)
            alignment = aligner.align(read_sequence)

            joined = False
            if alignment.best_score != 0:
                pos_a, pos_b = get_confident_positions(alignment)
                if pos_a != -1 and pos_b != -1:
                    left_sequence = running_sequence[:-overlap_bases]
                    overlap_sequence = reference_sequence[:pos_a]
                    right_sequence = this_sequence[pos_b:]
                    running_sequence = (left_sequence + overlap_sequence
                                        + right_sequence)
                    running_end = this_end
                    joined = True
            if not joined:
                running_sequence = (running_sequence + 10 * "N"
                                    + this_sequence)
                running_end = this_end
        else:
            running_sequence = running_sequence + this_sequence
            running_end = this_end

    return contig, running_start, running_end, running_sequence
