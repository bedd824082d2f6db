"""Legacy variant-package summary generator (dual-haplotype training labels).

Semantics-exact re-implementation of the variant package's OLD
base-frequency image generator, `pepper_variant/modules/cpp/
summary_generator.{h,cpp}` — bound to Python as `PEPPER_VARIANT.
SummaryGenerator` (pybind_api.h:32-43) but superseded in the live variant
path by `RegionalSummaryGenerator` (SURVEY.md §2.1).  It differs from the
polish package's generator (polish/summary.py) in three ways:

* **two truth haplotype reads** label each expanded position with a
  15-class base-PAIR label (`get_labels`, summary_generator.cpp:64-135):
  unordered {*,A,C,G,T}² → 0..14, unknown pairs → 0;
* a **reference channel**: per expanded position, the reference base
  encoded A/C/G/T → 1..4, inserts/other → 0 (`get_reference_feature_index`,
  :34-41, :443-452);
* **no mapping-quality filter** on the summarized reads (generate_summary,
  :455-462 iterates every read; the polish copy skips mapq 0).

Quirks preserved: insert truth labels are padded with '*' to the observed
longest insert (:220-231, unlike the polish generator's '#'); the
inference chunker emits all-zero label rows (:477 builds zero label
chunks regardless of the labels member); deletion coverage is booked at
the anchor position (via the shared PolishSummary walk).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import (
    OP_DEL, OP_EQUAL, OP_DIFF, OP_INS, OP_MATCH, OP_PAD, OP_REF_SKIP,
    OP_SOFT_CLIP, ReadBatch,
)
from .summary import PolishSummary

# get_labels (summary_generator.cpp:64-135): unordered base-pair classes.
_PAIR_CLASS = {
    "**": 0,
    "AA": 1, "AC": 2, "AT": 3, "AG": 4, "A*": 5,
    "CC": 6, "CT": 7, "CG": 8, "C*": 9,
    "TT": 10, "TG": 11, "T*": 12,
    "GG": 13, "G*": 14,
}


def get_pair_label(base_h1: str, base_h2: str) -> int:
    b1, b2 = base_h1.upper(), base_h2.upper()
    return _PAIR_CLASS.get(b1 + b2, _PAIR_CLASS.get(b2 + b1, 0))


def get_reference_feature_index(base: str) -> int:
    return {"A": 1, "C": 2, "G": 3, "T": 4}.get(base.upper(), 0)


def _check_base(base: str) -> bool:
    # check_base (summary_generator.cpp:172-178)
    return base.upper() in "ACGT*#"


@dataclass
class LegacyVariantSummary(PolishSummary):
    """10-channel normalized image + reference channel + dual-haplotype
    pair labels.  Reuses the polish read walk/image rendering (the C++
    iterate_over_read/generate_image bodies are identical between the two
    packages)."""

    base_labels_hp1: dict = field(default_factory=dict)
    base_labels_hp2: dict = field(default_factory=dict)
    insert_labels_hp1: dict = field(default_factory=dict)
    insert_labels_hp2: dict = field(default_factory=dict)
    ref_image: list = field(default_factory=list)

    # -- truth projection (generate_labels, :179-260) ----------------------

    def _generate_labels_hp(self, batch: ReadBatch, r: int, region_end: int,
                            hp_tag: int) -> None:
        base_labels = (self.base_labels_hp1 if hp_tag == 1
                       else self.base_labels_hp2)
        insert_labels = (self.insert_labels_hp1 if hp_tag == 1
                         else self.insert_labels_hp2)
        seq_start = int(batch.seq_offsets[r])
        seq = batch.seq[seq_start:int(batch.seq_offsets[r + 1])]
        read_index = 0
        ref_position = int(batch.pos[r])
        for op, length in batch.read_cigar(r):
            if ref_position > region_end:
                break
            if op in (OP_MATCH, OP_EQUAL, OP_DIFF):
                start_i = 0
                if ref_position < self.ref_start:
                    start_i = min(self.ref_start - ref_position, length)
                    read_index += start_i
                    ref_position += start_i
                for _ in range(start_i, length):
                    if self.ref_start <= ref_position <= self.ref_end:
                        base_labels[ref_position] = chr(seq[read_index])
                    read_index += 1
                    ref_position += 1
            elif op == OP_INS:
                anchor = ref_position - 1
                if self.ref_start <= anchor <= self.ref_end:
                    alt = seq[read_index:read_index + length].tobytes() \
                        .decode()
                    # padded with '*' to the longest insert (:220-231)
                    for i in range(self.longest_insert_count.get(anchor, 0)):
                        insert_labels[(anchor, i)] = (
                            alt[i] if i < len(alt) else "*")
                read_index += length
            elif op in (OP_REF_SKIP, OP_PAD, OP_DEL):
                # gated on the anchor being in range (:239-240)
                if self.ref_start <= ref_position <= self.ref_end:
                    for i in range(length):
                        if self.ref_start <= ref_position + i <= self.ref_end:
                            base_labels[ref_position + i] = "*"
                ref_position += length
            elif op == OP_SOFT_CLIP:
                read_index += length

    # -- reference channel (:443-452, :464-473) ----------------------------

    def _generate_ref_image(self) -> None:
        for pos in range(self.ref_start, self.ref_end + 1):
            self.ref_image.append(get_reference_feature_index(
                self.reference_sequence[pos - self.ref_start]))
            for _ in range(self.longest_insert_count.get(pos, 0)):
                self.ref_image.append(0)

    # -- public API mirroring the pybind surface ---------------------------

    def generate_summary(self, batch: ReadBatch) -> None:
        """Inference-mode summary (generate_summary, :455-481): every read
        is summarized — no mapq filter here, unlike the polish copy."""
        for r in range(batch.n_reads):
            self._iterate_over_read(batch, r, self.ref_end)
        self._generate_ref_image()
        for pos in range(self.ref_start, self.ref_end + 1):
            self.genomic_pos.append((pos, 0))
            for ii in range(self.longest_insert_count.get(pos, 0)):
                self.genomic_pos.append((pos, ii + 1))
        self._generate_image()

    def generate_train_summary(self, batch: ReadBatch,
                               truth_batch: ReadBatch,
                               truth_index_hp1: int,
                               truth_index_hp2: int) -> None:
        """Train-mode summary with dual-haplotype labels
        (generate_train_summary, :368-455)."""
        for r in range(batch.n_reads):
            self._iterate_over_read(batch, r, self.ref_end)
        self._generate_labels_hp(truth_batch, truth_index_hp1,
                                 self.ref_end + 1, 1)
        self._generate_labels_hp(truth_batch, truth_index_hp2,
                                 self.ref_end + 1, 2)

        for pos in range(self.ref_start, self.ref_end + 1):
            b1 = self.base_labels_hp1.get(pos, "\0")
            b2 = self.base_labels_hp2.get(pos, "\0")
            if self.coverage[pos] > 0:
                self.labels.append(get_pair_label(b1, b2))
            else:
                self.labels.append(get_pair_label("*", "*"))
            if not _check_base(b1) or not _check_base(b2):
                self.bad_label_positions.append(len(self.labels))
            self.genomic_pos.append((pos, 0))
            for ii in range(self.longest_insert_count.get(pos, 0)):
                self.genomic_pos.append((pos, ii + 1))
                l1 = self.insert_labels_hp1.get((pos, ii), "\0")
                l2 = self.insert_labels_hp2.get((pos, ii), "\0")
                if l1 != "\0" and l2 != "\0":
                    self.labels.append(get_pair_label(l1, l2))
                    if not _check_base(l1) or not _check_base(l2):
                        self.bad_label_positions.append(len(self.labels))
                elif l1 != "\0":
                    self.labels.append(get_pair_label(l1, "*"))
                    if not _check_base(l1):
                        self.bad_label_positions.append(len(self.labels))
                elif l2 != "\0":
                    self.labels.append(get_pair_label("*", l2))
                    if not _check_base(l2):
                        self.bad_label_positions.append(len(self.labels))
                else:
                    self.labels.append(get_pair_label("*", "*"))
        self.bad_label_positions.append(len(self.labels))
        self._generate_ref_image()
        self._generate_image()


def chunk_image(summary: LegacyVariantSummary, chunk_size: int = 1000,
                chunk_overlap: int = 50):
    """Inference chunker (chunk_image, :477-536): label chunks are ALWAYS
    zero (the C++ builds fresh zero vectors; the labels member is only
    chunked by the train variant).  Returns
    (images, labels, positions, refs, chunk_ids)."""
    chunk_start, chunk_id = 0, 0
    n = len(summary.genomic_pos)
    chunk_end = min(n, chunk_size)
    images, labels, positions, refs, chunk_ids = [], [], [], [], []
    while True:
        image_chunk = list(summary.image[chunk_start:chunk_end])
        pos_chunk = list(summary.genomic_pos[chunk_start:chunk_end])
        ref_chunk = list(summary.ref_image[chunk_start:chunk_end])
        label_chunk = [0] * (chunk_end - chunk_start)
        padding = chunk_size - len(image_chunk)
        if padding > 0:
            image_chunk += [[0] * 10] * padding
            pos_chunk += [(-1, -1)] * padding
            ref_chunk += [0] * padding
            label_chunk += [0] * padding
        images.append(np.asarray(image_chunk, np.uint8))
        labels.append(np.asarray(label_chunk, np.uint8))
        positions.append(np.asarray(pos_chunk, np.int64))
        refs.append(np.asarray(ref_chunk, np.uint8))
        chunk_ids.append(chunk_id)
        chunk_id += 1
        if chunk_end == n:
            break
        chunk_start = chunk_end - chunk_overlap
        chunk_end = min(n, chunk_start + chunk_size)
    return images, labels, positions, refs, chunk_ids


def chunk_image_train(summary: LegacyVariantSummary, chunk_size: int = 1000,
                      chunk_overlap: int = 50, chunk_id_start: int = 0):
    """Train chunker honoring bad-label segment boundaries
    (chunk_image_train, :539-582)."""
    images, labels, positions, refs, chunk_ids = [], [], [], [], []
    bad = summary.bad_label_positions
    chunk_start = 0
    chunk_id = chunk_id_start
    chunk_end = 0
    for i in range(len(bad)):
        chunk_end = min(chunk_start + chunk_size, bad[i])
        while True:
            if chunk_end - chunk_start != chunk_size:
                padding_required = chunk_size - (chunk_end - chunk_start)
                chunk_start -= padding_required
                if chunk_start < 0:
                    break
                if i > 0 and chunk_start < bad[i - 1]:
                    break
            images.append(np.asarray(
                summary.image[chunk_start:chunk_end], np.uint8))
            positions.append(np.asarray(
                summary.genomic_pos[chunk_start:chunk_end], np.int64))
            refs.append(np.asarray(
                summary.ref_image[chunk_start:chunk_end], np.uint8))
            labels.append(np.asarray(
                summary.labels[chunk_start:chunk_end], np.uint8))
            chunk_ids.append(chunk_id)
            chunk_id += 1
            if chunk_end == bad[i]:
                break
            chunk_start = chunk_end - chunk_overlap
            chunk_end = min(bad[i], chunk_start + chunk_size)
        chunk_start = chunk_end + 1
    return images, labels, positions, refs, chunk_ids
