"""Minimal VCF reader (plain or bgzip/gzip) for truth labels.

Equivalent of the reference's pysam-based truth parse
(AlignmentSummarizer.py:39-66): PASS-filtered records split into
per-haplotype TruthRecord lists by the GT field.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass
class VcfRecord:
    contig: str
    start: int          # 0-based
    stop: int           # start + len(ref)
    ref: str
    alts: list[str]
    qual: str
    filters: list[str]
    genotype: list[int]
    sample_fields: dict


def _open_text(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_vcf(path: str, contig: str | None = None, start: int | None = None,
             stop: int | None = None):
    """Yield VcfRecords, optionally restricted to records overlapping
    [start, stop) on contig."""
    with _open_text(path) as f:
        format_keys = None
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 8:
                continue
            chrom = fields[0]
            if contig is not None and chrom != contig:
                continue
            pos = int(fields[1]) - 1
            ref = fields[3]
            record_stop = pos + len(ref)
            if start is not None and record_stop <= start:
                continue
            if stop is not None and pos >= stop:
                continue
            alts = fields[4].split(",") if fields[4] != "." else []
            filters = fields[6].split(";") if fields[6] != "." else []
            genotype = []
            sample_fields = {}
            if len(fields) >= 10:
                keys = fields[8].split(":")
                values = fields[9].split(":")
                sample_fields = dict(zip(keys, values))
                gt = sample_fields.get("GT")
                if gt:
                    sep = "|" if "|" in gt else "/"
                    try:
                        genotype = [int(x) for x in gt.split(sep)]
                    except ValueError:
                        genotype = []
            yield VcfRecord(chrom, pos, record_stop, ref, alts, fields[5],
                            filters, genotype, sample_fields)


def get_truth_haplotype_records(path: str, contig: str, start: int,
                                stop: int):
    """PASS records -> (hap1_records, hap2_records) of TruthRecord
    (AlignmentSummarizer.py:39-66)."""
    from ..ops.pileup_ref import TruthRecord

    hap1, hap2 = [], []
    for record in read_vcf(path, contig, start, stop):
        if "PASS" not in record.filters:
            continue
        alleles = [record.ref] + record.alts
        for hap, alt_location in enumerate(record.genotype):
            if alt_location == 0:
                continue
            truth = TruthRecord(record.contig, record.start, record.stop,
                                alleles[0], alleles[alt_location])
            if hap == 0:
                hap1.append(truth)
            else:
                hap2.append(truth)
    return hap1, hap2
