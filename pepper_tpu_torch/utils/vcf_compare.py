"""VCF comparison / statistics helpers (the reference's
helper/{merge_vcf_test,test_vcf,vcf_stat_test,vcf_plot_vaf}.py roles):
positional diff of two call sets and summary statistics over one."""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

from ..io.vcf_reader import read_vcf


def _site_key(record):
    return (record.contig, record.start)


@dataclass
class VcfComparison:
    matches: list = field(default_factory=list)
    allele_mismatches: list = field(default_factory=list)
    genotype_mismatches: list = field(default_factory=list)
    only_in_a: list = field(default_factory=list)
    only_in_b: list = field(default_factory=list)

    def summary(self) -> dict:
        return {
            "matches": len(self.matches),
            "allele_mismatches": len(self.allele_mismatches),
            "genotype_mismatches": len(self.genotype_mismatches),
            "only_in_a": len(self.only_in_a),
            "only_in_b": len(self.only_in_b),
        }


def compare_vcfs(path_a: str, path_b: str,
                 ignore_refcalls: bool = True) -> VcfComparison:
    def load(path):
        sites = {}
        for record in read_vcf(path):
            if ignore_refcalls and sorted(record.genotype or [0]) == [0, 0]:
                continue
            sites[_site_key(record)] = record
        return sites

    a_sites = load(path_a)
    b_sites = load(path_b)
    result = VcfComparison()
    for key, record_a in a_sites.items():
        if key not in b_sites:
            result.only_in_a.append(record_a)
            continue
        record_b = b_sites[key]
        if (record_a.ref != record_b.ref
                or sorted(record_a.alts) != sorted(record_b.alts)):
            result.allele_mismatches.append((record_a, record_b))
        elif sorted(record_a.genotype) != sorted(record_b.genotype):
            result.genotype_mismatches.append((record_a, record_b))
        else:
            result.matches.append(record_a)
    for key, record_b in b_sites.items():
        if key not in a_sites:
            result.only_in_b.append(record_b)
    return result


def vcf_statistics(path: str) -> dict:
    """Counts by variant class / filter / genotype + VAF histogram data."""
    counts = Counter()
    vafs = []
    per_contig = defaultdict(int)
    for record in read_vcf(path):
        per_contig[record.contig] += 1
        counts["records"] += 1
        for filter_name in record.filters:
            counts[f"filter_{filter_name}"] += 1
        gt = sorted(record.genotype) if record.genotype else []
        if gt == [0, 0]:
            counts["ref_calls"] += 1
        elif len(set(gt) - {0}) > 1:
            counts["multiallelic_gt"] += 1
        elif 0 in gt:
            counts["het"] += 1
        else:
            counts["hom_alt"] += 1
        max_len = max([len(record.ref)] + [len(a) for a in record.alts]) \
            if record.alts else len(record.ref)
        if max_len == 1:
            counts["snp"] += 1
        elif record.alts and len(record.ref) > max(len(a)
                                                   for a in record.alts):
            counts["deletion"] += 1
        else:
            counts["insertion"] += 1
        vaf_field = record.sample_fields.get("VAF")
        if vaf_field and vaf_field != ".":
            for value in vaf_field.split(","):
                try:
                    vafs.append(float(value))
                except ValueError:
                    pass
    return {"counts": dict(counts), "per_contig": dict(per_contig),
            "vafs": vafs}


def vaf_histogram(vafs, bins: int = 20, width: int = 50) -> str:
    """Text VAF histogram — the reference's helper/vcf_plot_vaf.py role
    (matplotlib histogram of per-record VAF values) rendered terminal-side
    so it works in headless environments."""
    import numpy as np

    if not vafs:
        return "(no VAF values)"
    hist, edges = np.histogram(np.clip(np.asarray(vafs, float), 0.0, 1.0),
                               bins=bins, range=(0.0, 1.0))
    peak = max(1, int(hist.max()))
    lines = []
    for count, lo, hi in zip(hist, edges[:-1], edges[1:]):
        bar = "#" * int(round(width * count / peak))
        lines.append(f"{lo:5.2f}-{hi:4.2f} {count:8d} {bar}")
    lines.append(f"total={len(vafs)} mean={np.mean(vafs):.3f} "
                 f"median={np.median(vafs):.3f}")
    return "\n".join(lines)
