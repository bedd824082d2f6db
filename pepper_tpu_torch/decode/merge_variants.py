"""Merge PEPPER-confident calls with DeepVariant re-genotyped calls.

Semantics from MergeVariants.py:8-79 + MergedVcfWriter.py:19-51: DeepVariant
records positionally override PEPPER records; output carries a FORMAT C
field (P=PEPPER, DV=DeepVariant) and DeepVariant AD drops the ref entry.

Unlike the reference (which buffers the whole DeepVariant set in a
positional dict, MergeVariants.py:62-75), sorted inputs stream through a
two-pointer merge in O(1) memory — WGS-scale merges stay memory-flat.  A
cheap (contig, pos)-only pre-pass detects unsorted input and falls back to
the positional-dict path, which is order-independent."""

from __future__ import annotations

import heapq
import os

from ..io.bgzf_writer import BgzfWriter
from ..io.tabix import TabixIndexBuilder
from ..io.vcf_reader import _open_text, read_vcf
from ..pipeline.regions import log_info


def _read_contig_header(path: str):
    import gzip

    contigs = []
    sample = None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("##contig="):
                inner = line.strip()[len("##contig=<"):-1]
                fields = dict(kv.split("=", 1) for kv in inner.split(","))
                contigs.append((fields["ID"], int(fields.get("length", 0))))
            elif line.startswith("#CHROM"):
                sample = line.strip().split("\t")[9]
                break
    return contigs, sample


_MERGED_HEADER_LINES = [
    "##fileformat=VCFv4.2",
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FILTER=<ID=refCall,Description="Call is homozygous">',
    '##FILTER=<ID=lowGQ,Description="Low genotype quality">',
    '##FILTER=<ID=lowQUAL,Description="Low variant call quality">',
    '##FILTER=<ID=conflictPos,Description="Overlapping record">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
    '##FORMAT=<ID=AD,Number=A,Type=Integer,Description="Allele depth">',
    '##FORMAT=<ID=VAF,Number=A,Type=Float,'
    'Description="Variant allele fractions.">',
    '##FORMAT=<ID=AP,Number=1,Type=Float,Description='
    '"Maximum variant allele probability for each allele.">',
    '##FORMAT=<ID=GQ,Number=1,Type=Float,Description="Genotype Quality">',
    '##FORMAT=<ID=C,Number=1,Type=String,'
    'Description="Genotyper P=PEPPER DV=DeepVariant">',
]


def _make_position_key(contigs):
    """(contig, pos) -> sortable key: header contigs by header rank,
    unknown contigs after them in lexical order (deterministic across
    streams, so sortedness checks agree between the inputs)."""
    rank = {name: i for i, (name, _) in enumerate(contigs)}
    unknown = len(rank)

    def key(contig, pos):
        r = rank.get(contig)
        if r is None:
            return (unknown, contig, pos)
        return (r, "", pos)

    return key


def _scan_vcf(path, key):
    """One cheap pass parsing only (contig, pos): returns
    (is_sorted, record_count)."""
    last = None
    is_sorted = True
    count = 0
    with _open_text(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            tab1 = line.find("\t")
            tab2 = line.find("\t", tab1 + 1)
            if tab1 < 0 or tab2 < 0:
                continue
            count += 1
            if not is_sorted:
                continue
            k = key(line[:tab1], int(line[tab1 + 1:tab2]))
            if last is not None and k < last:
                is_sorted = False
            last = k
    return is_sorted, count


def _dv_stream(dv_paths, key):
    """Single (contig-rank, pos)-ordered DeepVariant stream over one or two
    sorted files.  heapq.merge is stable, so at equal positions the later
    file's record comes last — matching the dict-overwrite semantics of
    processing snps then indels (MergeVariants.py:66-72)."""
    streams = [read_vcf(path) for path in dv_paths]
    return heapq.merge(*streams, key=lambda r: key(r.contig, r.start))


def merge_vcf_records(options):
    if getattr(options, "vcf_deepvariant", None):
        dv_paths = [options.vcf_deepvariant]
    else:
        dv_paths = [options.vcf_deepvariant_snps,
                    options.vcf_deepvariant_indels]

    contigs, pepper_sample = _read_contig_header(options.vcf_pepper)
    _, dv_sample = _read_contig_header(dv_paths[0])
    if pepper_sample != dv_sample:
        raise ValueError("SAMPLE NAMES IN TWO VCFs DO NOT MATCH.")

    key = _make_position_key(contigs)
    scans = [_scan_vcf(path, key)
             for path in [options.vcf_pepper] + dv_paths]
    total_dv = sum(count for _, count in scans[1:])
    log_info(f"TOTAL VARIANTS IN DeepVariant: {total_dv}")
    streamed = all(is_sorted for is_sorted, _ in scans)
    positional_dv = None
    if streamed:
        log_info("SORTED INPUTS: USING THE STREAMED TWO-POINTER MERGE")
    else:
        log_info("UNSORTED INPUT DETECTED: BUFFERING DeepVariant "
                 "RECORDS POSITIONALLY")
        positional_dv = {}
        for path in dv_paths:
            for record in read_vcf(path):
                positional_dv[(record.contig, record.start)] = record

    header_lines = list(_MERGED_HEADER_LINES)
    for contig, length in contigs:
        header_lines.append(f"##contig=<ID={contig},length={length}>")
    header_lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + pepper_sample)
    header = "\n".join(header_lines) + "\n"

    output_path = os.path.join(options.output_dir,
                               "PEPPER_MARGIN_DEEPVARIANT_OUTPUT.vcf.gz")
    os.makedirs(options.output_dir, exist_ok=True)
    tabix = TabixIndexBuilder()
    total_pepper_calls = total_dv_calls = total_pass = 0
    dv_iter = iter(_dv_stream(dv_paths, key)) if streamed else None
    dv_next = next(dv_iter, None) if streamed else None
    held_key = held_record = None
    with open(output_path, "wb") as raw:
        writer = BgzfWriter(raw)
        writer.write(header.encode())
        for record in read_vcf(options.vcf_pepper):
            position_key = key(record.contig, record.start)
            if streamed:
                # advance the DV pointer through everything at or before
                # this position; the LAST record at an equal position wins
                # (dict-overwrite semantics) and stays held so duplicate
                # PEPPER records at one position all see it
                while dv_next is not None and key(
                        dv_next.contig, dv_next.start) <= position_key:
                    if key(dv_next.contig,
                           dv_next.start) == position_key:
                        held_key, held_record = position_key, dv_next
                    dv_next = next(dv_iter, None)
                dv_hit = held_record if held_key == position_key else None
            else:
                dv_hit = positional_dv.get((record.contig, record.start))
            if dv_hit is not None:
                final = dv_hit
                is_dv = True
                total_dv_calls += 1
            else:
                final = record
                is_dv = False
                total_pepper_calls += 1
            record_filter = ("PASS" if "PASS" in final.filters
                             else "refCall")
            if record_filter == "PASS":
                total_pass += 1
            sample_fields = final.sample_fields
            ad_values = sample_fields.get("AD", ".").split(",")
            if is_dv and len(ad_values) > 1:
                ad_values = ad_values[1:]
            sample = ":".join([
                sample_fields.get("GT", "./."),
                sample_fields.get("GQ", "."),
                str(sample_fields.get("DP", ".")),
                ",".join(ad_values),
                sample_fields.get("VAF", "."),
                "DV" if is_dv else "P",
            ])
            alts = ",".join(final.alts) if final.alts else "."
            line = "\t".join([
                final.contig, str(final.start + 1), ".", final.ref, alts,
                str(final.qual), record_filter, ".", "GT:GQ:DP:AD:VAF:C",
                sample]) + "\n"
            voff_start = writer.tell_virtual()
            writer.write(line.encode())
            tabix.add(final.contig, final.start, final.stop,
                      voff_start, writer.tell_virtual())
        writer.close()
    tabix.write(output_path + ".tbi")
    log_info(f"TOTAL VARIANTS FROM PEPPER: {total_pepper_calls}")
    log_info(f"TOTAL VARIANTS FROM DEEPVARIANT: {total_dv_calls}")
    log_info(f"TOTAL PASS VARIANTS: {total_pass}")
    return output_path
