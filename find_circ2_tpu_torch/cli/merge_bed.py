"""`merge_bed` — merge junction BEDs across samples (SURVEY.md §2.1).

Junctions identical in (chrom, start, end, strand) merge: support counts
sum, quality fields take the best, tissues/tiss_counts concatenate in
input order [FROZEN]. The category column is re-derived from the merged
evidence through `models.aggregate.category_flags` — the exact code path
the Aggregator uses for fresh runs, so evidence-dependent flags cannot
diverge between a merged table and a joint run.
"""

from __future__ import annotations

import argparse
import sys

from find_circ2_tpu_torch.io.bed import (JunctionRow, read_bed, renumber,
                                        write_bed)
from find_circ2_tpu_torch.models.aggregate import category_flags


def merge_rows(tables: list[list[JunctionRow]]) -> list[JunctionRow]:
    merged: dict[tuple, JunctionRow] = {}
    for rows in tables:
        for row in rows:
            key = row.key()
            cur = merged.get(key)
            if cur is None:
                merged[key] = row
                continue
            cur.n_reads += row.n_reads
            cur.n_uniq += row.n_uniq
            cur.uniq_bridges += row.uniq_bridges
            cur.best_qual_left = max(cur.best_qual_left, row.best_qual_left)
            cur.best_qual_right = max(cur.best_qual_right,
                                      row.best_qual_right)
            cur.tissues += "," + row.tissues
            cur.tiss_counts += "," + row.tiss_counts
            cur.edits = min(cur.edits, row.edits)
            cur.anchor_overlap = min(cur.anchor_overlap, row.anchor_overlap)
            cur.breakpoints = min(cur.breakpoints, row.breakpoints)
            if cur.strandmatch != row.strandmatch:
                cur.strandmatch = "PARTIAL" if "NA" not in (
                    cur.strandmatch, row.strandmatch) else "NA"
    out = []
    for row in merged.values():
        row.category = category_flags(
            "CIRCULAR" in row.category.split(","), row.breakpoints,
            row.uniq_bridges, row.signal, row.strandmatch)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="merge_bed",
                                description="merge junction BED tables")
    p.add_argument("beds", nargs="+")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-p", "--prefix", default="")
    args = p.parse_args(argv)
    tables = [list(read_bed(b)) for b in args.beds]
    rows = renumber(merge_rows(tables), args.prefix)
    out = sys.stdout if args.output == "-" else open(args.output, "wt")
    try:
        write_bed(out, rows)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
