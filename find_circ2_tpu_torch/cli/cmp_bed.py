"""`cmp_bed` — compare two junction BED tables (SURVEY.md §2.1): the
reference's regression-test mechanism. Reports concordance on junction
identity (chrom, start, end, strand) and field-level differences; exit
code 0 iff identical under the requested strictness."""

from __future__ import annotations

import argparse
import sys

from find_circ2_tpu_torch.config import BED_COLUMNS
from find_circ2_tpu_torch.io.bed import read_bed


def compare(a_rows, b_rows, fields: bool = True):
    a = {r.key(): r for r in a_rows}
    b = {r.key(): r for r in b_rows}
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    diffs = []
    for key in sorted(set(a) & set(b)):
        if not fields:
            continue
        ra, rb = a[key], b[key]
        for col in BED_COLUMNS:
            if col == "name":
                continue
            va, vb = getattr(ra, col), getattr(rb, col)
            if va != vb:
                diffs.append((key, col, va, vb))
    return only_a, only_b, diffs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cmp_bed",
                                description="compare junction BED tables")
    p.add_argument("bed_a")
    p.add_argument("bed_b")
    p.add_argument("--keys-only", action="store_true",
                   help="compare junction identity only, not all columns")
    args = p.parse_args(argv)
    only_a, only_b, diffs = compare(list(read_bed(args.bed_a)),
                                    list(read_bed(args.bed_b)),
                                    fields=not args.keys_only)
    for k in only_a:
        print(f"only in {args.bed_a}: {k}")
    for k in only_b:
        print(f"only in {args.bed_b}: {k}")
    for key, col, va, vb in diffs:
        print(f"differs {key} {col}: {va} != {vb}")
    n_common = "?"
    ok = not (only_a or only_b or diffs)
    print(f"concordant: {ok} (A-only={len(only_a)} B-only={len(only_b)} "
          f"field-diffs={len(diffs)})", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
