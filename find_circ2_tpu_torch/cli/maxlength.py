"""`maxlength` — drop junctions spanning more than N bp (SURVEY.md §2.1:
guard against trans-splicing artifacts; default 100 kb)."""

from __future__ import annotations

import argparse
import sys

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.io.bed import read_bed, write_bed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="maxlength")
    p.add_argument("bed")
    p.add_argument("max_span", nargs="?", type=int,
                   default=Config().max_span)
    p.add_argument("-o", "--output", default="-")
    args = p.parse_args(argv)
    rows = [r for r in read_bed(args.bed)
            if r.end - r.start <= args.max_span]
    out = sys.stdout if args.output == "-" else open(args.output, "wt")
    try:
        write_bed(out, rows)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
