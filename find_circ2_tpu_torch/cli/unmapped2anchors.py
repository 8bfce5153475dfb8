"""`unmapped2anchors` — split unmapped reads into terminal anchor records.

Reproduces the reference tool's contract (SURVEY.md §2.1/§3.2): reads in,
two anchor FASTQ records out per read, with the full original read encoded
in the record name so downstream stages never re-read the input. Input is
FASTQ(.gz), SAM text (.gz) or binary BAM (sniffed by content); SAM/BAM
keep unmapped primary records only — the
`samtools view -f 4 | unmapped2anchors` front end of the reference
pipeline (SURVEY §3.1) in one step, no samtools needed (SURVEY §2.2).
"""

from __future__ import annotations

import argparse
import sys

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.io.fastq import (FastqRecord, anchors_for_read,
                                           read_fastq, write_fastq)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unmapped2anchors",
        description="emit anchor FASTQ records for unmapped reads")
    p.add_argument("reads",
                   help="FASTQ(.gz), SAM(.gz) or BAM of unmapped reads")
    p.add_argument("--format", choices=("auto", "fastq", "sam", "bam"),
                   default="auto",
                   help="input format (default: sniff by content); "
                   "sam/bam keep unmapped primary records only (the "
                   "samtools view -f 4 selection)")
    p.add_argument("-a", "--anchor", type=int,
                   default=Config().anchor_len,
                   help="anchor length (default %(default)s)")
    p.add_argument("-o", "--output", default="-",
                   help="output FASTQ path (default stdout)")
    return p


def _records(args):
    fmt = args.format
    if fmt == "auto":
        from find_circ2_tpu_torch.io.bam import sniff_format
        fmt = sniff_format(args.reads)
    if fmt in ("sam", "bam"):
        if fmt == "sam":
            from find_circ2_tpu_torch.io.sam import reads_from_sam as reader
        else:
            from find_circ2_tpu_torch.io.bam import reads_from_bam as reader
        for name, seq, qual, _mate2 in reader(args.reads):
            yield FastqRecord(name, seq, qual)
    else:
        yield from read_fastq(args.reads)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = sys.stdout if args.output == "-" else open(args.output, "wt")
    n_reads = n_short = 0
    try:
        for rec in _records(args):
            n_reads += 1
            emitted = False
            for anc in anchors_for_read(rec, args.anchor):
                write_fastq(out, anc)
                emitted = True
            if not emitted:
                n_short += 1
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"unmapped2anchors: {n_reads} reads, {n_short} too short",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
