"""SAM text input: the host-side replacement for the reference's
samtools/pysam front end (SURVEY.md §2.2 samtools row, §3.1 pipeline).

The reference feeds `bowtie2 | samtools view -hbf 4` (unmapped records)
into unmapped2anchors.py. This module reads SAM **text** (plain or .gz)
produced by any aligner and recovers original reads:

- header lines (`@...`) are skipped;
- secondary (0x100) and supplementary (0x800) records are skipped — they
  duplicate a primary record's read;
- records with reverse-strand flag 0x10 carry the reverse-complemented
  sequence; the reader restores the original read orientation;
- `unmapped_only` keeps flag-0x4 records — the exact
  `samtools view -f 4` selection the reference pipeline makes;
- mate flags 0x40/0x80 append `/1` / `/2` to bare names so paired records
  stay distinct, and expose `mate2` for `--pe` handling (SPEC.md §7).

Binary BAM input is handled by io/bam.py, which shares this module's
`original_reads` record→read selection so the two formats cannot diverge.
"""

from __future__ import annotations

import gzip
import io
import os
from collections.abc import Iterator
from dataclasses import dataclass

from find_circ2_tpu_torch.io.twobit import revcomp_seq

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class SamRecord:
    name: str
    flag: int
    seq: str      # as stored in the file (aligned orientation)
    qual: str     # empty if '*'


def _open_text(path: str | os.PathLike) -> io.TextIOBase:
    path = os.fspath(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "rt", encoding="ascii")


def read_sam(path: str | os.PathLike) -> Iterator[SamRecord]:
    """Yield every alignment record of a SAM text file, headers skipped."""
    with _open_text(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if not line.strip() or line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                raise ValueError(f"{path}:{lineno}: bad SAM record "
                                 f"({len(f)} fields)")
            yield SamRecord(name=f[0], flag=int(f[1]), seq=f[9],
                            qual="" if f[10] == "*" else f[10])


def reads_from_sam(path: str | os.PathLike, unmapped_only: bool = True
                   ) -> Iterator[tuple[str, str, str, bool]]:
    """Yield (name, seq, qual, mate2) original reads from SAM text.

    Primary records only; reverse-flagged sequences (and their quality
    strings) are restored to the as-sequenced orientation; `unmapped_only`
    mirrors `samtools view -f 4`. Records with `*` sequence are skipped
    (their sequence lives in the primary record)."""
    return original_reads(read_sam(path), unmapped_only)


def original_reads(records: Iterator[SamRecord],
                   unmapped_only: bool = True
                   ) -> Iterator[tuple[str, str, str, bool]]:
    """The record→read selection shared by SAM text and BAM input
    (io/bam.py): one filter, so the two formats cannot diverge."""
    for rec in records:
        if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
            continue
        if unmapped_only and not rec.flag & FLAG_UNMAPPED:
            continue
        if rec.seq == "*" or not rec.seq:
            continue
        seq, qual = rec.seq, rec.qual
        if rec.flag & FLAG_REVERSE:
            seq = revcomp_seq(seq)
            qual = qual[::-1]
        name = rec.name
        mate2 = bool(rec.flag & FLAG_MATE2)
        if rec.flag & FLAG_PAIRED and not name.endswith(("/1", "/2")):
            name = f"{name}/{2 if mate2 else 1}"
        yield name, seq, qual, mate2
