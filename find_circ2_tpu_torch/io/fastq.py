"""FASTQ reading/writing with transparent gzip support, plus the
anchor-name codec.

The codec reproduces the reference's load-bearing trick (SURVEY.md §3.2):
`unmapped2anchors.py` emits two anchor records per read whose names encode
the FULL original read, so the downstream breakpoint stage never re-reads
the input FASTQ. Frozen wire format (SPEC-adjacent, [FROZEN]):

    <original_name>__<full_seq>__<full_qual_or_dot>__A   (5' anchor)
    <original_name>__<full_seq>__<full_qual_or_dot>__B   (3' anchor)

`__` cannot appear in DNA sequences; original names containing `__` are
rejected at encode time.
"""

from __future__ import annotations

import gzip
import io
import os
from collections.abc import Iterator
from dataclasses import dataclass

SEP = "__"


@dataclass
class FastqRecord:
    name: str
    seq: str
    qual: str  # empty string if absent (FASTA input)


def _open_text(path: str | os.PathLike) -> io.TextIOBase:
    path = os.fspath(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "rt", encoding="ascii")


def read_fastq(path: str | os.PathLike) -> Iterator[FastqRecord]:
    with _open_text(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"{path}: bad FASTQ header {header!r}")
            seq = fh.readline().rstrip("\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                raise ValueError(f"{path}: bad FASTQ separator line")
            qual = fh.readline().rstrip("\n")
            yield FastqRecord(header[1:].split()[0], seq, qual)


def write_fastq(fh: io.TextIOBase, rec: FastqRecord) -> None:
    qual = rec.qual if rec.qual else "I" * len(rec.seq)
    fh.write(f"@{rec.name}\n{rec.seq}\n+\n{qual}\n")


def encode_anchor_name(name: str, seq: str, qual: str, side: str) -> str:
    """Anchor record name carrying the full original read (SURVEY §3.2)."""
    if SEP in name:
        raise ValueError(f"read name {name!r} contains reserved '{SEP}'")
    assert side in ("A", "B")
    return SEP.join((name, seq, qual if qual else ".", side))


def decode_anchor_name(encoded: str) -> tuple[str, str, str, str]:
    """Return (original_name, full_seq, full_qual, side).

    Parsed left-to-right with fixed structure because Phred quality strings
    may legally contain '_' (and hence '__'): name and sequence are
    SEP-free by construction, and side is always the single last char.
    """
    name, rest = encoded.split(SEP, 1)
    seq, rest = rest.split(SEP, 1)
    if len(rest) < 3 or rest[-3:-1] != SEP or rest[-1] not in "AB":
        raise ValueError(f"bad anchor name {encoded!r}")
    qual, side = rest[:-3], rest[-1]
    return name, seq, ("" if qual == "." else qual), side


def anchors_for_read(rec: FastqRecord, anchor_len: int):
    """Yield the two anchor FastqRecords for a read, or nothing if too short.

    Mirrors the reference's unmapped2anchors behavior (SURVEY §3.2): reads
    shorter than 2*anchor_len are skipped.
    """
    if len(rec.seq) < 2 * anchor_len:
        return
    base = encode_anchor_name(rec.name, rec.seq, rec.qual, "A")
    yield FastqRecord(base, rec.seq[:anchor_len],
                      rec.qual[:anchor_len] if rec.qual else "")
    base = encode_anchor_name(rec.name, rec.seq, rec.qual, "B")
    yield FastqRecord(base, rec.seq[-anchor_len:],
                      rec.qual[-anchor_len:] if rec.qual else "")
