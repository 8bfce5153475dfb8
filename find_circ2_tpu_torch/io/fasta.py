"""FASTA reading/writing with transparent gzip support.

Host-side replacement for the reference's pysam/faidx genome access
(SURVEY.md §2.2 "samtools/pysam" rows); pure Python + numpy.
"""

from __future__ import annotations

import gzip
import io
import os
from collections.abc import Iterator


def _open_text(path: str | os.PathLike) -> io.TextIOBase:
    path = os.fspath(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "rt", encoding="ascii")


def read_fasta(path: str | os.PathLike) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) per record. Name is the first whitespace token."""
    name = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                if name is None:
                    raise ValueError(f"{path}: sequence before first header")
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def write_fasta(path: str | os.PathLike, records, width: int = 80) -> None:
    """Write (name, sequence) pairs as FASTA."""
    with open(path, "wt", encoding="ascii") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
