"""Junction BED table: the bit-exactness output contract.

Column set and semantics follow SURVEY.md §2.3; ordering, naming and flag
composition are frozen in SPEC.md §5. `JunctionRow` is the single row type
used by `merge_bed`, `cmp_bed` and tests; `JunctionRows`, the final table's
columns, stands for a list of them and is what `write_bed` formats fastest.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from collections.abc import Iterable, Iterator, Sequence
from operator import attrgetter

from find_circ2_tpu_torch.config import BED_COLUMNS
from find_circ2_tpu_torch.utils.profiling import count, span

HEADER = "#" + "\t".join(BED_COLUMNS)
# The one line format, a row's or the table's: `%s` is `str()` for every
# field, so a line is the same text from a row object or from columns.
_LINE = "\t".join(["%s"] * len(BED_COLUMNS))
_FIELDS = attrgetter(*BED_COLUMNS)


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
        return _LINE % _FIELDS(self)

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


class JunctionRows(Sequence):
    """The final table (`Aggregator.rows`): one list a BED column, in
    BED_COLUMNS order, each holding what the rows' fields would. It is
    the list of its `JunctionRow`s to every reader (len, indexing,
    iteration, reversed, ==), and builds them all at once, under the
    current span's `build`, the first time a row is asked for; until
    then `write_bed` formats its lines straight from the columns."""

    def __init__(self, columns: list[list]) -> None:
        self.columns = columns
        self.built: list[JunctionRow] | None = None

    def rows(self) -> list[JunctionRow]:
        if self.built is None:
            with span("build"):
                self.built = list(map(JunctionRow, *self.columns))
        return self.built

    def __len__(self) -> int:
        return len(self.columns[0])

    def __getitem__(self, i):
        return self.rows()[i]

    def __iter__(self) -> Iterator[JunctionRow]:
        return iter(self.rows())

    def __reversed__(self) -> Iterator[JunctionRow]:
        return reversed(self.rows())

    def __eq__(self, other) -> bool:
        if isinstance(other, JunctionRows):
            other = other.rows()
        return self.rows() == other


def write_bed(fh_or_path, rows: Iterable[JunctionRow],
              header: bool = True) -> None:
    """The header, then one `_LINE` a row, in one write. A JunctionRows
    whose rows were never built is formatted from its columns (counter
    `table_lines` under the current span); anything else one row object
    at a time (`row_lines`)."""
    if isinstance(rows, JunctionRows) and rows.built is None:
        lines = list(map(_LINE.__mod__, zip(*rows.columns)))
        count("table_lines", len(lines))
    else:
        lines = list(map(_LINE.__mod__, map(_FIELDS, rows)))
        count("row_lines", len(lines))
    lines.append("")
    own = isinstance(fh_or_path, (str, os.PathLike))
    fh = open(fh_or_path, "wt", encoding="ascii") if own else fh_or_path
    try:
        if header:
            fh.write(HEADER + "\n")
        fh.write("\n".join(lines))
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
