"""Junction aggregation, category flags, and BED table construction.

A frozen copy of the host aggregation's per-call path (`Aggregator.add`,
`rows`): per-read `ReadCall` records flow in one by one, `JunctionRow`s
flow out. The program's vectorised batch path (`add_batch`) is left out.
Semantics: SPEC.md §5 / SURVEY.md §3.5 (single pass over a junction dict
at EOF).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from portbench.reference.config import (
    Config,
    KIND_CIRCULAR,
    SENSE_CHARS,
    ST_JUNCTION,
    STATUS_NAMES,
)
from portbench.reference.bed import JunctionRow, renumber
from portbench.reference.genome import Genome
from portbench.reference.oracle import ReadCall


def category_flags(circular: bool, breakpoints: int, uniq_bridges: int,
                   signal: str, strandmatch: str) -> str:
    """Frozen category derivation from junction evidence (SPEC.md §5).

    The single source of truth for the `category` column: the Aggregator
    builds fresh rows through it, and `merge_bed` re-derives categories
    from merged evidence through the same call — evidence-dependent flags
    (UNAMBIGUOUS_BP / ANCHOR_UNIQUE / NO_UNIQ_BRIDGES / STRANDMATCH) can
    never diverge between the two paths.
    """
    flags = ["CIRCULAR" if circular else "LINEAR"]
    if breakpoints == 1:
        flags.append("UNAMBIGUOUS_BP")
    if uniq_bridges >= 1:
        flags.append("ANCHOR_UNIQUE")
    else:
        flags.append("NO_UNIQ_BRIDGES")
    if signal == "GTAG":
        flags.append("CANONICAL")
    if strandmatch == "MATCH":
        flags.append("STRANDMATCH")
    return ",".join(flags)


@dataclass
class JunctionAgg:
    kind: int
    chrom_idx: int
    start: int                # global coordinate
    end: int
    sense: int
    signal: str
    n_reads: int = 0
    seqs: set = field(default_factory=set)
    uniq_bridges: int = 0
    best_qual_left: int = 0
    best_qual_right: int = 0
    edits: int = 1 << 30
    overlap: int = 1 << 30
    n_bp: int = 1 << 30
    n_strand_match: int = 0   # reads whose alignment strand == sense


@dataclass
class Stats:
    """Per-run counters (reference's `-s` stats file, SURVEY §2.1)."""
    counts: dict = field(default_factory=dict)

    # Per-READ counters that sum across processes (psum'd by the --nproc
    # CLI epilogue). Junction counts are excluded: they are derived from
    # the MERGED table in rows(), not summable per rank.
    REDUCE_ORDER = ("reads_total", *STATUS_NAMES.values(),
                    "circular_reads", "linear_reads")

    def add_status(self, status: int, n: int = 1) -> None:
        name = STATUS_NAMES[status]
        self.counts[name] = self.counts.get(name, 0) + n

    def add(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def lines(self) -> list[str]:
        order = [*self.REDUCE_ORDER, "circular_junctions",
                 "linear_junctions"]
        seen = [k for k in order if k in self.counts]
        extra = sorted(k for k in self.counts if k not in order)
        return [f"{k}\t{self.counts[k]}" for k in seen + extra]


# --- n_uniq sequence identity -----------------------------------------
# `n_uniq` counts DISTINCT processed read sequences per junction, each
# identified by a deterministic 64-bit hash of its RPAD-padded code
# vector (dot product with fixed odd weights mod 2^64) instead of the
# string itself; a collision (~n^2 / 2^64) would undercount n_uniq by 1.
_SEQ_W: dict[int, "np.ndarray"] = {}


def _seq_weights(Lp: int):
    import numpy as np
    w = _SEQ_W.get(Lp)
    if w is None:
        rng = np.random.default_rng(0xF1FC2)
        w = rng.integers(1, 2 ** 63, Lp, dtype=np.uint64) | np.uint64(1)
        _SEQ_W[Lp] = w
    return w


def seq_hash(seq: str, Lp: int) -> int:
    """Hash of one processed read sequence (scalar path)."""
    import numpy as np
    from portbench.reference.config import RPAD_CODE
    from portbench.reference.twobit import seq_to_codes
    codes = np.full(Lp, RPAD_CODE, np.uint8)
    c = seq_to_codes(seq)
    codes[:c.size] = c
    return int((codes.astype(np.uint64) * _seq_weights(Lp))
               .sum(dtype=np.uint64))


class Aggregator:
    """Accumulates ReadCalls into the junction dictionary."""

    def __init__(self, genome: Genome, cfg: Config = Config()) -> None:
        self.genome = genome
        self.cfg = cfg
        self.junctions: dict[tuple, JunctionAgg] = {}
        self.stats = Stats()

    def add(self, call: ReadCall) -> None:
        self.stats.add("reads_total")
        self.stats.add_status(call.status)
        if call.status != ST_JUNCTION:
            return
        self.stats.add("circular_reads" if call.kind == KIND_CIRCULAR
                       else "linear_reads")
        key = (call.kind, call.chrom_idx, call.start, call.end, call.sense)
        agg = self.junctions.get(key)
        if agg is None:
            agg = JunctionAgg(kind=call.kind, chrom_idx=call.chrom_idx,
                              start=call.start, end=call.end,
                              sense=call.sense, signal=call.signal)
            self.junctions[key] = agg
        agg.n_reads += 1
        agg.seqs.add(seq_hash(call.seq, self.cfg.max_read_len))
        uniq = self.cfg.min_uniq_qual
        if call.qual_left >= uniq and call.qual_right >= uniq:
            agg.uniq_bridges += 1
        agg.best_qual_left = max(agg.best_qual_left, call.qual_left)
        agg.best_qual_right = max(agg.best_qual_right, call.qual_right)
        agg.edits = min(agg.edits, call.edits)
        agg.overlap = min(agg.overlap, call.overlap)
        agg.n_bp = min(agg.n_bp, call.n_bp)
        if call.align_strand == call.sense:
            agg.n_strand_match += 1

    def _strandmatch(self, agg: JunctionAgg) -> str:
        if not self.cfg.stranded:
            return "NA"
        if agg.n_strand_match == agg.n_reads:
            return "MATCH"
        if agg.n_strand_match == 0:
            return "MISMATCH"
        return "PARTIAL"

    def _category(self, agg: JunctionAgg, strandmatch: str) -> str:
        return category_flags(agg.kind == KIND_CIRCULAR, agg.n_bp,
                              agg.uniq_bridges, agg.signal, strandmatch)

    def rows(self, sample_name: str = "sample", prefix: str = "") -> list[JunctionRow]:
        out = []
        for agg in self.junctions.values():
            chrom = self.genome.chrom_names[agg.chrom_idx]
            offset = int(self.genome.chrom_offsets[agg.chrom_idx])
            strandmatch = self._strandmatch(agg)
            out.append(JunctionRow(
                chrom=chrom,
                start=agg.start - offset,
                end=agg.end - offset,
                name="",  # assigned by renumber()
                n_reads=agg.n_reads,
                strand=SENSE_CHARS[agg.sense],
                n_uniq=len(agg.seqs),
                uniq_bridges=agg.uniq_bridges,
                best_qual_left=agg.best_qual_left,
                best_qual_right=agg.best_qual_right,
                tissues=sample_name,
                tiss_counts=str(agg.n_reads),
                edits=agg.edits,
                anchor_overlap=agg.overlap,
                breakpoints=agg.n_bp,
                signal=agg.signal,
                strandmatch=strandmatch,
                category=self._category(agg, strandmatch),
            ))
        self.stats.counts["circular_junctions"] = sum(
            1 for a in self.junctions.values() if a.kind == KIND_CIRCULAR)
        self.stats.counts["linear_junctions"] = sum(
            1 for a in self.junctions.values() if a.kind != KIND_CIRCULAR)
        return renumber(out, prefix)
