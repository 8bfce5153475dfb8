"""Junction aggregation, category flags, and BED table construction.

Host-side, shared by the CPU oracle and the device path — per-read
`ReadCall` records and device result rows flow in, the BED table's
columns (`JunctionRows`) flow out. Semantics: SPEC.md §5 / SURVEY.md
§3.5 (one pass over every junction read at EOF). The table stays
columnar from the buffered reads to the BED's lines: one sort in the
BED's own order, reductions by segment.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from find_circ2_tpu_torch.config import (
    Config,
    KIND_CIRCULAR,
    SENSE_CHARS,
    SENSE_MINUS,
    SENSE_PLUS,
    ST_JUNCTION,
    STATUS_NAMES,
)
from find_circ2_tpu_torch.io.bed import JunctionRows
from find_circ2_tpu_torch.io.genome import Genome
from find_circ2_tpu_torch.io.twobit import _BASE_LUT
from find_circ2_tpu_torch.models.oracle import ReadCall
from find_circ2_tpu_torch.utils.profiling import count, span


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


def category_table() -> np.ndarray:
    """The 32 categories by code: a junction's category is a function of
    five tests, bit 4 circular, 3 one breakpoint, 2 a unique bridge, 1
    signal GTAG, 0 strandmatch MATCH. Built by category_flags itself,
    which stays the single source of truth."""
    return np.array([
        category_flags(bool(c & 16), 1 if c & 8 else 2, 1 if c & 4 else 0,
                       "GTAG" if c & 2 else "", "MATCH" if c & 1 else "")
        for c in range(32)], dtype=object)


# Strandmatch by code: all reads on the junction's sense, none, some;
# "NA" when the library is not stranded.
STRANDMATCH = np.array(["MATCH", "MISMATCH", "PARTIAL", "NA"], dtype=object)
STRANDS = np.array([SENSE_CHARS[SENSE_PLUS], SENSE_CHARS[SENSE_MINUS]],
                   dtype=object)

# The table's one sort (chromosome name, start, end, sense, circular
# first) is io/bed.renumber's (chrom, start, end, strand, category) only
# while '+' sorts before '-' and every circular category before every
# linear one; start and end differ from the BED's by one offset a
# chromosome.
assert STRANDS[0] < STRANDS[1]
assert max(category_table()[16:]) < min(category_table()[:16])


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
# `n_uniq` counts DISTINCT processed read sequences per junction. Both
# aggregation paths identify a sequence by the same deterministic 64-bit
# hash of its RPAD-padded code vector (dot product with fixed odd
# weights mod 2^64) instead of the string itself: the vectorized batch
# path then hashes a whole encoded batch in one numpy op. Identical
# values on the per-read and batch paths by construction; a collision
# (~n^2 / 2^64) would undercount n_uniq by 1.
_SEQ_W: dict[int, "np.ndarray"] = {}


def _seq_weights(Lp: int):
    w = _SEQ_W.get(Lp)
    if w is None:
        rng = np.random.default_rng(0xF1FC2)
        w = rng.integers(1, 2 ** 63, Lp, dtype=np.uint64) | np.uint64(1)
        _SEQ_W[Lp] = w
    return w


def seq_hash(seq: str, Lp: int) -> int:
    """Hash of one processed read sequence (scalar path)."""
    from find_circ2_tpu_torch.config import RPAD_CODE
    from find_circ2_tpu_torch.io.twobit import seq_to_codes
    codes = np.full(Lp, RPAD_CODE, np.uint8)
    c = seq_to_codes(seq)
    codes[:c.size] = c
    return int((codes.astype(np.uint64) * _seq_weights(Lp))
               .sum(dtype=np.uint64))


def seq_hash_batch(arr: "np.ndarray"):
    """Hashes of an RPAD-padded encoded batch (uint8 [n, Lp])."""
    w = _seq_weights(arr.shape[1])
    return (arr.astype(np.uint64) * w[None, :]).sum(axis=1,
                                                    dtype=np.uint64)


# The columns of a buffered junction read and their types, in the order
# `add` keeps them: the junction key, the evidence, the signal's 4 ASCII
# bytes and the read's seq_hash.
COLUMNS = {**dict.fromkeys(("kind", "chrom", "start", "end", "sense", "ql",
                            "qr", "e", "o", "b", "smatch"), np.int64),
           "signal": np.dtype("S4"), "hash": np.uint64}


class Aggregator:
    """Accumulates junction reads, as ReadCalls (`add`) or device result
    rows (`add_batch`), into one buffer of read columns; `table` groups
    them by junction once, at the end."""

    def __init__(self, genome: Genome, cfg: Config = Config()) -> None:
        self.genome = genome
        self.cfg = cfg
        self.stats = Stats()
        self._chunks: list[dict] = []     # read columns (add_batch, merges)
        self._calls: list[tuple] = []     # add's COLUMNS

    def add(self, call: ReadCall) -> None:
        self.stats.add("reads_total")
        self.stats.add_status(call.status)
        if call.status != ST_JUNCTION:
            return
        self.stats.add("circular_reads" if call.kind == KIND_CIRCULAR
                       else "linear_reads")
        self._calls.append((
            call.kind, call.chrom_idx, call.start, call.end, call.sense,
            call.qual_left, call.qual_right, call.edits, call.overlap,
            call.n_bp, int(call.align_strand == call.sense), call.signal,
            seq_hash(call.seq, self.cfg.max_read_len)))

    def add_batch(self, res: dict, idx, seq_hashes) -> None:
        """Vectorized twin of `add` for unpacked device result rows.

        `res` is pipeline.unpack_results output, `idx` the row indices
        to aggregate (all must have status == ST_JUNCTION), `seq_hashes`
        the `seq_hash_batch` values aligned with `idx`. The rows' columns
        are buffered beside `add`'s; `table` groups every buffered read
        at once, so the result equals looping `add` (every reduction is
        commutative, and `signal` is a pure function of the junction
        key)."""
        n = len(idx)
        if n == 0:
            return
        self.stats.add("reads_total", n)
        self.stats.add_status(ST_JUNCTION, n)
        kind = res["kind"][idx]
        n_circ = int((kind == KIND_CIRCULAR).sum())
        if n_circ:
            self.stats.add("circular_reads", n_circ)
        if n - n_circ:
            self.stats.add("linear_reads", n - n_circ)
        sense = res["sense"][idx]
        self._chunks.append(dict(
            kind=kind, chrom=res["chrom"][idx], start=res["start"][idx],
            end=res["end"][idx], sense=sense, ql=res["qual_left"][idx],
            qr=res["qual_right"][idx], e=res["edits"][idx],
            o=res["overlap"][idx], b=res["n_bp"][idx],
            smatch=sense == res["align_strand"][idx],
            signal=_BASE_LUT[res["signal"][idx]].view("S4")[:, 0],
            hash=np.asarray(seq_hashes, np.uint64)))

    def read_columns(self) -> dict:
        """Every junction read buffered so far, `add`'s included, as one
        dict of COLUMNS: what a process of a --nproc run hands to process
        0's `merge_from`."""
        if self._calls:
            self._chunks.append({f: np.array(c, t) for (f, t), c in
                                 zip(COLUMNS.items(), zip(*self._calls))})
            self._calls = []
        chunks = self._chunks
        if len(chunks) != 1 or any(chunks[0][f].dtype != t
                                   for f, t in COLUMNS.items()):
            self._chunks = [{
                f: np.concatenate([np.zeros(0, t)] + [c[f] for c in chunks])
                .astype(t, copy=False) for f, t in COLUMNS.items()}]
        return self._chunks[0]

    def merge_from(self, reads: dict) -> None:
        """Fold another process's junction reads (its `read_columns`)
        into this table — the final cross-host merge of a multi-process
        run (SURVEY.md §2.4 DP row). `table` groups all reads at once, so
        the result equals a joint single-process run bit for bit,
        n_uniq included (the sequence hashes of a junction are
        deduplicated over every process's reads)."""
        self._chunks.append(reads)

    def table(self) -> dict:
        """The junction table: one entry a junction in the BED's order
        (chromosome name, start, end, strand, circular before linear),
        each a column over the junctions: the key (`kind`, `chrom`,
        global `start` and `end`, `sense`), `signal` ('S4'), and the
        evidence `n_reads`, `n_uniq`, `uniq_bridges`, `best_qual_left`,
        `best_qual_right`, `edits`, `overlap`, `n_bp`, `n_strand_match`.
        Counts the reads it groups (`reads`) and the junctions
        (`junctions`) under the current span."""
        r = self.read_columns()
        N = r["kind"].size
        count("reads", N)
        names = self.genome.chrom_names
        rank = np.empty(len(names), np.int64)
        rank[sorted(range(len(names)), key=names.__getitem__)] = \
            np.arange(len(names))
        # One stable sort on two int64 words: (name rank, start) and
        # (end, sense, linear); rank < 2^28, global start and end < 2^33.
        k1 = (rank[r["chrom"]] << 33) | r["start"]
        k2 = (r["end"] << 2) | (r["sense"] << 1) | (r["kind"]
                                                     != KIND_CIRCULAR)
        order = np.lexsort((k2, k1))
        k1, k2 = k1[order], k2[order]
        newg = np.ones(N, bool)
        newg[1:] = (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
        heads = np.flatnonzero(newg)
        G = heads.size
        count("junctions", G)
        first = order[heads]
        t = {f: r[f][first] for f in ("kind", "chrom", "start", "end",
                                      "sense", "signal")}
        t["n_reads"] = np.diff(heads, append=N)

        def seg(ufunc, v):
            return ufunc.reduceat(v[order], heads)

        uniq = self.cfg.min_uniq_qual
        t["uniq_bridges"] = seg(np.add, ((r["ql"] >= uniq)
                                         & (r["qr"] >= uniq)).astype(np.int64))
        t["n_strand_match"] = seg(np.add, r["smatch"])
        # The per-call reductions start from 0 (maxima) and 2^30 (minima).
        t["best_qual_left"] = np.maximum(seg(np.maximum, r["ql"]), 0)
        t["best_qual_right"] = np.maximum(seg(np.maximum, r["qr"]), 0)
        for f, v in (("edits", "e"), ("overlap", "o"), ("n_bp", "b")):
            t[f] = np.minimum(seg(np.minimum, r[v]), 1 << 30)
        # Distinct sequences a junction: the reads sorted by (junction,
        # hash), one count a new pair.
        gid = np.cumsum(newg) - 1
        h = r["hash"][order]
        po = np.lexsort((h, gid))
        gs, hs = gid[po], h[po]
        newp = np.ones(N, bool)
        newp[1:] = (gs[1:] != gs[:-1]) | (hs[1:] != hs[:-1])
        t["n_uniq"] = np.bincount(gs[newp], minlength=G)
        return t

    def rows(self, sample_name: str = "sample",
             prefix: str = "") -> JunctionRows:
        """The BED table as columns (`JunctionRows`); its `JunctionRow`s
        are built only if a caller asks for one."""
        with span("drain"):
            t = self.table()
        circ = t["kind"] == KIND_CIRCULAR
        with span("renumber"):
            # <prefix>circ_<i:06d> and <prefix>norm_<i:06d>, counted in
            # the table's order (SPEC.md §5).
            nth = np.where(circ, np.cumsum(circ), np.cumsum(~circ))
            cname, nname = f"{prefix}circ_", f"{prefix}norm_"
            names = [f"{cname if c else nname}{i:06d}"
                     for c, i in zip(circ.tolist(), nth.tolist())]
        with span("build"):
            n_reads, n_sm = t["n_reads"], t["n_strand_match"]
            if self.cfg.stranded:
                sm = np.where(n_sm == n_reads, 0, np.where(n_sm == 0, 1, 2))
            else:
                sm = np.full(n_reads.size, 3)
            code = ((circ << 4) | ((t["n_bp"] == 1) << 3)
                    | ((t["uniq_bridges"] >= 1) << 2)
                    | ((t["signal"] == b"GTAG") << 1) | (sm == 0))
            chrom = t["chrom"]
            offset = self.genome.chrom_offsets[chrom]
            n_l = n_reads.tolist()
            # BED_COLUMNS in their order (io/bed.py).
            out = JunctionRows([
                np.array(self.genome.chrom_names, object)[chrom].tolist(),
                (t["start"] - offset).tolist(), (t["end"] - offset).tolist(),
                names, n_l, STRANDS[t["sense"]].tolist(),
                t["n_uniq"].tolist(), t["uniq_bridges"].tolist(),
                t["best_qual_left"].tolist(), t["best_qual_right"].tolist(),
                [sample_name] * len(n_l), list(map(str, n_l)),
                t["edits"].tolist(), t["overlap"].tolist(),
                t["n_bp"].tolist(), t["signal"].astype("U4").tolist(),
                STRANDMATCH[sm].tolist(), category_table()[code].tolist()])
            n_circ = int(circ.sum())
            self.stats.counts["circular_junctions"] = n_circ
            self.stats.counts["linear_junctions"] = len(out) - n_circ
        return out
