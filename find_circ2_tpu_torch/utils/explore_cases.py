"""Synthetic inputs of the §2b pair program (ops/explore.explore_pairs) at
its edges, made with numpy from a seed.

A case is a genome, chromosome offsets, reads and each anchor's K1
outputs (candidate_stats' count, first_pos and extras per strand slot):
everything explore_pairs takes but the hits, which finalize_hits derives
from count and first_pos. The first rows pin one edge each (see
`PINNED`); the rest mix them at random: junction reads cut from the
genome on either strand, decoy candidates past the genome's end (whose
windows clamp to one window, so their pairs tie), above 2^31 and next to
2^32 (where pB + a wraps), at chromosome starts; contiguous reads (the
§6 prefilter); candidates at the exact
or the 1-mismatch level, counts above the list (LARGE_POS lanes), one
position in two slots, anchors with no candidate; lengths 2a, 2a+1, 100,
Lp-1 and Lp. `pair_args` turns a case into explore_pairs' arguments.
`chip_smoke.py` holds the CUDA kernel against its plain version on a
case; the tests hold the plain version against the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from find_circ2_tpu_torch.config import RPAD_CODE, Config
from find_circ2_tpu_torch.ops.anchor_align import finalize_hits
from find_circ2_tpu_torch.ops.packed import pack_words

LARGE_POS = 0xFFFFFFFF
GENOME_BASES = 60_000
# Chromosome starts: the genome's codes cover the first two; the others
# hold only candidates past its end.
CHROM_OFFSETS = (0, 30_000, 2 ** 31 + 11, 3_000_000_000, 2 ** 32 - 100_000)
LENGTHS = (40, 41, 100, 159, 160)

# What each of the first rows pins.
PINNED = (
    "length 2a: one valid split, a '+' linear junction",
    "length Lp: a '-' circular junction",
    "no pair: anchor A's candidates all '+', anchor B's all '-'",
    "anchor B without a candidate",
    "16 candidates on both strands past the genome's end: every pair "
    "ties in edits; (pA, pB) decide",
    "one (pA, pB) on both strands and twice on '+': s, then row-major "
    "order decide",
    "positions next to 2^32: pB + a wraps; counts above the lists",
    "more than K candidates at the 1-mismatch level on each strand",
    "one slot with count above K",
    "a padding row: length 0, no candidate",
    "K candidates in each of the 60 1-mismatch slots of both strands",
    "a strand list of exactly K lanes (one exact slot), 16 viable pairs",
    "strand lists of 128 lanes, equal positions in both warps of a list",
    "strand lists of 129 lanes, the 129th the smallest position",
    "0 viable pairs: one strand and chromosome, the anchors overlap",
    "1 viable pair",
    "32 viable pairs",
    "33 viable pairs",
    "256 viable pairs",
    "a tie on the whole pair key, decided only by row-major order",
)
# The viable pairs (i, j) of each pinned row that pins their number.
PINNED_PAIRS = {11: 16, 14: 0, 15: 1, 16: 32, 17: 33, 18: 256}
# The lanes at the best level of anchor A's '+' list, where pinned.
PINNED_LANES = {11: 16, 12: 128, 13: 129}


@dataclass
class ExploreCase:
    codes: np.ndarray          # uint8 [GENOME_BASES] genome codes
    chrom_offsets: np.ndarray  # int64 [5]
    reads: np.ndarray          # uint8 [B, Lp], RPAD past each length
    lens: np.ndarray           # int32 [B]
    count: list                # per anchor, int32 [B, 2V]
    first_pos: list            # per anchor, int64 [B, 2V] (uint32 values)
    extras: list               # per anchor, int64 [B, 2V, K-1]
    mm_v: np.ndarray           # int32 [2V]


class _Rows:
    """K1 outputs under construction, both anchors."""

    def __init__(self, B: int, cfg: Config) -> None:
        self.K = cfg.max_pair_hits
        self.V = 1 + 3 * cfg.anchor_len
        V2 = 2 * self.V
        self.count = [np.zeros((B, V2), np.int32) for _ in range(2)]
        self.first = [np.full((B, V2), LARGE_POS, np.int64)
                      for _ in range(2)]
        self.extras = [np.full((B, V2, self.K - 1), LARGE_POS, np.int64)
                       for _ in range(2)]

    def slot(self, anchor: int, b: int, slot: int, positions,
             count: int | None = None) -> None:
        """One strand slot's hit list (ascending, first K kept) and its
        count (default: the list's length)."""
        pos = sorted(int(p) for p in positions)[:self.K]
        self.count[anchor][b, slot] = len(pos) if count is None else count
        if pos:
            self.first[anchor][b, slot] = pos[0]
            self.extras[anchor][b, slot, :len(pos) - 1] = pos[1:]

    def put(self, rng, anchor: int, b: int, cands, level: int) -> None:
        """(strand, position) candidates into the strand's exact slot
        (level 0) or spread over random 1-mismatch slots (level 1)."""
        for strand in (0, 1):
            pos = [p for s, p in cands if s == strand]
            if not pos:
                continue
            base = strand * self.V
            if level == 0:
                self.slot(anchor, b, base, pos)
                continue
            groups = rng.integers(0, min(len(pos), 6), len(pos))
            slots = base + 1 + rng.choice(self.V - 1, 6, replace=False)
            for g in range(6):
                part = [p for p, x in zip(pos, groups) if x == g]
                if part:
                    self.slot(anchor, b, int(slots[g]), part)


def _revcomp(seq: np.ndarray) -> np.ndarray:
    r = seq[::-1].copy()
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def _palindrome(rng, L: int) -> np.ndarray:
    """A read of even length L equal to its own reverse complement."""
    half = rng.integers(0, 4, L // 2).astype(np.uint8)
    return np.concatenate([half, _revcomp(half)])


def _junction(rng, codes, L: int, a: int, circular: bool,
              same_chrom: bool = True):
    """A read of length L joining G[pA : pA+k] to the L-k bases that end
    at pB + a, and its anchors' '+' positions (pA, pB): on one of the
    genome's two chromosomes, or on either."""
    k = int(rng.integers(a, L - a + 1))
    lo, hi = 200, GENOME_BASES - 400
    if same_chrom:
        mid = CHROM_OFFSETS[1]
        lo, hi = (lo, mid - 400) if rng.random() < 0.5 else (mid + 200, hi)
    while True:
        pA, pB = (int(x) for x in rng.integers(lo, hi, 2))
        if (circular and pB + a <= pA) or (not circular
                                           and pB - pA > L + 5):
            break
    read = np.concatenate([codes[pA:pA + k],
                           codes[pB + a - (L - k):pB + a]])
    return read, pA, pB


def _decoys(rng, n: int, Lp: int) -> list[int]:
    """n positions from the pools the pair program must get right."""
    pools = (
        lambda: rng.integers(0, GENOME_BASES - Lp),
        lambda: rng.integers(GENOME_BASES, 2 ** 31),
        lambda: rng.integers(2 ** 31, 2 ** 32 - 1),
        lambda: 2 ** 32 - 1 - rng.integers(1, 400),
        lambda: CHROM_OFFSETS[rng.integers(1, len(CHROM_OFFSETS))]
        + rng.integers(-30, 30),
    )
    return [int(pools[rng.integers(len(pools))]()) for _ in range(n)]


def explore_case(seed: int, B: int, cfg: Config = Config()) -> ExploreCase:
    """B >= len(PINNED) reads: the pinned rows, then random ones."""
    if B < len(PINNED):
        raise ValueError(f"explore_case needs B >= {len(PINNED)}")
    rng = np.random.default_rng(seed)
    a, Lp, K = cfg.anchor_len, cfg.max_read_len, cfg.max_pair_hits
    codes = rng.integers(0, 4, GENOME_BASES).astype(np.uint8)
    codes[rng.random(GENOME_BASES) < 0.002] = 4
    reads = np.full((B, Lp), RPAD_CODE, np.uint8)
    lens = np.zeros(B, np.int32)
    rows = _Rows(B, cfg)

    def set_read(b, seq):
        reads[b, :len(seq)] = seq
        lens[b] = len(seq)

    # 0: length 2a, '+' linear junction plus decoys.
    seq, pA, pB = _junction(rng, codes, 2 * a, a, circular=False)
    set_read(0, seq)
    rows.put(rng, 0, 0, [(0, pA)] + [(0, p) for p in _decoys(rng, 5, Lp)], 0)
    rows.put(rng, 1, 0, [(0, pB), (1, 1234)], 0)
    # 1: length Lp, a '-' circular junction (the read's reverse
    # complement): A at the '+' pB, B at the '+' pA, both '-'.
    seq, pA, pB = _junction(rng, codes, Lp, a, circular=True)
    set_read(1, _revcomp(seq))
    rows.put(rng, 0, 1, [(1, pB), (0, 77)], 0)
    rows.put(rng, 1, 1, [(1, pA)] + [(1, p) for p in _decoys(rng, 4, Lp)],
             0)
    # 2: no pair on a common strand.
    seq, pA, pB = _junction(rng, codes, 100, a, circular=False)
    set_read(2, seq)
    rows.put(rng, 0, 2, [(0, pA), (0, pA + 999)], 0)
    rows.put(rng, 1, 2, [(1, pB), (1, pB + 7)], 0)
    # 3: anchor B has no candidate.
    seq, pA, pB = _junction(rng, codes, 120, a, circular=False)
    set_read(3, seq)
    rows.put(rng, 0, 3, [(0, pA), (1, pB)], 0)
    # 4: 8 + 8 candidates per anchor past the genome's end, one
    # chromosome: all windows are the clamped last window, and the read is
    # its own reverse complement, so '+' and '-' pairs score alike.
    set_read(4, _palindrome(rng, 120))
    base = CHROM_OFFSETS[3] + 5000
    rows.put(rng, 0, 4, [(s, base + 1000 * i + 7 * s) for s in (0, 1)
                         for i in range(8)], 0)
    rows.put(rng, 1, 4, [(s, base + 400_000 + 1000 * i + 3 * s)
                         for s in (0, 1) for i in range(8)], 0)
    # 5: at the 1-mismatch level, past the genome's end, A '+' {p} in two
    # slots and '-' {q}; B '+' {q} and '-' {p}: the '+' pair (p, q) twice,
    # the '-' pair (p, q) once, all alike (a self-complementary read).
    set_read(5, _palindrome(rng, 90))
    p, q = CHROM_OFFSETS[2] + 900, CHROM_OFFSETS[2] + 5000
    V = rows.V
    rows.slot(0, 5, 3, [p])
    rows.slot(0, 5, 9, [p])
    rows.slot(0, 5, V + 4, [q])
    rows.slot(1, 5, 2, [q])
    rows.slot(1, 5, V + 5, [p])
    # 6: next to 2^32, counts above the lists (LARGE_POS lanes).
    seq, pA, pB = _junction(rng, codes, 159, a, circular=False)
    set_read(6, seq)
    top = 2 ** 32 - 1
    rows.slot(0, 6, 0, [top - 300, top - 120], count=5)
    rows.slot(0, 6, V, [top - 250], count=3)
    rows.slot(1, 6, 0, [top - 10, top - 2, pB], count=4)
    rows.slot(1, 6, V, [top - 60, top - 40])
    # 7: more than K candidates at the 1-mismatch level per strand.
    seq, pA, pB = _junction(rng, codes, 41, a, circular=False)
    set_read(7, seq)
    for anchor, true in ((0, pA), (1, pB)):
        pos = _decoys(rng, 40, Lp) + [true]
        rows.put(rng, anchor, 7, [(int(rng.integers(2)), x) for x in pos],
                 1)
    # 8: one slot whose count exceeds K.
    seq, pA, pB = _junction(rng, codes, 159, a, circular=True)
    set_read(8, seq)
    rows.slot(0, 8, 0, [pA] + _decoys(rng, K - 1, Lp), count=40)
    rows.slot(1, 8, 0, [pB] + _decoys(rng, 3, Lp))
    # 9: padding: length 0, nothing.
    # 10: every 1-mismatch slot full, both anchors and strands (as at a
    # high-copy repeat whose exact 20-mer is over the max_bucket guard).
    seq, pA, pB = _junction(rng, codes, 100, a, circular=False)
    set_read(10, seq)
    for anchor, true in ((0, pA), (1, pB)):
        for slot in (*range(1, V), *range(V + 1, 2 * V)):
            pos = _decoys(rng, K, Lp)
            if slot == 7:
                pos[0] = true
            rows.slot(anchor, 10, slot, pos, count=int(rng.integers(K, 40)))
    # 11-19: positions on the first chromosome, the two anchors' at least
    # 50 apart unless pinned otherwise (so every pair on one strand is
    # viable), under junction reads of length 100.
    for b in range(11, 20):
        set_read(b, _junction(rng, codes, 100, a, circular=False)[0])

    def run(start, n):
        return [start + 100 * i for i in range(n)]
    # 11: an exact slot of K lanes.
    rows.slot(0, 11, 0, run(1000, K))
    rows.slot(1, 11, 0, [1050])
    # 12: 8 one-mismatch slots of K lanes per list. A list's entries go
    # to its two warps 32 at a time (two slots), so slots 1 and 3 lie in
    # different warps; they hold the same, smallest positions.
    small = run(1000, K)
    for s in range(1, 9):
        pos = small if s in (1, 3) else run(5000 + 2000 * s, K)
        rows.slot(0, 12, s, pos)
        rows.slot(1, 12, V + s, small if s in (1, 3) else run(
            25000 - 1000 * s, K))
    rows.slot(1, 12, 2, run(1050, K))
    # 13: 8 slots of K lanes and one more lane, the smallest position.
    for s in range(1, 9):
        rows.slot(0, 13, s, run(2000 + 2000 * s, K))
    rows.slot(0, 13, 9, [500])
    rows.slot(1, 13, 1, [550, 3050, 9050])
    # 14-18: A's and B's '+' lists of n and m positions at the exact
    # level: n * m viable pairs, or none where the anchors overlap.
    rows.slot(0, 14, 0, [3000])
    rows.slot(1, 14, 0, [3005])
    for b, (n, m) in zip((15, 16, 17, 18), ((1, 1), (16, 2), (11, 3),
                                            (16, 16))):
        rows.slot(0, b, 0, run(4000, n))
        rows.slot(1, b, 0, run(6050, m))
    # 19: A's one position in two 1-mismatch slots, B's one: pairs (0, 0)
    # and (1, 0) tie on (edits, !c+, !c-, pA, pB, s).
    rows.slot(0, 19, 1, [6000])
    rows.slot(0, 19, 2, [6000])
    rows.slot(1, 19, 1, [9000])

    for b in range(len(PINNED), B):
        L = int(LENGTHS[b % len(LENGTHS)] if rng.random() < 0.5
                else rng.integers(2 * a, Lp + 1))
        if rng.random() < 0.1:
            # Contiguous: the §6 prefilter's read; its one pair overlaps.
            pA = int(rng.integers(200, GENOME_BASES - 400))
            seq, pB = codes[pA:pA + L].copy(), pA + L - a
        else:
            seq, pA, pB = _junction(rng, codes, L, a,
                                    circular=bool(rng.random() < 0.5),
                                    same_chrom=bool(rng.random() < 0.9))
            seq = seq.copy()
        hits = rng.integers(0, L, int(rng.integers(0, 4)))
        seq[hits] = rng.integers(0, 5, hits.size)
        minus = bool(rng.random() < 0.5)
        if minus:
            set_read(b, _revcomp(seq))
            true = [(1, pB)], [(1, pA)]
        else:
            set_read(b, seq)
            true = [(0, pA)], [(0, pB)]
        for anchor in (0, 1):
            if rng.random() < 0.08:
                continue                      # no candidate at all
            cands = [] if rng.random() < 0.1 else list(true[anchor])
            cands += [(int(rng.integers(2)), p)
                      for p in _decoys(rng, int(rng.integers(0, 20)), Lp)]
            if cands and rng.random() < 0.2:
                cands.append(cands[int(rng.integers(len(cands)))])
            rows.put(rng, anchor, b, cands, int(rng.random() < 0.35))
            if rng.random() < 0.15:
                c = rows.count[anchor][b]
                slot = int(rng.integers(c.size))
                if c[slot] > 0:
                    c[slot] += int(rng.integers(1, 30))
    for anchor in (0, 1):
        np.minimum(rows.count[anchor], cfg.max_bucket,
                   out=rows.count[anchor])
    mm_v = np.ones(2 * rows.V, np.int32)
    mm_v[[0, rows.V]] = 0
    return ExploreCase(codes=codes,
                       chrom_offsets=np.array(CHROM_OFFSETS, np.int64),
                       reads=reads, lens=lens, count=rows.count,
                       first_pos=rows.first, extras=rows.extras, mm_v=mm_v)


def pair_args(case: ExploreCase, cfg: Config = Config(),
              device="cpu") -> tuple:
    """explore_pairs' arguments before `cfg` for a case, on `device`: the
    hits are finalize_hits of each anchor's count and first_pos."""
    def dev(x):
        return torch.from_numpy(x).to(device)
    stats = [tuple(dev(x[i]) for x in (case.count, case.first_pos,
                                       case.extras)) for i in (0, 1)]
    mm_v = dev(case.mm_v)
    strand_v = torch.arange(2, dtype=torch.int32, device=device
                            ).repeat_interleave(mm_v.shape[0] // 2)
    hits = [finalize_hits(c, f, mm_v, strand_v, cfg) for c, f, _ in stats]
    return (dev(pack_words(case.codes)), len(case.codes),
            dev(case.chrom_offsets), dev(case.reads), dev(case.lens),
            *stats, *hits, mm_v)
