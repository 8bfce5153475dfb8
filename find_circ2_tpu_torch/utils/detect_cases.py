"""Synthetic inputs of detect's core (ops/detect.detect_core_packed), of
K1 v4's exact-first probe (ops/anchor_align.exact_anchor_stats) and of
the classic enumeration (ops/anchor_align.classic_anchor_stats, with the
§2b extras, and the fallback slice) at their edges, made with numpy from
a seed.

A case is a two-chromosome genome with its query and neighbour tables
and §2b extras (the port's numpy builders), a batch of reads with their
reverse complements, each anchor's hits, and a set of anchors for the
probe and the enumeration.
The hits are K1 v4's (the plain exact_anchor_stats with its enumeration
fallback) except on the first rows, which pin one edge each (see
`PINNED`), with hits written out where K1 could not give them. The other
rows mix junction reads cut from the genome on either strand (with
mismatches and N), contiguous reads (the §6 prefilter), random reads
(unaligned anchors), reads anchored in a 20-mer planted more often than
max_bucket, lengths 2a to Lp, and padding rows (length 0). The probe's
anchors are the reads' anchors followed by `PINNED_ANCHORS` (two of
them keys put into the table, whose two buckets coincide), then the
anchors of the table's own such keys. `core_args`, `exact_args`
and `classic_args` turn a case into the functions' arguments.
`chip_smoke.py` holds the CUDA kernels against their plain versions on a
case; the tests hold the plain versions against the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from find_circ2_tpu_torch.config import RPAD_CODE, Config
from find_circ2_tpu_torch.index.build import build_index
from find_circ2_tpu_torch.index.hashtable import (CNT_BITS, EMPTY_KEY,
                                                  LANES, S8_MASK, SLOTS,
                                                  build_neighbor_table,
                                                  build_query_table,
                                                  mix_hash,
                                                  shard_neighbor_tables,
                                                  shard_query_table)
from find_circ2_tpu_torch.io.genome import Genome
from find_circ2_tpu_torch.models.pipeline import revcomp_batch
from find_circ2_tpu_torch.ops.anchor_align import (AnchorHits, Shard,
                                                   _exact_keys,
                                                   align_anchor_pair_fast,
                                                   key_ranges, read_anchors)
from find_circ2_tpu_torch.ops.packed import pack_words

LARGE_POS = 0xFFFFFFFF
CHROM_BASES = 60_000
# A 20-mer planted more often than Config.max_bucket, and one planted
# more often than Config.max_pair_hits but not max_bucket.
REPEAT_COPIES = 80
HIT_COPIES = 30
_A, _C, _G, _T, _N = 0, 1, 2, 3, 4

# What each of the first rows of the batch pins.
PINNED = (
    "a padding row: length 0, every split invalid",
    "both anchors unaligned: position 2^32 - 1, the last chromosome",
    "anchor B '+' at position 5: its prefilter start and K2's right "
    "window start wrap below 0 and clamp to the top; chromosome -1",
    "a '+' linear junction at a planted GT..AG site: sense '+'",
    "a '-' circular junction at a planted CT..AC site: sense '-'",
    "a '+' junction read with N and mismatches",
    "anchor A unaligned with strand 2, B aligned: sense falls back to 2",
    "a contiguous read: prefiltered when the prefilter is on",
    "anchors on different strands",
    "anchors on different chromosomes",
    "anchors overlapping on the genome: neither geometry",
    "a linear pair whose junction ends before it starts",
    "positions next to 2^32: pB + a wraps, windows clamp to the top",
    "anchor A with n_best 3 (multi bit 0), anchor B unaligned (bit 1)",
    "a junction whose flanks repeat: several splits tie in score",
    "length 2a: one valid split",
    "length Lp at the genome's end: both windows clamp",
)
# What each of the pinned anchors appended after the reads' anchors
# pins.
PINNED_ANCHORS = (
    "present, with an A turned into N: not clean, found on its zeroed "
    "codes, resolved with empty statistics",
    "absent, with an N: not clean, not found, resolved",
    "the 20-mer planted more often than max_bucket: its exact count is "
    "guarded to 0",
    "the reverse complement of a present 20-mer: the canonical key swaps",
    "one substitution away from a present 20-mer: not found, unresolved",
    "random: absent, unresolved",
    "all N",
    "a 20-mer planted HIT_COPIES times: a slot whose count exceeds "
    "max_pair_hits, with a full ext row",
    "a key put into the table whose two buckets coincide: counted twice, "
    "its ext row id doubled past the last ext row (read as LARGE_POS)",
    "another such key, its ext row id 1 doubled to 2, inside the ext rows",
)
# Anchors appended after the coincident keys' ones: a present 20-mer
# with an N at the first position, at the last, at the prefix's last
# and at the suffix's first (dirty: zeroed codes, not clean, resolved).
DIRTY_AT = ("first", "last", "prefix's last", "suffix's first")

# What each edge row written over the random rows of an edge case pins
# (detect_case's `n_chroms` > 2), from row len(PINNED) on.
CHROM_PINNED = (
    "both anchors on the last chromosome",
    "anchor A on a chromosome's first base, B on the base before it: "
    "different chromosomes",
    "anchor A on the first chromosome's first base, B on the last "
    "chromosome",
    "anchor A on the last chromosome's first base, B on the genome's "
    "last base",
)
# The cases beside the default one, each for the kernels' paths that it
# does not reach: name -> (what it pins, Config changes, detect_case
# options).
EDGE_CASES = {
    "long-rows": ("max_read_len 301, not a multiple of 8 and above 256: "
                  "the split loop takes several rounds, the rows are off "
                  "4 bytes, and the last row, of length Lp, ends on the "
                  "buffer's last byte",
                  dict(max_read_len=301), dict(last_full=True)),
    "many-chroms": ("40 chromosomes: anchors on the first and the last, "
                    "on a chromosome's first base and the base before it "
                    "(CHROM_PINNED)", {}, dict(n_chroms=40)),
    "anchor-18": ("anchor_len 18: the probe reads its anchors byte by "
                  "byte", dict(anchor_len=18), {}),
    "anchor-16": ("anchor_len 16: the probe reads its anchors as four "
                  "words", dict(anchor_len=16), {}),
}
SMALL_CHROM = 1500


@dataclass
class DetectCase:
    genome: Genome
    table: np.ndarray      # int32 [T, 8] cuckoo table
    ntable: np.ndarray     # int32 [T, 8] neighbour table
    meta: np.ndarray       # int32 [3]
    ext: np.ndarray        # int32 [R, 2 (K-1)] §2b extras, uint32 bits
    ext_id: np.ndarray     # int32 [T, 2] ext row of each slot
    reads: np.ndarray      # uint8 [B, Lp], RPAD past each length
    lens: np.ndarray       # int32 [B]
    rc: np.ndarray         # uint8 [B, Lp] revcomp_batch's, for the reference
    hits: list             # per anchor, {AnchorHits field: numpy [B]}
    anchors: np.ndarray    # uint8 [n, a] for the probe
    coincident: int        # anchors of keys whose two buckets coincide


def _revcomp(seq: np.ndarray) -> np.ndarray:
    r = seq[::-1].copy()
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def _hit(a, pos, strand, aligned=True, mm=0, n_best=1):
    """One anchor's hit fields as finalize_hits would give them for
    anchors of length a: a hit at the best level of n_best (or none)."""
    if not aligned:
        return dict(aligned=False, pos=LARGE_POS, strand=2, mm=255,
                    n_best=0, second_mm=a + 1, qual=10 * (a + 1 - 255))
    second = mm if n_best > 1 else a + 1
    return dict(aligned=True, pos=pos, strand=strand, mm=mm, n_best=n_best,
                second_mm=second,
                qual=0 if n_best > 1 else min(10 * (second - mm), 40))


def edge_case(name: str, seed: int, B: int) -> tuple[DetectCase, Config]:
    """EDGE_CASES[name] at `seed` with B reads, and its Config."""
    _, changes, opts = EDGE_CASES[name]
    cfg = dataclasses.replace(Config(), **changes)
    return detect_case(seed, B, cfg, **opts), cfg


def detect_case(seed: int, B: int, cfg: Config = Config(),
                n_chroms: int = 2, last_full: bool = False) -> DetectCase:
    """B >= len(PINNED) reads: the pinned rows, then random ones. With
    n_chroms > 2 the genome has n_chroms - 2 more chromosomes of
    SMALL_CHROM bases and the rows after PINNED pin CHROM_PINNED; with
    `last_full` the last row is a junction read of length Lp. Either
    leaves every other row as it is."""
    need = (len(PINNED) + (len(CHROM_PINNED) if n_chroms > 2 else 0)
            + int(last_full))
    if B < need:
        raise ValueError(f"detect_case needs B >= {need}")
    rng = np.random.default_rng(seed)
    a, Lp = cfg.anchor_len, cfg.max_read_len
    chroms = [rng.integers(0, 4, CHROM_BASES).astype(np.uint8)
              for _ in range(2)]
    # The small chromosomes, from a generator of their own.
    chroms += list(np.random.default_rng([seed, 3]).integers(
        0, 4, (max(n_chroms - 2, 0), SMALL_CHROM)).astype(np.uint8))
    repeat = rng.integers(0, 4, a).astype(np.uint8)
    for p in rng.choice(CHROM_BASES // 100, REPEAT_COPIES,
                        replace=False) * 100 + 50:
        chroms[1][p:p + a] = repeat
    # Two 20-mers of more than max_pair_hits copies, from a generator of
    # their own, so that the reads stay those of the seed.
    many = np.random.default_rng([seed, 1]).integers(0, 4, (2, a)).astype(
        np.uint8)
    for p in (100 + np.arange(HIT_COPIES)) * 100:
        chroms[1][p + 5:p + 5 + a] = many[0]
        chroms[1][p + 75:p + 75 + a] = many[1]
    off = cfg.chrom_gap                       # chromosome 0's first base

    def cut(chrom, pA, k, pB, L):
        """A junction read G[pA : pA+k] + G[pB+a-(L-k) : pB+a] of
        chromosome-local positions; returns it and the global (pA, pB)."""
        c = chroms[chrom]
        read = np.concatenate([c[pA:pA + k], c[pB + a - (L - k):pB + a]])
        g = off + chrom * (CHROM_BASES + cfg.chrom_gap)
        return read, g + pA, g + pB

    # Planted splice sites (rows 3 and 4), before the index is built.
    c0 = chroms[0]
    c0[1000 + 50:1000 + 52] = (_G, _T)        # donor after G[1000:1050]
    c0[5000 + a - 50 - 2:5000 + a - 50] = (_A, _G)
    c0[20000 + 60:20000 + 62] = (_C, _T)
    c0[9000 + a - 100 - 2:9000 + a - 100] = (_A, _C)
    # Row 14: the right piece's first bases repeat after the left piece.
    c0[30000 + 40:30000 + 46] = c0[36000 + a - 60:36000 + a - 54]
    genome = Genome.from_records(
        [("chrA", chroms[0]), ("chrB", chroms[1])]
        + [(f"chr{c}", chroms[c]) for c in range(2, len(chroms))], cfg)
    index = build_index(genome, cfg)
    qt = index.qtable = build_query_table(index, cfg)
    ntable = build_neighbor_table(index, cfg)
    nbases = len(genome)

    reads = np.full((B, Lp), RPAD_CODE, np.uint8)
    lens = np.zeros(B, np.int32)
    pinned_hits: dict[int, tuple[dict, dict]] = {}

    def set_read(b, seq):
        reads[b, :len(seq)] = seq
        lens[b] = len(seq)

    # 0: padding. 1: random read, both anchors unaligned (written out).
    set_read(1, rng.integers(0, 4, 100).astype(np.uint8))
    pinned_hits[1] = (_hit(a, 0, 0, False), _hit(a, 0, 0, False))
    # 2: anchor B '+' at position 5 (before chromosome 0).
    seq, pA, _ = cut(0, 2000, 50, 2500, 100)
    set_read(2, seq)
    pinned_hits[2] = (_hit(a, pA, 0), _hit(a, 5, 0))
    # 3, 4: the planted splice sites, on '+' and (reverse complement) '-'.
    set_read(3, cut(0, 1000, 50, 5000, 100)[0])
    set_read(4, _revcomp(cut(0, 20000, 60, 9000, 160)[0]))
    # 5: N and mismatches in a '+' junction read.
    seq = cut(0, 12000, 70, 14000, 120)[0].copy()
    seq[[30, 75]] = _N
    seq[90] = (seq[90] + 1) % 4
    set_read(5, seq)
    # 6: A unaligned with strand 2, B aligned.
    seq, _, pB = cut(0, 3000, 50, 3600, 100)
    set_read(6, seq)
    pinned_hits[6] = (_hit(a, 0, 0, False), _hit(a, pB, 0))
    # 7: contiguous.
    set_read(7, c0[4000:4120].copy())
    # 8: different strands; 9: different chromosomes.
    seq, pA, pB = cut(0, 6000, 50, 6500, 100)
    set_read(8, seq)
    pinned_hits[8] = (_hit(a, pA, 0), _hit(a, pB, 1))
    seq, pA, _ = cut(0, 7000, 50, 7500, 100)
    set_read(9, seq)
    pinned_hits[9] = (_hit(a, pA, 0),
                      _hit(a, off + CHROM_BASES + cfg.chrom_gap + 700, 0))
    # 10: overlapping anchors; 11: a linear pair ending before it starts.
    seq, pA, _ = cut(0, 8000, 50, 8500, 100)
    set_read(10, seq)
    pinned_hits[10] = (_hit(a, pA, 0), _hit(a, pA + 5, 0))
    set_read(11, seq)
    pinned_hits[11] = (_hit(a, pA, 0), _hit(a, pA + a + 5, 0))
    # 12: next to 2^32.
    set_read(12, seq)
    pinned_hits[12] = (_hit(a, 2 ** 32 - 50, 0), _hit(a, 2 ** 32 - 10, 0))
    # 13: A multi, B unaligned.
    seq, pA, _ = cut(0, 10000, 50, 10600, 100)
    set_read(13, seq)
    pinned_hits[13] = (_hit(a, pA, 0, mm=0, n_best=3), _hit(a, 0, 0, False))
    # 14: repeated flanks; 15: length 2a; 16: length Lp at the end.
    set_read(14, cut(0, 30000, 40, 36000, 100)[0])
    set_read(15, cut(0, 15000, a, 16000, 2 * a)[0])
    seq, pA, pB = cut(1, CHROM_BASES - 150, 100, CHROM_BASES - 400, Lp)
    set_read(16, seq)
    pinned_hits[16] = (_hit(a, nbases - 60, 0), _hit(a, nbases - 30, 0))

    lengths = (2 * a, 2 * a + 1, 100, Lp - 1, Lp)
    for b in range(len(PINNED), B):
        L = int(lengths[b % 5] if rng.random() < 0.5
                else rng.integers(2 * a, Lp + 1))
        kind = rng.random()
        chrom = int(rng.integers(2))
        c = chroms[chrom]
        if kind < 0.05:
            continue                          # padding
        if kind < 0.15:
            seq = rng.integers(0, 4, L).astype(np.uint8)
        elif kind < 0.3:
            p = int(rng.integers(200, CHROM_BASES - 400))
            seq = c[p:p + L].copy()
        elif kind < 0.35:
            seq = np.concatenate([repeat, c[7000:7000 + L - a]])
        else:
            k = int(rng.integers(a, L - a + 1))
            while True:
                pA, pB = (int(x) for x in rng.integers(300, CHROM_BASES - 400,
                                                       2))
                if pB + a <= pA or pB - pA > L + 5:
                    break
            seq = np.concatenate([c[pA:pA + k],
                                  c[pB + a - (L - k):pB + a]])
        seq = seq.copy()
        errs = rng.integers(0, L, int(rng.integers(0, 4)))
        seq[errs] = rng.integers(0, 5, errs.size)
        set_read(b, _revcomp(seq) if rng.random() < 0.5 else seq)

    if last_full:
        set_read(B - 1, cut(0, 40000, 120, 45000, Lp)[0])
    if n_chroms > 2:
        starts = genome.chrom_offsets
        last = int(starts[-1])
        seq, pA, _ = cut(0, 6000, 50, 6500, 100)
        at = len(PINNED)
        for b, (pa, pb) in enumerate(((last + 100, last + 700),
                                      (int(starts[5]), int(starts[5]) - 1),
                                      (int(starts[0]), last + 300),
                                      (last, nbases - 1)), start=at):
            set_read(b, seq)
            pinned_hits[b] = (_hit(a, pa, 0), _hit(a, pb, 0))

    # K1 v4 (plain, on the CPU) for every row, then the written-out rows.
    anchors_a, anchors_b = read_anchors(torch.from_numpy(reads),
                                        torch.from_numpy(lens), cfg)
    hits_a, hits_b, _ = align_anchor_pair_fast(
        torch.from_numpy(qt.table), torch.from_numpy(ntable),
        torch.from_numpy(qt.meta), anchors_a, anchors_b, cfg)
    hits = [{f: getattr(h, f).numpy().copy() for f in AnchorHits._fields}
            for h in (hits_a, hits_b)]
    for b, pair in pinned_hits.items():
        for x in (0, 1):
            for f, v in pair[x].items():
                hits[x][f][b] = v

    # The probe's anchors: the reads', then the pinned ones, then those
    # of keys whose two buckets coincide.
    codes = genome.codes
    g0 = off + 3000
    dirty = codes[g0:g0 + a].copy()
    dirty[int(np.flatnonzero(dirty == _A)[0])] = _N
    absent = rng.integers(0, 4, a).astype(np.uint8)
    absent[3] = _N
    one_off = codes[g0 + 100:g0 + 100 + a].copy()
    one_off[7] = (one_off[7] + 2) % 4
    pinned = [dirty, absent, repeat.copy(),
              _revcomp(codes[g0 + 200:g0 + 200 + a]), one_off,
              rng.integers(0, 4, a).astype(np.uint8),
              np.full(a, _N, np.uint8)]
    tab = qt.table.reshape(-1, LANES)
    occ = np.flatnonzero(tab[:, 0] != EMPTY_KEY)
    salts = np.asarray(qt.meta[:2], np.int32).view(np.uint32)
    h1, h2 = (mix_hash(tab[occ, 0].astype(np.uint32),
                       (tab[occ, 1] & S8_MASK).astype(np.uint32),
                       s).astype(np.int64) % int(qt.meta[2]) for s in salts)
    co = occ[h1 == h2]
    pos = tab[co, 2:4].view(np.uint32).min(axis=1).astype(np.int64)
    same = [codes[p:p + a] for p in pos if p + a <= nbases]
    # Two keys put into the table whose buckets coincide, their ext row
    # ids doubled past the last row and inside the rows.
    ext = qt.ext.view(np.int32)
    table, ext_id = qt.table.copy(), qt.ext_id.copy()
    put = _put_coincident(table, ext_id, qt.meta, cfg,
                          np.random.default_rng([seed, 2]),
                          (ext.shape[0] - 1, 1), off)
    pinned += [many[0].copy(), *put]
    pk = cfg.prefix_len
    dirty_at = []
    for j in (0, a - 1, pk - 1, pk):
        d = codes[g0 + 300:g0 + 300 + a].copy()
        d[j] = _N
        dirty_at.append(d)
    anchors = np.concatenate([anchors_a.numpy(), anchors_b.numpy(),
                              np.stack(pinned + same + dirty_at)])
    return DetectCase(genome=genome, table=table, ntable=ntable,
                      meta=np.asarray(qt.meta[:3], np.int32), ext=ext,
                      ext_id=ext_id, reads=reads, lens=lens,
                      rc=revcomp_batch(reads, lens), hits=hits,
                      anchors=np.ascontiguousarray(anchors, np.uint8),
                      coincident=len(same) + len(put))


def _put_coincident(table, ext_id, meta, cfg: Config, rng, rids, off):
    """Put a key for each row id of `rids` into an empty slot of `table`
    (int32 [T, 8], in place): a random 20-mer whose two cuckoo buckets
    are one bucket, with counts 3 ('+') and 2 ('-') and positions near
    `off`; its `ext_id` slot gets the row id, its neighbour-table slot
    stays empty. Returns the keys' anchors."""
    tab = table.reshape(-1, SLOTS, LANES)
    salts = np.asarray(meta[:2], np.int32).view(np.uint32)
    anchors, used = [], set()
    while len(anchors) < len(rids):
        codes = rng.integers(0, 4, (1 << 16, cfg.anchor_len)).astype(
            np.uint8)
        _, _, cp, cs = (x.numpy().astype(np.uint32) for x in _exact_keys(
            torch.from_numpy(codes), cfg))
        h1, h2 = (mix_hash(cp, cs, s).astype(np.int64) % int(meta[2])
                  for s in salts)
        for i in np.flatnonzero(h1 == h2):
            rows = tab[h1[i]]
            free = np.flatnonzero(rows[:, 0] == EMPTY_KEY)
            if (not free.size or h1[i] in used
                    or len(anchors) == len(rids)):
                continue
            slot = free[0]
            rows[slot] = (int(cp[i]), int(cs[i]) | (3 << 16)
                          | (2 << (16 + CNT_BITS)), off + 11, off + 22)
            ext_id[h1[i], slot] = rids[len(anchors)]
            used.add(h1[i])
            anchors.append(codes[i])
    return anchors


def _hits(fields: dict, device) -> AnchorHits:
    return AnchorHits(*(torch.from_numpy(fields[f]).to(device)
                        for f in AnchorHits._fields))


def on_strand(case: DetectCase, strand: int) -> DetectCase:
    """The case with both anchors' hits on `strand` in every row: 1 puts
    every read's K2 and prefilter on its reverse complement, 0 on the
    read itself."""
    return dataclasses.replace(case, hits=[
        {**h, "strand": np.full_like(h["strand"], strand)}
        for h in case.hits])


def core_args(case: DetectCase, device="cpu", overflow=None) -> tuple:
    """detect_core_packed's arguments before `cfg` for a case, on
    `device`; `overflow` None or a bool for the 0-d flag."""
    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    flag = None if overflow is None else torch.tensor(overflow,
                                                      device=device)
    return (dev(pack_words(case.genome.codes)), len(case.genome),
            dev(case.genome.chrom_offsets), dev(case.reads), dev(case.lens),
            _hits(case.hits[0], device), _hits(case.hits[1], device), flag)


def exact_args(case: DetectCase, device="cpu", shift: int = 0) -> tuple:
    """exact_anchor_stats' arguments before `cfg` for a case, on `device`:
    (table, ntable, meta, anchors). `shift` adds to every stored position
    (the table's and the neighbour table's position lanes, LARGE_POS
    kept), wrapping mod 2^32, as a genome past 2^31 would store them."""
    table, ntable = case.table.copy(), case.ntable.copy()
    if shift:
        for t, lanes in ((table, (2, 3)), (ntable, (1, 3))):
            v = t.reshape(-1, 4)[:, lanes].view(np.uint32)
            moved = np.where(v == LARGE_POS, v,
                             (v.astype(np.uint64) + shift) % 2 ** 32)
            t.reshape(-1, 4)[:, lanes] = moved.astype(np.uint32).view(
                np.int32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return dev(table), dev(ntable), dev(case.meta), dev(case.anchors)


def classic_args(case: DetectCase, device="cpu") -> tuple:
    """classic_anchor_stats' tensors for a case, on `device`: (table,
    meta, anchors, ext, ext_id)."""
    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (dev(case.table), dev(case.meta), dev(case.anchors),
            dev(case.ext), dev(case.ext_id))


# The fallback slice's compaction (csrc/classic_k1.cu) at its edges:
# (n flags, unresolved, k), k None for the stream's
# min(exact_fallback_slots, n). The kernel gives each thread a run of
# 8-flag words: one word up to 8192 flags, more above, and more than the
# four it holds in registers above 32768; a word past n is partial.
SLICE_SIZES = (
    (8192, 0, None), (8192, 8192, None), (8192, 1024, None),
    (8192, 1025, None), (128, 37, None), (3000, 1500, None),
    (100, 37, None), (1001, 500, None), (8194, 3000, None),
    (8192, 4000, 0), (8192, 100, 8192), (3001, 3001, 3001),
    (777, 0, 777), (40001, 2000, None), (1, 1, 1),
)


def slice_id(n: int, unresolved: int, k) -> str:
    return f"{n}-{unresolved}" + ("" if k is None else f"-k{k}")


def slice_flags(n: int, unresolved: int, k, cfg: Config = Config(),
                lead: int = 0) -> tuple[np.ndarray, int]:
    """A SLICE_SIZES case: bool `resolved` [lead + n], its last n flags
    with `unresolved` of them False (seeded by the size), and its k."""
    rng = np.random.default_rng(n + unresolved + (k or 0))
    flags = np.ones(lead + n, bool)
    flags[lead + rng.choice(n, unresolved, replace=False)] = False
    return flags, min(cfg.exact_fallback_slots, n) if k is None else k


# The index shard counts of the sharded K1's checks (the CPU tests hold
# each against the JAX package on 8 virtual devices).
SHARD_COUNTS = (1, 2, 4, 8)


def shard_tables(case, counts=SHARD_COUNTS, cfg: Config = Config()) -> dict:
    """The case genome's index (a DetectCase's or a RangeCase's) carved
    into prefix-range shards as the sharded engine carves it
    (shard_query_table, and the neighbour table built once on the full
    table and relocated): {n_shards: (tables [S, T, 8], ntables [S, T,
    8], metas [S, 3])}, numpy int32; one shard is the whole table. The
    index is built anew from the genome, without a DetectCase's planted
    table edits (coincident buckets, doubled ext ids)."""
    index = build_index(case.genome, cfg)
    index.qtable = build_query_table(index, cfg, extras=False)
    index.qtable.ntable = build_neighbor_table(index, cfg)
    out = {}
    for n in counts:
        tables, metas = shard_query_table(index, n, cfg)
        out[n] = (tables, shard_neighbor_tables(index.qtable, tables), metas)
    return out


def shard_args(tables, ntables, metas, devices,
               cfg: Config = Config()) -> list:
    """Shards as the sharded K1 takes them (ops/anchor_align.Shard), shard
    i on devices[i] with the keys it owns (key_ranges over the index's
    4^prefix_len buckets, as shard_query_table cuts them)."""
    owns = key_ranges(4 ** cfg.prefix_len, len(devices))
    return [Shard(*(torch.from_numpy(np.ascontiguousarray(x[i])).to(dev)
                    for x in (tables, ntables, metas)), owns[i])
            for i, dev in enumerate(devices)]


def found_records(n: int, cf: int, cr: int, shards: int,
                  device="cpu") -> torch.Tensor:
    """`shards` index shards' exact records (ops/anchor_align.EXACT_OPS'
    fields, int32 [shards, n, 9]) of n anchors, each found with cf and cr
    exact hits on its canonical key's two orientations, no 1-mm ball and
    no position: the other shards' records of a combining call
    (exact_combine) whose summed exact counts pass max_bucket, or what
    one shard's packed count holds (1023)."""
    rec = torch.tensor([1, cf, -1, cr, -1, 0, -1, 0, -1], dtype=torch.int32)
    return rec.expand(shards, n, len(rec)).contiguous().to(device)


def range_edges(cfg: Config = Config()) -> list[int]:
    """Every cut between two shards' key ranges at SHARD_COUNTS
    (key_ranges over 4^prefix_len buckets): the first key of each range
    but the first."""
    nb = 4 ** cfg.prefix_len
    return sorted({r.lo for n in SHARD_COUNTS for r in key_ranges(nb, n)[1:]})


@dataclass
class RangeCase:
    genome: Genome
    anchors: np.ndarray    # uint8 [n, a]
    cp: np.ndarray         # int64 [n] canonical p12 of each anchor's key


# Anchors of each edge 20-mer (RANGE_KINDS in order): the 20-mer, its
# reverse complement, its planted 1-mm neighbour (first code moved on,
# its p12 in another range), and the 20-mer with an N first and last.
RANGE_KINDS = ("kmer", "revcomp", "neighbour", "N first", "N last")


def range_edge_case(seed: int, cfg: Config = Config()) -> RangeCase:
    """Keys at the edges of the shards' key ranges: for each cut e of
    range_edges, a 20-mer whose canonical p12 is e and one whose p12 is
    e - 1, each planted in a random chromosome with its 1-mm neighbour,
    and RANGE_KINDS' anchors of each. A 20-mer's prefix is its p12's
    digits and its last two codes are 0, so its reverse complement's
    p12 starts with 33 and the forward key is the canonical one."""
    a, pk = cfg.anchor_len, cfg.prefix_len
    if a - pk < 2 or pk < 2:
        raise ValueError("range_edge_case needs prefix and suffix keys of "
                         "two codes or more")
    rng = np.random.default_rng(seed)
    keys = [p for e in range_edges(cfg) for p in (e - 1, e)]
    chrom = rng.integers(0, 4, 200 * (len(keys) + 2)).astype(np.uint8)
    anchors = []
    for j, p12 in enumerate(keys):
        kmer = np.zeros(a, np.uint8)
        kmer[:pk] = [(p12 >> 2 * (pk - 1 - d)) & 3 for d in range(pk)]
        kmer[pk:a - 2] = rng.integers(0, 4, a - pk - 2)
        near = kmer.copy()
        near[0] = (near[0] + 1) % 4
        at = 200 * (j + 1)
        chrom[at:at + a] = kmer
        chrom[at + 100:at + 100 + a] = near
        n_first, n_last = kmer.copy(), kmer.copy()
        n_first[0] = n_last[-1] = _N
        anchors += [kmer, _revcomp(kmer), near, n_first, n_last]
    anchors = np.stack(anchors)
    cp = _exact_keys(torch.from_numpy(anchors), cfg)[2].numpy()
    if not np.array_equal(cp[::len(RANGE_KINDS)], keys):
        raise AssertionError("an edge 20-mer's canonical key is not its own")
    genome = Genome.from_records([("chrE", chrom)], cfg)
    return RangeCase(genome, anchors, cp)
