"""K1: batched anchor alignment (reference: find_circ2_tpu/ops/anchor_align.py;
SPEC.md §2 freezes the contract).

The classic path enumerates every <=1-mismatch variant of each 20-mer
anchor (1 + 3a = 61) and resolves it exactly in the cuckoo k-mer table;
the K1 v4 fast path resolves an anchor whose exact key is present from
4 row gathers (table and 1-mm neighbour table, two probes each) and
falls back to the enumeration on a static slice for the rest. On one
table on the card each of these is a hand-written CUDA kernel that
fetches its own rows: the exact-first probe (`exact_anchor_stats`,
csrc/exact_stats.cu), the enumeration with its hits and, for §2b
explore, its per-slot statistics and extras (`classic_anchor_stats`,
csrc/classic_k1.cu), and the fallback slice (`fallback_slice`, the
compaction, and `refill_slice`, the enumeration of the slice written
over the probe's hits; csrc/classic_k1.cu). A CPU tensor takes each
one's plain version (`*_ref`); the plain versions fetch rows through
`ops.gather_rows`.

The `*_sharded` forms take the index as prefix-range shards (the
sharded engine, parallel/sharded.py), a list of `Shard`s: each shard's
tables on its own device and the range of the canonical keys it owns
(`key_ranges`). A key outside a shard's range is looked up nowhere on
it: on the card its hash and row loads are skipped, and it reads as a
key the shard does not hold, which it is. The reference runs every
shard in its own program
and combines with psum/pmin inside; here one process drives all of a
data row's shards, so each function is a per-shard part (gathers and
probes on the shard's device), an integer sum/min/any over the shards on
the anchors' device, and a global finish. On CPU tensors that is the
plain `exact_partials` or `candidate_stats`, `_combine` and
`exact_finish` or `finalize_hits`; on the card each shard's part is a
record an anchor from a partials mode of the probe's or the
enumeration's kernel (`exact_records`, `classic_records`), copied into
one [shards, n, fields] buffer on the anchors' device, and the combine
and finish are one kernel (`shard_finish`, csrc/shard_k1.cu). The
single-table forms are the same with one shard and nothing between the
two parts.

Global positions are uint32 in the reference; here they are int64
holding the same values (the table's int32 lanes carry the bit pattern,
unmasked with `& 0xFFFFFFFF`). The reference's XLA workarounds are not
carried over: `_fold_min` is `amin`, the f32 ones-dots are int sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.index.hashtable import (CNT_BITS, CNT_MASK, LANES,
                                                  M32, NBR_LANES, S8_MASK,
                                                  SLOTS, mix_hash)
from find_circ2_tpu_torch.ops.gather_rows import (gather_rows,
                                                  gather_rows_multi)

LARGE_MM = 255
LARGE_POS = M32
# csrc/exact_stats.cu's limit on the anchor length (its keys are 64-bit).
MAX_ANCHOR_LEN = 32
# csrc/shard_k1.cu's limit on the index shards a combine takes.
MAX_SHARDS = 64

# csrc/classic_k1.cu's limits: V = 1 + 3a variants, two a lane of a warp;
# the §2b extras of K <= 16 hits (explore's kernel takes no more).
MAX_CLASSIC_ANCHOR_LEN = 21
MAX_EXTRAS_HITS = 16
# The reference's jnp.take fill for a row past an int32 table: every lane
# INT32_MIN, so no key matches it.
_FILL = -2 ** 31


class KeyRange(NamedTuple):
    """The canonical p12 values [lo, hi) of the keys an index shard owns."""
    lo: int
    hi: int


# What a single table, or a shard given without a range, owns: every key
# (the kernels' lo and hi, int64).
EVERY_KEY = KeyRange(0, 2 ** 63 - 1)


class Shard(NamedTuple):
    """One index shard as the sharded K1 takes it, its tensors on the
    shard's device: the cuckoo table, the neighbour table (None: the
    classic path only), meta, and the keys it owns (None: every key)."""
    table: torch.Tensor
    ntable: torch.Tensor | None
    meta: torch.Tensor
    owns: KeyRange | None = None


def key_ranges(n_buckets: int, n_shards: int) -> list[KeyRange]:
    """The keys each prefix-range shard owns, by the cut of
    index/hashtable.shard_query_table: shard i holds the canonical keys
    whose p12 lies in [i S, (i + 1) S), S = ceil(n_buckets / n_shards)."""
    S = -(-n_buckets // n_shards)
    return [KeyRange(i * S, (i + 1) * S) for i in range(n_shards)]


def _owned(cp, owns: KeyRange | None):
    """Whether each canonical p12 lies in `owns` (None: every key)."""
    if owns is None:
        return torch.ones_like(cp, dtype=torch.bool)
    return (cp >= owns.lo) & (cp < owns.hi)


# Kernel launches since the last reset (set to 0 to reset), by wrapper.
exact_launches = 0      # exact_anchor_stats
classic_launches = 0    # classic_anchor_stats and refill_slice
compact_launches = 0    # fallback_slice
exact_record_launches = 0    # exact_records (a shard's probe partials)
classic_record_launches = 0  # classic_records (a shard's enumeration)
finish_launches = 0          # shard_finish (the cross-shard combine)


def read_anchors(reads: torch.Tensor, lens: torch.Tensor, cfg: Config):
    """Anchor A = first a bases; anchor B = last a bases (per true len)."""
    a = cfg.anchor_len
    Lp = reads.shape[1]
    anchors_a = reads[:, :a]
    idxb = (torch.clamp(lens.to(torch.int64)[:, None] - a, 0, Lp - a)
            + torch.arange(a, device=reads.device)[None, :])
    return anchors_a, torch.gather(reads, 1, idxb)


class AnchorHits(NamedTuple):
    aligned: torch.Tensor    # bool [B]
    pos: torch.Tensor        # int64 [B], uint32 global anchor start
    strand: torch.Tensor     # int32 [B] 0/1 (2: none)
    mm: torch.Tensor         # int32 [B]
    n_best: torch.Tensor     # int32 [B]
    second_mm: torch.Tensor  # int32 [B]
    qual: torch.Tensor       # int32 [B]


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 lanes holding uint32 bit patterns -> int64 values."""
    return x.to(torch.int64) & M32


def _weights(cfg: Config, device):
    """Place values of each anchor digit in the (prefix, suffix) key and
    in the reverse complement's key: (wp, ws, wpr, wsr), int64 [a]."""
    a, pk = cfg.anchor_len, cfg.prefix_len
    sk = a - pk
    wp = [4 ** (pk - 1 - j) if j < pk else 0 for j in range(a)]
    ws = [4 ** (a - 1 - j) if j >= pk else 0 for j in range(a)]
    wpr = [4 ** (j - (a - pk)) if j >= a - pk else 0 for j in range(a)]
    wsr = [4 ** j if j < sk else 0 for j in range(a)]
    return tuple(torch.tensor(w, dtype=torch.int64, device=device)
                 for w in (wp, ws, wpr, wsr))


def _canonical(fw, rc):
    """(swap, canonical p12, canonical s8): the lexicographic min of the
    forward key (p12, s8) and its reverse complement's."""
    p12, s8 = fw
    p12r, s8r = rc
    swap = (p12r < p12) | ((p12r == p12) & (s8r < s8))
    return (swap, torch.where(swap, p12r, p12),
            torch.where(swap, s8r, s8))


def _bucket_rows(tables, cp, cs, meta, owns: KeyRange | None = None):
    """Rows of each table at the two cuckoo probes of keys (cp, cs):
    one gather launch for both probes and every table (`gather_rows` for
    one table, `gather_rows_multi` for two), so each bucket index is
    loaded once. A bucket at or past the tables' rows, and both buckets
    of a key outside `owns`, read as the reference's jnp.take fill
    (_FILL), which holds no key. Returns, per table, the pair (probe-0
    rows, probe-1 rows), each [*cp.shape, W]."""
    n_buckets = meta[2].to(torch.int64) & M32
    h = torch.cat([mix_hash(cp, cs, meta[s].to(torch.int64) & M32)
                   % n_buckets for s in (0, 1)]).reshape(-1)
    past = ((h >= min(t.shape[0] for t in tables))
            | ~_owned(cp, owns).reshape(-1).repeat(2))
    h = torch.where(past, 0, h)
    rows = ([gather_rows(tables[0], h)] if len(tables) == 1
            else gather_rows_multi(tables, h))
    out = []
    for t, g in zip(tables, rows):
        g = torch.where(past[:, None], _FILL, g).reshape(2, *cp.shape,
                                                         t.shape[1])
        out.append((g[0], g[1]))
    return out


def enumerate_variants(anchors: torch.Tensor, cfg: Config):
    """All <=1-mismatch variants of each anchor as paired forward /
    reverse-complement keys: (p12, s8, p12r, s8r, valid), each [B, V],
    V = 1 + 3a (exact query first, then 3 substitutions per position).
    Anchors with any code >= 4 are wholly invalid [FROZEN v2]."""
    B, a = anchors.shape
    anc = anchors.to(torch.int64)
    clean = (anc < 4).all(dim=-1, keepdim=True)
    qc = torch.where(anc < 4, anc, 0)
    wp, ws, wpr, wsr = _weights(cfg, anchors.device)
    base = [(qc * wp).sum(-1, keepdim=True), (qc * ws).sum(-1, keepdim=True),
            ((3 - qc) * wpr).sum(-1, keepdim=True),
            ((3 - qc) * wsr).sum(-1, keepdim=True)]
    r = torch.arange(1, 4, device=anchors.device)
    d = (((qc[..., None] + r) % 4) - qc[..., None]).reshape(B, 3 * a)

    def keys(b, w, sign):
        return torch.cat([b, b + sign * d * w.repeat_interleave(3)], dim=-1)

    p12 = keys(base[0], wp, 1)
    s8 = keys(base[1], ws, 1)
    p12r = keys(base[2], wpr, -1)
    s8r = keys(base[3], wsr, -1)
    return p12, s8, p12r, s8r, clean.expand(p12.shape)


def variant_metadata(cfg: Config, device=None):
    """Static per-variant (mm, strand) patterns, int32 [2V]."""
    V = 1 + 3 * cfg.anchor_len
    mm_one = torch.ones(V, dtype=torch.int32, device=device)
    mm_one[0] = 0
    strand_v = torch.arange(2, dtype=torch.int32,
                            device=device).repeat_interleave(V)
    return mm_one.repeat(2), strand_v


def candidate_stats(table, meta, anchors, cfg: Config, ext=None,
                    ext_id=None, owns: KeyRange | None = None):
    """Per-variant (count, first_pos) [B, 2V] — first V slots the '+'
    strand variants, last V their reverse complements — plus the static
    (mm_v, strand_v) [2V]. Two 32-byte bucket rows per canonical
    variant, each serving both strand slots.

    With the §2b extras (`ext` int32 [R, 2*(K-1)] holding uint32 bit
    patterns, `ext_id` int32 [T, SLOTS]; ops/explore), a fifth value
    `extras` int64 [B, 2V, K-1] holds each strand slot's positions 2..K
    of its hit list (LARGE_POS padded): the matching slot's ext row id,
    then that row, swapped into '+'/'-' slots like count/first_pos.
    A variant whose canonical key lies outside `owns` reads as absent:
    count 0, first_pos LARGE_POS."""
    p12, s8, p12r, s8r, valid = enumerate_variants(anchors, cfg)
    swap, cp, cs = _canonical((p12, s8), (p12r, s8r))
    want_ext = ext is not None
    rows = _bucket_rows((table, ext_id) if want_ext else (table,), cp, cs,
                        meta, owns)

    def probe(g, e):
        g = g.reshape(*cp.shape, SLOTS, LANES)
        packed = g[..., 1]
        m = (g[..., 0] == cp[..., None]) & ((packed & S8_MASK)
                                            == cs[..., None])
        cf = (packed >> 16) & CNT_MASK
        cr = (packed >> (16 + CNT_BITS)) & CNT_MASK
        # ext row id of the matching slot (0 = none): a key lives in at
        # most one slot, so the masked sum is exact.
        rid = None if e is None else torch.where(m, e, 0).sum(-1)
        return (torch.where(m, cf, 0).sum(-1),
                torch.where(m, _u32(g[..., 2]), LARGE_POS).amin(-1),
                torch.where(m, cr, 0).sum(-1),
                torch.where(m, _u32(g[..., 3]), LARGE_POS).amin(-1), rid)

    # Counts and ext row ids add over the two probes and positions take
    # their minimum, as the reference does. A key lives in one slot of one
    # bucket, but when its two buckets are one bucket both probes match
    # that slot: its count and ext row id then count twice (ROADMAP.md §3).
    e1, e2 = rows[1] if want_ext else (None, None)
    cf1, pf1, cr1, pr1, rid1 = probe(rows[0][0], e1)
    cf2, pf2, cr2, pr2, rid2 = probe(rows[0][1], e2)
    cnt_f, cnt_r = cf1 + cf2, cr1 + cr2
    pos_f, pos_r = torch.minimum(pf1, pf2), torch.minimum(pr1, pr2)
    count = torch.cat([torch.where(swap, cnt_r, cnt_f),
                       torch.where(swap, cnt_f, cnt_r)], dim=1)
    first_pos = torch.cat([torch.where(swap, pos_r, pos_f),
                           torch.where(swap, pos_f, pos_r)], dim=1)
    count = torch.where(torch.cat([valid, valid], dim=1), count, 0)
    # Repetitive-20-mer guard [FROZEN].
    count = torch.where(count > cfg.max_bucket, 0, count).to(torch.int32)
    mm_v, strand_v = variant_metadata(cfg, anchors.device)
    if not want_ext:
        return count, first_pos, mm_v, strand_v
    K1 = cfg.max_pair_hits - 1
    # A doubled row id may lie past the last ext row; such a row reads as
    # LARGE_POS, the fill of the reference's jnp.take. The gather takes
    # row 0 there and the row is overwritten.
    rid = (rid1 + rid2).reshape(-1)
    past = rid >= ext.shape[0]
    x = _u32(gather_rows(ext, torch.where(past, 0, rid)))
    x = torch.where(past[:, None], LARGE_POS, x).reshape(*cp.shape, 2 * K1)
    sw = swap[..., None]
    extras = torch.cat([torch.where(sw, x[..., K1:], x[..., :K1]),
                        torch.where(sw, x[..., :K1], x[..., K1:])], dim=1)
    return count, first_pos, mm_v, strand_v, extras


def _on_shards(shards, fn, args, device):
    """fn(shard, *args) on each index shard's own device; each result
    tuple comes back to `device` (the data row's first device)."""
    outs = []
    for shard in shards:
        dev = shard.table.device
        got = fn(shard, *(a.to(dev, non_blocking=True) for a in args))
        outs.append(tuple(x.to(device, non_blocking=True) for x in got))
    return outs


def _combine(parts, ops):
    """The cross-shard combine of K1's per-shard partials: field j of the
    result is the sum, minimum or any of field j over the shards, as
    ops[j] says ("sum", "min", "any"). Integer statistics, so the result
    equals one shard holding the whole table. One shard: its partials as
    they are."""
    if len(parts) == 1:
        return parts[0]
    out = []
    for j, op in enumerate(ops):
        x = torch.stack([p[j] for p in parts])
        out.append(x.sum(0, dtype=x.dtype) if op == "sum"
                   else x.amin(0) if op == "min" else x.any(0))
    return tuple(out)


def finalize_hits(count, first_pos, mm_v, strand_v, cfg: Config
                  ) -> AnchorHits:
    """Frozen lexicographic best-hit selection + MAPQ surrogate (SPEC §2).
    mm is 0 only at the two exact slots (0 and V), 1 elsewhere."""
    a = cfg.anchor_len
    V = count.shape[1] // 2
    exact_p, exact_m = count[:, 0], count[:, V]
    n_exact = exact_p + exact_m
    total = count.sum(1, dtype=torch.int32)
    any_exact, any_at_all = n_exact > 0, total > 0
    m0 = torch.where(any_exact, 0, torch.where(any_at_all, 1, LARGE_MM))
    n_best = torch.where(any_exact, n_exact, total)
    half_p = count[:, :V].sum(1, dtype=torch.int32)
    has_p_at_m0 = torch.where(any_exact, exact_p > 0, half_p > 0)
    strand_best = torch.where(has_p_at_m0, 0,
                              torch.where(any_at_all, 1, 2))
    sel = ((count > 0) & (mm_v[None, :] == m0[:, None])
           & (strand_v[None, :] == strand_best[:, None]))
    pos_best = torch.where(sel, first_pos, LARGE_POS).amin(1)
    return _hits(m0, n_best, total, n_exact, strand_best, pos_best, cfg)


def _hits(m0, n_best, total, n_exact, strand_best, pos_best, cfg: Config
          ) -> AnchorHits:
    """The frozen second_mm / qual / aligned formulas shared by both
    paths (SPEC §2)."""
    second_mm = torch.where(
        n_best > 1, m0,
        torch.where((m0 == 0) & (total > n_exact), 1, cfg.anchor_len + 1))
    qual = torch.where(n_best > 1, 0,
                       torch.clamp(10 * (second_mm - m0), max=40))
    i32 = torch.int32
    return AnchorHits(aligned=m0 <= cfg.max_anchor_mm, pos=pos_best,
                      strand=strand_best.to(i32), mm=m0.to(i32),
                      n_best=n_best.to(i32), second_mm=second_mm.to(i32),
                      qual=qual.to(i32))


def _exact_keys(anchors, cfg: Config):
    """(clean, swap, canonical p12, canonical s8) of each anchor's exact
    key; anchors with a code >= 4 are not clean."""
    anc = anchors.to(torch.int64)
    clean = (anc < 4).all(dim=-1)
    qc = torch.where(anc < 4, anc, 0)
    wp, ws, wpr, wsr = _weights(cfg, anchors.device)
    swap, cp, cs = _canonical(((qc * wp).sum(-1), (qc * ws).sum(-1)),
                              (((3 - qc) * wpr).sum(-1),
                               ((3 - qc) * wsr).sum(-1)))
    return clean, swap, cp, cs


# How exact_partials' fields combine across index shards: `found`, then
# count and first position of each orientation, exact and 1-mm ball.
EXACT_OPS = ("any", "sum", "min", "sum", "min", "sum", "min", "sum", "min")
# classic_records' fields (csrc/classic_k1.cu kClassicFields) and how they
# combine: the counts of the exact slots 0 and V, each strand half's
# summed count, then the least first position with a count above 0 of
# slot 0, slot V, slots 1..V-1 and slots V+1..2V-1.
CLASSIC_OPS = ("sum",) * 4 + ("min",) * 4
EXACT_FIELDS, CLASSIC_FIELDS = len(EXACT_OPS), len(CLASSIC_OPS)


def exact_partials(table, ntable, meta, cp, cs,
                   owns: KeyRange | None = None):
    """One index shard's part of exact_anchor_stats: the table and
    neighbour-table rows of the canonical keys (cp, cs) at both probes,
    reduced to (found, cnt_f, pos_f, cnt_r, pos_r, s1_f, minpos1_f, s1_r,
    minpos1_r). A key lives on one shard, in at most one slot of one of
    its two buckets; elsewhere counts are 0 and positions LARGE_POS, and
    so for a key outside `owns`, whose rows are not read."""
    (g1, g2), (n1, n2) = _bucket_rows((table, ntable), cp, cs, meta, owns)

    def probe(g, n):
        g = g.reshape(-1, SLOTS, LANES)
        n = n.reshape(-1, SLOTS, NBR_LANES)
        packed = g[..., 1]
        m = (g[..., 0] == cp[..., None]) & ((packed & S8_MASK)
                                            == cs[..., None])

        def msum(x):
            return torch.where(m, x, 0).sum(-1)

        def mmin(x):
            return torch.where(m, _u32(x), LARGE_POS).amin(-1)

        return (m.any(-1), msum((packed >> 16) & CNT_MASK), mmin(g[..., 2]),
                msum((packed >> (16 + CNT_BITS)) & CNT_MASK),
                mmin(g[..., 3]), msum(n[..., 0]), mmin(n[..., 1]),
                msum(n[..., 2]), mmin(n[..., 3]))

    f1, f2 = probe(g1, n1), probe(g2, n2)
    return tuple(f1[i] | f2[i] if op == "any" else
                 f1[i] + f2[i] if op == "sum" else torch.minimum(f1[i], f2[i])
                 for i, op in enumerate(EXACT_OPS))


def exact_finish(partials, clean, swap, cfg: Config):
    """exact_anchor_stats' global finish on the combined partials:
    (AnchorHits [B], resolved bool [B])."""
    found, cf_t, pf_t, cr_t, pr_t, s1f_t, m1f_t, s1r_t, m1r_t = partials
    # Repetitive-20-mer guard [FROZEN] on the exact counts summed over
    # the shards (neighbour aggregates are guard-filtered at build).
    usable = found & clean
    cf_t = torch.where(usable & (cf_t <= cfg.max_bucket), cf_t, 0)
    cr_t = torch.where(usable & (cr_t <= cfg.max_bucket), cr_t, 0)
    s1f_t = torch.where(usable, s1f_t, 0)
    s1r_t = torch.where(usable, s1r_t, 0)

    # The '+' query takes the canonical key's own lanes unless swapped.
    def orient(fwd, rev):
        return torch.where(swap, rev, fwd), torch.where(swap, fwd, rev)

    exact_p, exact_m = orient(cf_t, cr_t)
    posx_p, posx_m = orient(pf_t, pr_t)
    s1_p, s1_m = orient(s1f_t, s1r_t)
    mp1_p, mp1_m = orient(m1f_t, m1r_t)

    n_exact = exact_p + exact_m
    total = n_exact + s1_p + s1_m
    any_exact, any_at_all = n_exact > 0, total > 0
    m0 = torch.where(any_exact, 0, torch.where(any_at_all, 1, LARGE_MM))
    n_best = torch.where(any_exact, n_exact, total)
    has_p_at_m0 = torch.where(any_exact, exact_p > 0, s1_p > 0)
    strand_best = torch.where(has_p_at_m0, 0,
                              torch.where(any_at_all, 1, 2))
    pos_exact = torch.where((strand_best == 0) & (exact_p > 0), posx_p,
                            torch.where((strand_best == 1) & (exact_m > 0),
                                        posx_m, LARGE_POS))
    pos_1mm = torch.where(strand_best == 0, mp1_p,
                          torch.where(strand_best == 1, mp1_m, LARGE_POS))
    pos_best = torch.where(m0 == 0, pos_exact,
                           torch.where(m0 == 1, pos_1mm, LARGE_POS))
    hits = _hits(m0, n_best, total, n_exact, strand_best, pos_best, cfg)
    return hits, found | ~clean


def _all_cpu(shards, *tensors) -> bool:
    return all(t.is_cpu for t in (*tensors, *(
        x for s in shards for x in (s.table, s.ntable, s.meta)
        if x is not None)))


def exact_anchor_stats_sharded(shards, anchors, cfg: Config):
    """K1 v4 over prefix-range index shards (`Shard`s with their
    neighbour tables), each on its own device: per-shard partials of the
    keys it owns, combined on the anchors' device, then the global
    finish. Equals exact_anchor_stats on the whole table. On CPU tensors
    the plain parts; otherwise each shard's exact_records and one
    shard_finish (kernels, no wait)."""
    if _all_cpu(shards, anchors):
        return _exact_sharded_ref(shards, anchors, cfg)
    records = _shard_records(
        shards, lambda s, a, out=None: exact_records(
            s.table, s.ntable, s.meta, a, cfg, out, s.owns),
        anchors.shape[0], EXACT_FIELDS, anchors.device, (anchors,))
    return shard_finish(records, anchors, cfg)


def _exact_sharded_ref(shards, anchors, cfg: Config):
    """exact_anchor_stats_sharded's plain parts on any device."""
    clean, swap, cp, cs = _exact_keys(anchors, cfg)
    parts = _on_shards(shards, lambda s, p, q: exact_partials(
        s.table, s.ntable, s.meta, p, q, s.owns), (cp, cs), anchors.device)
    return exact_finish(_combine(parts, EXACT_OPS), clean, swap, cfg)


def exact_anchor_stats_ref(table, ntable, meta, anchors, cfg: Config):
    """Plain version of exact_anchor_stats: the sharded form's plain parts
    on one shard."""
    return _exact_sharded_ref([Shard(table, ntable, meta)], anchors, cfg)


def exact_anchor_stats(table, ntable, meta, anchors, cfg: Config):
    """K1 v4 fast path: the frozen SPEC §2 statistics from the exact
    canonical key alone (table row + neighbour-table row, two probes).
    Returns (AnchorHits [B], resolved bool [B]); resolved=False means the
    key is absent in both orientations and the anchor needs the
    enumeration. Dirty anchors (code >= 4) resolve to empty statistics.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/exact_stats.cu on the current stream (one launch, no wait) or
    raise."""
    if all(t.is_cpu for t in (table, ntable, meta, anchors)):
        return exact_anchor_stats_ref(table, ntable, meta, anchors, cfg)
    return _launch_exact((table, ntable, meta, anchors), cfg)


def _check_exact(table, ntable, meta, anchors, cfg: Config) -> None:
    """Raise unless the kernel takes these tensors and `cfg`."""
    dev = anchors.device
    for t in (table, ntable, meta, anchors):
        if t.device != dev:
            raise ValueError(f"exact_anchor_stats: a tensor on {t.device}, "
                             f"anchors on {dev}; all must be on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("exact_anchor_stats: tensors must be "
                             "contiguous")
    if dev.type != "cuda":
        raise ValueError(f"exact_anchor_stats: tensors on {dev}; the kernel "
                         "takes one CUDA device (CPU tensors take the plain "
                         "version)")
    a = cfg.anchor_len
    if (anchors.dtype != torch.uint8 or anchors.dim() != 2
            or anchors.shape[1] != a or not a <= MAX_ANCHOR_LEN):
        raise ValueError(f"exact_anchor_stats: anchors must be uint8 [n, "
                         f"{a}] (anchor_len <= {MAX_ANCHOR_LEN}), got "
                         f"{anchors.dtype} {list(anchors.shape)}")
    if (table.dtype != torch.int32 or ntable.dtype != torch.int32
            or table.dim() != 2 or table.shape[1] != SLOTS * LANES
            or tuple(ntable.shape) != (table.shape[0], SLOTS * NBR_LANES)
            or meta.dtype != torch.int32 or meta.dim() != 1
            or meta.shape[0] < 3):
        raise ValueError(f"exact_anchor_stats: want int32 table [T, "
                         f"{SLOTS * LANES}], ntable [T, {SLOTS * NBR_LANES}]"
                         f" and meta [>= 3], got {list(table.shape)}, "
                         f"{list(ntable.shape)}, {list(meta.shape)}")


def _launch_exact(args: tuple, cfg: Config, lib=None):
    """exact_anchor_stats on CUDA tensors: one C call into `lib` (default:
    the kernel library), made with the tensors' device current."""
    global exact_launches
    anchors = args[3]
    _check_exact(*args, cfg)
    n = anchors.shape[0]
    dev = anchors.device

    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    hits = AnchorHits(aligned=empty(torch.bool), pos=empty(torch.int64),
                      strand=empty(torch.int32), mm=empty(torch.int32),
                      n_best=empty(torch.int32),
                      second_mm=empty(torch.int32), qual=empty(torch.int32))
    resolved = empty(torch.bool)
    if n == 0:
        return hits, resolved
    exact_launches += _exact_call(lib, args, cfg,
                                  [x.data_ptr() for x in (*hits, resolved)],
                                  0, "exact_anchor_stats launch")
    return hits, resolved


def _exact_call(lib, args: tuple, cfg: Config, outs: list, partials: int,
                what: str, owns: KeyRange | None = None) -> int:
    """One C call of csrc/exact_stats.cu into `lib` (default: the kernel
    library) with the anchors' device current: the eight hit and
    `resolved` pointers `outs` (zeros in partials mode), the records'
    pointer `partials` (0 for the finish) and the keys looked up, `owns`
    (None: every key). Returns the launches."""
    table, ntable, meta, anchors = args
    lib = lib or _build.load()
    index = anchors.get_device()
    with torch.cuda.device(index):
        got = lib.fc2t_exact_stats(_build.EXACT_ARGS.pack(
            anchors.data_ptr(), table.data_ptr(), ntable.data_ptr(),
            meta.data_ptr(), *outs, partials,
            torch._C._cuda_getCurrentRawStream(index), table.shape[0],
            *(owns or EVERY_KEY), anchors.shape[0], cfg.anchor_len,
            cfg.prefix_len, cfg.max_bucket, cfg.max_anchor_mm, index))
    if got < 0:
        _build.check(-got, what)
    return got


def classic_anchor_stats_ref(table, meta, anchors, cfg: Config, ext=None,
                             ext_id=None, stats: bool = False):
    """Plain version of classic_anchor_stats: candidate_stats, then
    finalize_hits."""
    got = candidate_stats(table, meta, anchors, cfg, ext, ext_id)
    count, first_pos, mm_v, strand_v = got[:4]
    hits = finalize_hits(count, first_pos, mm_v, strand_v, cfg)
    return hits, ((count, first_pos, *got[4:]) if stats else None)


def classic_anchor_stats(table, meta, anchors, cfg: Config, ext=None,
                         ext_id=None, stats: bool = False):
    """Classic K1 on one table: (AnchorHits [n], stats) for anchors uint8
    [n, a]. `stats` None, or with `stats` candidate_stats' (count int32
    [n, 2V], first_pos int64 [n, 2V]) and, given the §2b `ext` and
    `ext_id`, its extras int64 [n, 2V, K-1]. CPU tensors take the plain
    version; CUDA tensors launch csrc/classic_k1.cu on the current stream
    (one launch, no wait) or raise."""
    if (ext is None) != (ext_id is None) or (ext is not None and not stats):
        raise ValueError("classic_anchor_stats: ext and ext_id go together, "
                         "and only with stats=True")
    given = [t for t in (table, meta, anchors, ext, ext_id) if t is not None]
    if all(t.is_cpu for t in given):
        return classic_anchor_stats_ref(table, meta, anchors, cfg, ext,
                                        ext_id, stats)
    return _launch_classic(table, meta, anchors, cfg, ext, ext_id, stats)


def _scatter(hits: AnchorHits, slots, sub: AnchorHits) -> AnchorHits:
    """`hits` with `sub`'s rows at `slots` (new tensors)."""
    return AnchorHits(*(f.index_copy(0, slots, x) for f, x in zip(hits,
                                                                   sub)))


def refill_slice_ref(table, meta, anchors, slots, hits, cfg: Config
                     ) -> AnchorHits:
    """Plain version of refill_slice: new tensors."""
    return _scatter(hits, slots, classic_anchor_stats_ref(
        table, meta, anchors[slots], cfg)[0])


def refill_slice(table, meta, anchors, slots, hits: AnchorHits,
                 cfg: Config) -> AnchorHits:
    """K1 v4's fallback: `hits` [n] with the classic hits of
    anchors[slots] (slots int64 [k], distinct) written at `slots`. CPU
    tensors take the plain version, which returns new tensors; on CUDA
    tensors csrc/classic_k1.cu enumerates each slot's anchor and writes
    its hits into `hits` in place (one launch, no wait), and returns
    `hits`: the caller passes fresh outputs that nothing else holds, as
    exact_anchor_stats' are."""
    given = [table, meta, anchors, slots, *hits]
    if all(t.is_cpu for t in given):
        return refill_slice_ref(table, meta, anchors, slots, hits, cfg)
    return _launch_classic(table, meta, anchors, cfg, slots=slots,
                           hits=hits)[0]


def _check_classic(table, meta, anchors, cfg: Config, ext, ext_id, slots,
                   hits) -> None:
    """Raise unless csrc/classic_k1.cu takes these tensors and `cfg`."""
    dev = anchors.device
    given = [t for t in (table, meta, anchors, ext, ext_id, slots)
             if t is not None] + list(hits or ())
    for t in given:
        if t.device != dev:
            raise ValueError(f"classic_anchor_stats: a tensor on {t.device},"
                             f" anchors on {dev}; all must be on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("classic_anchor_stats: tensors must be "
                             "contiguous")
    if dev.type != "cuda":
        raise ValueError(f"classic_anchor_stats: tensors on {dev}; the "
                         "kernel takes one CUDA device (CPU tensors take "
                         "the plain version)")
    a = cfg.anchor_len
    if (anchors.dtype != torch.uint8 or anchors.dim() != 2
            or anchors.shape[1] != a or not a <= MAX_CLASSIC_ANCHOR_LEN):
        raise ValueError(f"classic_anchor_stats: anchors must be uint8 [n, "
                         f"{a}] (anchor_len <= {MAX_CLASSIC_ANCHOR_LEN}), "
                         f"got {anchors.dtype} {list(anchors.shape)}")
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[1] != SLOTS * LANES or table.data_ptr() % 16
            or meta.dtype != torch.int32 or meta.dim() != 1
            or meta.shape[0] < 3):
        raise ValueError(f"classic_anchor_stats: want an int32 table [T, "
                         f"{SLOTS * LANES}] on 16 bytes and meta [>= 3], got "
                         f"{list(table.shape)}, {list(meta.shape)}")
    if ext is not None:
        K = cfg.max_pair_hits
        if (not 2 <= K <= MAX_EXTRAS_HITS or ext.dtype != torch.int32
                or ext_id.dtype != torch.int32 or ext.dim() != 2
                or ext.shape[0] < 1 or ext.shape[1] != 2 * (K - 1)
                or tuple(ext_id.shape) != (table.shape[0], SLOTS)
                or ext.data_ptr() % 8 or ext_id.data_ptr() % 8):
            raise ValueError(f"classic_anchor_stats: want int32 ext [R, "
                             f"{2 * (K - 1)}] and ext_id [{table.shape[0]}, "
                             f"{SLOTS}] on 8 bytes, max_pair_hits 2.."
                             f"{MAX_EXTRAS_HITS}; got {list(ext.shape)}, "
                             f"{list(ext_id.shape)}, K = {K}")
    if slots is not None:
        n = anchors.shape[0]
        want = (torch.bool, torch.int64) + (torch.int32,) * 5
        if (slots.dtype != torch.int64 or slots.dim() != 1
                or slots.shape[0] > n or any(
                    f.dtype != d or tuple(f.shape) != (n,)
                    for f, d in zip(hits or (), want))):
            raise ValueError(f"refill_slice: want int64 slots [<= {n}] and "
                             f"AnchorHits fields [{n}] of finalize_hits' "
                             "dtypes")


def _launch_classic(table, meta, anchors, cfg: Config, ext=None,
                    ext_id=None, stats: bool = False, slots=None, hits=None,
                    lib=None, records=None, owns: KeyRange | None = None):
    """classic_anchor_stats (or, with `slots`, refill_slice into `hits`)
    on CUDA tensors: one C call into `lib` (default: the kernel library),
    made with the tensors' device current. Returns (hits, stats). With
    `records` (int32 [n, CLASSIC_FIELDS]) the partials mode: each slot's
    record of the keys of `owns` (None: every key) goes there instead of
    its hits (hits None)."""
    global classic_launches, classic_record_launches
    _check_classic(table, meta, anchors, cfg, ext, ext_id, slots, hits)
    dev = anchors.device
    n = anchors.shape[0] if slots is None else slots.shape[0]

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    if records is not None:
        hits = AnchorHits(*(None,) * len(AnchorHits._fields))
    elif hits is None:
        hits = AnchorHits(aligned=empty(n, dtype=torch.bool),
                          pos=empty(n, dtype=torch.int64), strand=empty(n),
                          mm=empty(n), n_best=empty(n), second_mm=empty(n),
                          qual=empty(n))
    V2 = 2 * (1 + 3 * cfg.anchor_len)
    K1 = cfg.max_pair_hits - 1
    out = None
    if stats:
        out = (empty(n, V2), empty(n, V2, dtype=torch.int64))
        if ext is not None:
            out += (empty(n, V2, K1, dtype=torch.int64),)
    if n == 0:
        return hits, out

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    count, first_pos, extras = (*(out or ()), None, None, None)[:3]
    lib = lib or _build.load()
    index = anchors.get_device()
    with torch.cuda.device(index):
        got = lib.fc2t_classic_k1(_build.CLASSIC_ARGS.pack(
            anchors.data_ptr(), table.data_ptr(), meta.data_ptr(),
            ptr(ext_id), ptr(ext), ptr(slots), *(ptr(x) for x in hits),
            ptr(count), ptr(first_pos), ptr(extras),
            torch._C._cuda_getCurrentRawStream(index), table.shape[0],
            0 if ext is None else ext.shape[0], n, cfg.anchor_len,
            cfg.prefix_len, cfg.max_bucket, cfg.max_anchor_mm,
            0 if ext is None else K1, index, 0, *(owns or EVERY_KEY),
            ptr(records)))
    if got < 0:
        _build.check(-got, "classic_anchor_stats launch")
    if records is None:
        classic_launches += got
    else:
        classic_record_launches += got
    return hits, out


def fallback_slice_ref(resolved, k: int):
    """Plain version of fallback_slice."""
    idx = torch.argsort(resolved.to(torch.int8), stable=True)[:k]
    return idx, (~resolved).sum() > k


def fallback_slice(resolved, k: int):
    """K1 v4's static fallback slice of bool `resolved` [n]: (the first k
    indices of its stable argsort, int64 [k]: the unresolved anchors
    first, then the resolved, each in index order; the 0-d bool `overflow`,
    True when more than k are unresolved). A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/classic_k1.cu's compaction on the
    current stream (one launch, no wait) or raises."""
    if resolved.is_cpu:
        return fallback_slice_ref(resolved, k)
    return _launch_compact(resolved, k)


def _check_compact(resolved, k: int) -> None:
    """Raise unless the compaction takes `resolved` and `k`."""
    if (resolved.device.type != "cuda" or resolved.dtype != torch.bool
            or resolved.dim() != 1 or not resolved.is_contiguous()
            or not 0 <= k <= resolved.shape[0]):
        raise ValueError(f"fallback_slice: want a contiguous bool [n] on a "
                         f"CUDA device and 0 <= k <= n, got "
                         f"{resolved.dtype} {list(resolved.shape)} on "
                         f"{resolved.device}, k = {k}")


def _launch_compact(resolved, k: int, lib=None):
    """fallback_slice on a CUDA tensor: one C call, with its device
    current."""
    global compact_launches
    _check_compact(resolved, k)
    dev = resolved.device
    n = resolved.shape[0]
    idx = torch.empty(k, dtype=torch.int64, device=dev)
    if n == 0:
        return idx, torch.zeros((), dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    lib = lib or _build.load()
    index = resolved.get_device()
    with torch.cuda.device(index):
        got = lib.fc2t_compact(_build.COMPACT_ARGS.pack(
            resolved.data_ptr(), idx.data_ptr(), overflow.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index), n, k, index, 0))
    if got < 0:
        _build.check(-got, "fallback_slice launch")
    compact_launches += got
    return idx, overflow


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Integers (uint32 values or counts, any dtype) -> their int32 bit
    patterns."""
    x = x.to(torch.int64) & M32
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def exact_records_ref(table, ntable, meta, anchors, cfg: Config,
                      owns: KeyRange | None = None):
    """Plain version of exact_records: exact_partials on the anchors'
    canonical keys, as int32 [n, EXACT_FIELDS] (positions as uint32 bit
    patterns, `found` 0 or 1)."""
    _, _, cp, cs = _exact_keys(anchors, cfg)
    return torch.stack([_i32(x) for x in exact_partials(
        table, ntable, meta, cp, cs, owns)], dim=1)


def exact_records(table, ntable, meta, anchors, cfg: Config, out=None,
                  owns: KeyRange | None = None):
    """One index shard's part of exact_anchor_stats: each anchor's record
    of EXACT_OPS' fields, int32 [n, EXACT_FIELDS], before the guard, the
    `clean` mask and the finish (shard_finish does those over every
    shard). An anchor whose canonical key lies outside `owns` (None:
    every key) gets the record of a key the shard does not hold (found
    0, counts 0, positions LARGE_POS), and on the card no hash and no row
    load. CPU tensors take the plain version; CUDA tensors launch
    csrc/exact_stats.cu in partials mode on the current stream (one
    launch, no wait) or raise. Either writes into `out` (a contiguous
    int32 [n, EXACT_FIELDS]) when one is given."""
    if all(t.is_cpu for t in (table, ntable, meta, anchors)):
        return _into(out, exact_records_ref(table, ntable, meta, anchors,
                                            cfg, owns))
    return _launch_exact_records((table, ntable, meta, anchors), cfg, out,
                                 owns=owns)


def _into(out, got):
    """`got`, or copied into `out` when one is given."""
    return got if out is None else out.copy_(got)


def _check_records(out, n: int, fields: int, like, what: str) -> None:
    if out is not None and (out.dtype != torch.int32
                            or tuple(out.shape) != (n, fields)
                            or not out.is_contiguous()
                            or out.device != like.device):
        raise ValueError(f"{what}: want a contiguous int32 out [{n}, "
                         f"{fields}] on {like.device}, got {out.dtype} "
                         f"{list(out.shape)} on {out.device}")


def _launch_exact_records(args: tuple, cfg: Config, out=None, lib=None,
                          owns: KeyRange | None = None):
    """exact_records on CUDA tensors: one C call into `lib` (default: the
    kernel library), made with the tensors' device current."""
    global exact_record_launches
    anchors = args[3]
    _check_exact(*args, cfg)
    n = anchors.shape[0]
    _check_records(out, n, EXACT_FIELDS, anchors, "exact_records")
    if out is None:
        out = torch.empty((n, EXACT_FIELDS), dtype=torch.int32,
                          device=anchors.device)
    if n:
        exact_record_launches += _exact_call(
            lib, args, cfg, [0] * 8, out.data_ptr(), "exact_records launch",
            owns)
    return out


def classic_records_ref(table, meta, anchors, cfg: Config, slots=None,
                        owns: KeyRange | None = None):
    """Plain version of classic_records: candidate_stats of anchors (or
    of anchors[slots]) on the keys of `owns` reduced to CLASSIC_OPS'
    fields, int32 [n, CLASSIC_FIELDS] (positions as uint32 bit patterns,
    LARGE_POS where no slot has a count)."""
    if slots is not None:
        anchors = anchors[slots]
    count, first_pos = candidate_stats(table, meta, anchors, cfg,
                                       owns=owns)[:2]
    V = count.shape[1] // 2

    def least(lo, hi):
        return torch.where(count[:, lo:hi] > 0, first_pos[:, lo:hi],
                           LARGE_POS).amin(1)

    cols = (count[:, 0], count[:, V], count[:, :V].sum(1),
            count[:, V:].sum(1), least(0, 1), least(V, V + 1), least(1, V),
            least(V + 1, 2 * V))
    return torch.stack([_i32(c) for c in cols], dim=1)


def classic_records(table, meta, anchors, cfg: Config, slots=None,
                    out=None, owns: KeyRange | None = None):
    """One index shard's part of the classic enumeration: each anchor's
    (with `slots`, int64 [k], each slot's anchor's) record of CLASSIC_OPS'
    fields, int32 [n or k, CLASSIC_FIELDS], the `valid` mask and each
    slot's guard applied on the shard, as candidate_stats applies them.
    A variant whose canonical key lies outside `owns` (None: every key)
    counts as absent, and on the card issues no hash and no row load.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/classic_k1.cu in partials mode on the current stream (one
    launch, no wait) or raise. Either writes into `out` when one is
    given."""
    given = [t for t in (table, meta, anchors, slots) if t is not None]
    if all(t.is_cpu for t in given):
        return _into(out, classic_records_ref(table, meta, anchors, cfg,
                                              slots, owns))
    return _launch_classic_records(table, meta, anchors, cfg, slots, out,
                                   owns=owns)


def _launch_classic_records(table, meta, anchors, cfg: Config, slots=None,
                            out=None, lib=None,
                            owns: KeyRange | None = None):
    """classic_records on CUDA tensors: one C call, with the tensors'
    device current."""
    n = anchors.shape[0] if slots is None else slots.shape[0]
    _check_records(out, n, CLASSIC_FIELDS, anchors, "classic_records")
    if out is None:
        out = torch.empty((n, CLASSIC_FIELDS), dtype=torch.int32,
                          device=anchors.device)
    _launch_classic(table, meta, anchors, cfg, slots=slots, lib=lib,
                    records=out, owns=owns)
    return out


def shard_finish_ref(records, anchors, cfg: Config, slots=None, hits=None):
    """Plain version of shard_finish: new tensors."""
    u = records.to(torch.int64)

    def comb(j, op):
        x = u[:, :, j]
        return (x.sum(0) if op == "sum" else (x & M32).amin(0)
                if op == "min" else (x != 0).any(0))

    if records.shape[2] == EXACT_FIELDS:
        parts = tuple(comb(j, op) for j, op in enumerate(EXACT_OPS))
        clean, swap, _, _ = _exact_keys(anchors, cfg)
        return exact_finish(parts, clean, swap, cfg)
    c0, cv, sp, sm, p0, pv, pp, pm = (comb(j, op)
                                      for j, op in enumerate(CLASSIC_OPS))
    # finalize_hits on the records: mm is 0 only at the exact slots.
    n_exact, total = c0 + cv, sp + sm
    any_exact, any_at_all = n_exact > 0, total > 0
    m0 = torch.where(any_exact, 0, torch.where(any_at_all, 1, LARGE_MM))
    n_best = torch.where(any_exact, n_exact, total)
    strand = torch.where(torch.where(any_exact, c0 > 0, sp > 0), 0,
                         torch.where(any_at_all, 1, 2))

    def on_strand(plus, minus):
        return torch.where(strand == 0, plus,
                           torch.where(strand == 1, minus, LARGE_POS))

    pos = torch.where(m0 == 0, on_strand(p0, pv),
                      torch.where(m0 == 1, on_strand(pp, pm), LARGE_POS))
    sub = _hits(m0, n_best, total, n_exact, strand, pos, cfg)
    return sub if slots is None else _scatter(hits, slots, sub)


def shard_finish(records, anchors, cfg: Config, slots=None, hits=None):
    """The cross-shard combine and finish of K1's shard records, int32
    [shards, n, fields] on the anchors' device. Exact records
    (EXACT_FIELDS, exact_records) sum, take the least or any over the
    shards, then exact_finish with the anchors' `clean` and `swap`:
    (AnchorHits [n], resolved bool [n]). Classic records (CLASSIC_FIELDS,
    classic_records) combine, then finalize_hits: AnchorHits [n], or with
    `slots` (int64 [n], distinct) `hits` with row s's written at
    slots[s] (refill_slice's contract: on the card in place, into fresh
    outputs that nothing else holds). CPU tensors take the plain version;
    CUDA tensors launch csrc/shard_k1.cu on the current stream (one
    launch, no wait) or raise."""
    given = [t for t in (records, anchors, slots) if t is not None]
    if all(t.is_cpu for t in given + list(hits or ())):
        return shard_finish_ref(records, anchors, cfg, slots, hits)
    return _launch_finish(records, anchors, cfg, slots, hits)


def _check_finish(records, anchors, cfg: Config, slots, hits) -> None:
    """Raise unless csrc/shard_k1.cu takes these tensors and `cfg`."""
    dev = records.device
    given = [t for t in (records, anchors, slots) if t is not None]
    for t in given + list(hits or ()):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"shard_finish: want contiguous tensors on "
                             f"{dev}, one CUDA device, got one on "
                             f"{t.device}")
    if dev.type != "cuda":
        raise ValueError(f"shard_finish: records on {dev}; the kernel takes "
                         "one CUDA device (CPU tensors take the plain "
                         "version)")
    exact = records.dim() == 3 and records.shape[2] == EXACT_FIELDS
    a = cfg.anchor_len
    if (records.dtype != torch.int32 or records.dim() != 3
            or records.shape[2] not in (EXACT_FIELDS, CLASSIC_FIELDS)
            or not 1 <= records.shape[0] <= MAX_SHARDS
            or not a <= MAX_ANCHOR_LEN
            or exact != (anchors is not None)
            or (exact and (anchors.dtype != torch.uint8
                           or tuple(anchors.shape) != (records.shape[1], a)
                           or slots is not None))
            or (slots is None) != (hits is None)):
        raise ValueError(f"shard_finish: want int32 records [1..{MAX_SHARDS}"
                         f", n, {EXACT_FIELDS}] with uint8 anchors [n, {a}], "
                         f"or [.., n, {CLASSIC_FIELDS}] without; slots with "
                         f"hits; got {records.dtype} {list(records.shape)}")
    if slots is not None:
        n = hits.pos.shape[0]
        want = (torch.bool, torch.int64) + (torch.int32,) * 5
        if (slots.dtype != torch.int64
                or tuple(slots.shape) != (records.shape[1],)
                or slots.shape[0] > n or any(
                    f.dtype != d or tuple(f.shape) != (n,)
                    for f, d in zip(hits, want))):
            raise ValueError(f"shard_finish: want int64 slots "
                             f"[{records.shape[1]}] and AnchorHits fields "
                             f"[{n}] of finalize_hits' dtypes")


def _launch_finish(records, anchors, cfg: Config, slots=None, hits=None,
                   lib=None):
    """shard_finish on CUDA tensors: one C call into `lib` (default: the
    kernel library), made with the records' device current."""
    global finish_launches
    _check_finish(records, anchors, cfg, slots, hits)
    S, n, fields = records.shape
    dev = records.device

    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    resolved = None
    if hits is None:
        hits = AnchorHits(aligned=empty(torch.bool), pos=empty(torch.int64),
                          strand=empty(torch.int32), mm=empty(torch.int32),
                          n_best=empty(torch.int32),
                          second_mm=empty(torch.int32),
                          qual=empty(torch.int32))
    if anchors is not None:
        resolved = empty(torch.bool)
    if n:
        def ptr(t):
            return 0 if t is None else t.data_ptr()

        lib = lib or _build.load()
        index = records.get_device()
        with torch.cuda.device(index):
            got = lib.fc2t_shard_finish(_build.SHARD_ARGS.pack(
                records.data_ptr(), ptr(anchors), ptr(slots),
                *(x.data_ptr() for x in hits), ptr(resolved),
                torch._C._cuda_getCurrentRawStream(index), n, S, fields,
                cfg.anchor_len, cfg.prefix_len, cfg.max_bucket,
                cfg.max_anchor_mm, index, 0))
        if got < 0:
            _build.check(-got, "shard_finish launch")
        finish_launches += got
    return hits if anchors is None else (hits, resolved)


def _shard_records(shards, make, n: int, fields: int, device, args: tuple):
    """Every shard's records, int32 [len(shards), n, fields] on `device`:
    make(shard, *args, out=) on the shard's device, straight into its
    row of the buffer when that is the shard's device, else into a new
    tensor there, copied over (no wait)."""
    buf = torch.empty((len(shards), n, fields), dtype=torch.int32,
                      device=device)
    for s, shard in enumerate(shards):
        dev = shard.table.device
        if dev == device:
            make(shard, *args, out=buf[s])
        else:
            got = make(shard, *(a.to(dev, non_blocking=True)
                                for a in args))
            buf[s].copy_(got, non_blocking=True)
    return buf


# The stages of csrc/classic_k1.cu between its stage clocks
# (FC2T_CLASSIC_STAMPS): an enumeration warp's, and the compaction
# block's.
CLASSIC_STAGES = ("slot and anchor loads", "key build", "row round trip",
                  "fold and finish", "ext rows", "extras writes")
COMPACT_STAGES = ("flag loads", "scan", "writes")


def classic_stage_cycles(table, meta, anchors, cfg: Config, ext=None,
                         ext_id=None, stats: bool = False, slots=None,
                         hits=None, records: bool = False,
                         owns: KeyRange | None = None):
    """classic_anchor_stats (or, with `slots`, refill_slice into `hits`)
    on CUDA tensors through the measurement build of csrc/classic_k1.cu:
    ((hits, stats), int64 [n, len(CLASSIC_STAGES)] SM clock cycles of each
    warp's stages, lane 0's clock64 at the start and where each stage's
    results are first used). One launch, counted on `classic_launches`.
    With `records`, classic_records on the keys of `owns` instead: (its
    records, the cycles; the partials mode stops after "fold and
    finish"), counted on `classic_record_launches`."""
    n = anchors.shape[0] if slots is None else slots.shape[0]
    if records:
        return _build.stamped(
            "fc2t_classic_stamps", n, len(CLASSIC_STAGES), anchors,
            lambda lib: _launch_classic_records(table, meta, anchors, cfg,
                                                slots, lib=lib, owns=owns))
    return _build.stamped(
        "fc2t_classic_stamps", n, len(CLASSIC_STAGES), anchors,
        lambda lib: _launch_classic(table, meta, anchors, cfg, ext, ext_id,
                                    stats, slots, hits, lib))


def compact_stage_cycles(resolved, k: int):
    """fallback_slice on a CUDA tensor through the measurement build of
    csrc/classic_k1.cu: ((idx, overflow), int64 [1, len(COMPACT_STAGES)]
    SM clock cycles of the block's stages, thread 0's clock64). One launch,
    counted on `compact_launches`."""
    return _build.stamped(
        "fc2t_classic_stamps", 1, len(COMPACT_STAGES), resolved,
        lambda lib: _launch_compact(resolved, k, lib))


# The stages of csrc/exact_stats.cu between its stage clocks
# (FC2T_DETECT_STAMPS), a warp's, and the anchors a warp takes.
EXACT_STAGES = ("code loads and key build", "hash and row round trip",
                "fold and finish", "writes")
EXACT_ANCHORS_PER_WARP = 8


def exact_stage_cycles(table, ntable, meta, anchors, cfg: Config,
                       records: bool = False, owns: KeyRange | None = None):
    """exact_anchor_stats on CUDA tensors through the measurement build of
    csrc/exact_stats.cu: ((hits, resolved), int64 [warps,
    len(EXACT_STAGES)] SM clock cycles of each warp's stages, its first
    lane's clock64 at the start and where each stage's results are first
    used; a warp takes EXACT_ANCHORS_PER_WARP anchors). One launch,
    counted on `exact_launches`. With `records`, exact_records on the
    keys of `owns` instead: (its records, the cycles; the partials mode
    stamps "writes" where its records are written), counted on
    `exact_record_launches`."""
    warps = -(-anchors.shape[0] // EXACT_ANCHORS_PER_WARP)
    args = (table, ntable, meta, anchors)
    return _build.stamped(
        "fc2t_exact_stamps", warps, len(EXACT_STAGES), anchors,
        (lambda lib: _launch_exact_records(args, cfg, lib=lib, owns=owns))
        if records else (lambda lib: _launch_exact(args, cfg, lib)))


def align_anchors_sharded(shards, anchors, cfg: Config) -> AnchorHits:
    """Classic K1 over index shards (`Shard`s; their neighbour tables
    unused): each shard's (count, first_pos) of the keys it owns, summed
    and minimized on the anchors' device, then finalize_hits. On CPU
    tensors the plain parts; otherwise each shard's classic_records and
    one shard_finish (kernels, no wait)."""
    if not _all_cpu(shards, anchors):
        records = _shard_records(
            shards, lambda s, a, out=None: classic_records(
                s.table, s.meta, a, cfg, out=out, owns=s.owns),
            anchors.shape[0], CLASSIC_FIELDS, anchors.device, (anchors,))
        return shard_finish(records, None, cfg)
    parts = _on_shards(shards, lambda s, a: candidate_stats(
        s.table, s.meta, a, cfg, owns=s.owns), (anchors,), anchors.device)
    mm_v, strand_v = parts[0][2:]
    parts = [p[:2] for p in parts]
    if len(parts) > 1:
        # Mask empty slots before the cross-shard min: another shard may
        # own the variant and hold the true (larger) position.
        parts = [(c, torch.where(c > 0, p, LARGE_POS)) for c, p in parts]
    count, first_pos = _combine(parts, ("sum", "min"))
    return finalize_hits(count, first_pos, mm_v, strand_v, cfg)


def align_anchors(table, meta, anchors, cfg: Config) -> AnchorHits:
    """SPEC.md §2 anchor alignment by enumeration (classic K1) on one
    table: classic_anchor_stats' hits."""
    return classic_anchor_stats(table, meta, anchors, cfg)[0]


def _split(hits, B):
    return (AnchorHits(*(x[:B] for x in hits)),
            AnchorHits(*(x[B:] for x in hits)))


def align_anchor_pair_sharded(shards, anchors_a, anchors_b, cfg: Config
                              ) -> tuple[AnchorHits, AnchorHits]:
    """Both anchors of a batch as one stacked [2B] enumeration over
    index shards (`Shard`s)."""
    return _split(align_anchors_sharded(
        shards, torch.cat([anchors_a, anchors_b]), cfg), anchors_a.shape[0])


def align_anchor_pair(table, meta, anchors_a, anchors_b, cfg: Config
                      ) -> tuple[AnchorHits, AnchorHits]:
    """Both anchors of a batch as one stacked [2B] enumeration."""
    return _split(align_anchors(table, meta, torch.cat([anchors_a,
                                                        anchors_b]), cfg),
                  anchors_a.shape[0])


def _fast_pair(exact, compact, refill, anchors_a, anchors_b, cfg: Config):
    """The exact-first pair on `exact(anchors) -> (hits, resolved)`, with
    the enumeration fallback on the static slice `compact(resolved, k) ->
    (idx, overflow)`, whose hits `refill(anchors, idx, hits)` writes over
    the exact ones. The phases carry the profiler labels k1_exact and
    k1_fallback."""
    B = anchors_a.shape[0]
    both = torch.cat([anchors_a, anchors_b])
    with record_function("k1_exact"):
        hits, resolved = exact(both)
    with record_function("k1_fallback"):
        idx, overflow = compact(resolved, min(cfg.exact_fallback_slots,
                                              2 * B))
        hits = refill(both, idx, hits)
    return (*_split(hits, B), overflow)


def refill_slice_sharded(shards, anchors, slots, hits: AnchorHits,
                         cfg: Config) -> AnchorHits:
    """refill_slice over index shards (`Shard`s): `hits` with the
    classic hits of anchors[slots] written at `slots`. On CPU tensors the
    plain parts, into new tensors; otherwise each shard's classic_records
    in slot mode and one shard_finish that writes into `hits` in place
    (kernels, no wait), as refill_slice does."""
    if _all_cpu(shards, anchors, slots, *hits):
        return _scatter(hits, slots, align_anchors_sharded(
            shards, anchors[slots], cfg))
    records = _shard_records(
        shards, lambda s, a, sl, out=None: classic_records(
            s.table, s.meta, a, cfg, slots=sl, out=out, owns=s.owns),
        slots.shape[0], CLASSIC_FIELDS, anchors.device, (anchors, slots))
    return shard_finish(records, None, cfg, slots=slots, hits=hits)


def align_anchor_pair_fast_sharded(shards, anchors_a, anchors_b,
                                   cfg: Config):
    """align_anchor_pair_fast over index shards (`Shard`s with their
    neighbour tables). The fallback slice is compacted on the combined
    `resolved` (fallback_slice, the compaction kernel on the card), so
    every shard enumerates the same anchors, and its statistics combine
    as the classic path's."""
    return _fast_pair(
        lambda both: exact_anchor_stats_sharded(shards, both, cfg),
        fallback_slice,
        lambda both, idx, hits: refill_slice_sharded(shards, both, idx,
                                                     hits, cfg),
        anchors_a, anchors_b, cfg)


def align_anchor_pair_fast(table, ntable, meta, anchors_a, anchors_b,
                           cfg: Config):
    """K1 v4: exact-first alignment (exact_anchor_stats) with the
    enumeration fallback on a STATIC slice of k =
    min(exact_fallback_slots, 2B) anchors, the unresolved ones first
    (fallback_slice, a stable sort of `resolved`), whose classic hits
    replace the exact ones (refill_slice; re-enumerated resolved anchors
    give identical statistics, so the scatter is unconditional). On the
    card all three are kernels. Returns (hits_a, hits_b, overflow):
    `overflow` is a 0-d bool tensor, True when more anchors were
    unresolved than the slice holds — the caller must then redo the batch
    on the classic path. Nothing here waits for the device."""
    return _fast_pair(
        lambda both: exact_anchor_stats(table, ntable, meta, both, cfg),
        fallback_slice,
        lambda both, idx, hits: refill_slice(table, meta, both, idx, hits,
                                             cfg),
        anchors_a, anchors_b, cfg)
