"""Query-optimized k-mer hash table: the device-side form of the seed
index (SURVEY.md §2.2 L0 — the bowtie2-build artifact analog, query half).

The two-level SeedIndex (index/build.py) is the *build* artifact: sorted
position lists, exact host lookups, the oracle's ground truth. Querying it
on device costs ~11 dependent gather passes per anchor variant (bucket
bounds + binary search + position fetch) — and on TPU every random gather
pass over a large HBM table costs the same regardless of row width
(measured ~10 ms per 1M elements on v5e). This module collapses K1's whole
per-variant query to TWO row gathers over HALF the variants:

  - every *distinct* anchor-length k-mer is pre-aggregated at build time to
    the only statistics K1 ever needs: (count, first_position) — SPEC.md §2
    reduces best-hit selection to range arithmetic over these;
  - k-mers are stored under their CANONICAL key (lexicographic min of the
    k-mer and its reverse complement); each slot carries both orientations'
    payloads: (count_fwd, pos_fwd, count_rc, pos_rc). Since the reverse
    complement of a 1-mismatch variant of q is a 1-mismatch variant of
    rc(q), ONE canonical lookup per forward variant yields the statistics
    of both the '+' and the '-' strand variant — halving gather volume;
  - distinct canonical k-mers go into a 2-choice, 2-slot-per-bucket
    cuckoo table; a slot is int32x4 — (p12, s8|cnt_f|cnt_r, pos_f,
    pos_r), counts clamped to max_bucket+1 (the repetitive-k-mer guard
    zeroes anything above max_bucket, so the clamp is lossless).
    Measured on v5e: a 1M-row gather pass costs ~7.6 ms up to 4-lane
    rows and ~+0.5 ms per extra lane, so narrow slots are the whole
    point — the 4-slot/6-lane layout cost 2.6x more;
  - lookup = hash twice, gather two 32-byte bucket rows, compare keys.
    Exact by key equality — never probabilistic.

The port's copy of find_circ2_tpu/index/hashtable.py: the numpy table
builders as they are there, and `mix_hash` on numpy arrays (the
builders) and on torch tensors (the device probes of ops/anchor_align),
bit for bit the same hash; and the prefix-range shard builders of the
sharded engine (`shard_query_table`, `_shard_from_table`,
`shard_neighbor_tables`; parallel/sharded.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.index.build import SeedIndex

# On-disk table artifact format generation. Bump whenever the slot
# layout OR the hash mixer changes: a table built under a different
# mix_hash hashes keys to different buckets, so every device K1 lookup
# would silently miss (with the default 2-mm rescue, every read then
# detours to the host slow path; with rescue off, output is silently
# wrong). v2 = the r4 salted-multiplier mixer (see mix_hash below).
# Persisted as a 4th element after (salt0, salt1, n_buckets) in saved
# qmeta arrays; loaders must reject or rebuild on mismatch.
TABLE_FORMAT = 2
SLOTS = 2          # slots per bucket ((2,2)-cuckoo threshold ~0.9; the
                   # parallel random-walk insert livelocks with 1-slot
                   # buckets — eviction cycles synchronize — but
                   # converges in seconds at 2 slots / load 0.8)
LANES = 4          # int32 lanes: p12, s8|cnt_f<<16|cnt_r<<23, pos_f, pos_r
EMPTY_KEY = -1
# Global positions are uint32 (genomes up to ~4.29 Gbp — the whole human
# genome fits, BASELINE configs[4]); the pos lanes store the uint32 bit
# pattern in the int32 table. LARGE_POS is the uint32 max sentinel.
LARGE_POS = np.uint32(2 ** 32 - 1)
CNT_BITS = 7       # packed count field width; needs max_bucket + 1 < 127
S8_MASK = (1 << 16) - 1
CNT_MASK = (1 << CNT_BITS) - 1
M32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def mul32(x, k):
    """x * k mod 2^32 for int64 tensors (or ints) holding uint32 values."""
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & M32


def mix_hash(p12_u32, s8_u32, salt_u32):
    """Multiply-xor-shift mixer on uint32 lanes; identical semantics for
    numpy inputs (the builders: uint32 arrays, wrapping mod 2^32) and
    torch tensors (the device path: int64 tensors holding uint32 values,
    every `*`, `<<` and `^` wrapped mod 2^32 explicitly, the products
    split into 16-bit halves so no int64 product overflows; `salt_u32`
    an int or an int64 tensor). [FROZEN with the table artifact: tables
    store the salts they were built with.]

    The 40->32-bit key reduction MUST itself depend on the salt: the
    pre-r4 form post-mixed the salt-independent value `p12*c1 ^ s8*c2`
    through bijective stages, so two keys colliding under one salt
    collided under EVERY salt — at whole-genome key counts (~2^28) a
    handful of >4-key clusters share one reduced value and can never
    be cuckoo-placed, livelocking every attempt (the r3 3.3 Gbp build
    burned 4+ hours on 19 such attempts). Salted odd multipliers make
    the two probes' collision sets independent: P(joint collision)
    drops from D^2/2^33 to D^2/2^65.

    numpy constants are materialized in the uint32 scalar type: numpy
    scalar (0-d) uint32 arithmetic warns on wrap."""
    if isinstance(p12_u32, torch.Tensor):
        salt = salt_u32
        k1 = (_C1 ^ salt) | 1
        k2 = (_C2 ^ ((salt << 1) & M32)) | 1
        h = mul32(p12_u32, k1) ^ mul32(s8_u32, k2) ^ salt
        h = mul32(h ^ (h >> 15), _C3)
        return h ^ (h >> 13)
    u32 = np.uint32
    c1, c2, c3 = u32(_C1), u32(_C2), u32(_C3)
    one = u32(1)
    k1 = (c1 ^ salt_u32) | one
    k2 = (c2 ^ (salt_u32 << u32(1))) | one
    h = (p12_u32 * k1) ^ (s8_u32 * k2) ^ salt_u32
    h = (h ^ (h >> 15)) * c3
    h = h ^ (h >> 13)
    return h


@dataclass
class QueryTable:
    """Bucketized cuckoo table over distinct k-mers.

    table: int32 [T_pad, SLOTS * LANES]; rows >= n_buckets are padding.
    meta:  int32 [3] = (salt0, salt1, n_buckets) — salts are uint32 bit
           patterns stored as int32.
    ext / ext_id: SPEC §2b extras for device-side multi-hit exploration
           (ops/explore.py). A k-mer orientation occurring c times with
           2 <= c <= max_bucket gets its positions[1 : min(c, K)]
           (K = max_pair_hits) stored in a fixed-width `ext` row
           ([n_rows, 2*(K-1)] uint32: fwd block then rc block, padded
           LARGE_POS; row 0 is the all-LARGE dummy). `ext_id`
           (int32 [T_pad, SLOTS]) maps each table slot to its row (0 =
           none) — a side array so the K1 fast path never pays for it.
           None on tables built with extras=False (host-only querying).
    """
    table: np.ndarray
    meta: np.ndarray
    ext: np.ndarray | None = None
    ext_id: np.ndarray | None = None
    # K1 v4 exact-first 1-mm aggregates (build_neighbor_table); cached
    # here after a build so repeated DeviceIndex.build calls reuse it.
    ntable: np.ndarray | None = None

    @property
    def n_buckets(self) -> int:
        return int(np.uint32(self.meta[2]))


def distinct_kmers(index: SeedIndex, with_starts: bool = False):
    """(p12, s8, count, first_pos[, group_start]) per distinct k-mer, from
    the sorted SeedIndex (positions within a (p12, s8) group are ascending,
    so the group head is the smallest position). `group_start` (int64,
    only with `with_starts`) is each group's head offset into
    `index.positions` — the §2b extras builder slices the next
    `min(count, K) - 1` positions from there.

    Memory-lean for whole-genome indexes (3G+ entries): group heads come
    from the suffix-change flags plus bucket boundaries — no per-entry
    bucket-id materialization."""
    offs = index.offsets.astype(np.int64)
    n = int(index.positions.size)
    if n == 0:
        z = np.zeros(0, np.int32)
        return (z, z, z, z, z.astype(np.int64)) if with_starts \
            else (z, z, z, z)
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = index.suffix_vals[1:] != index.suffix_vals[:-1]
    # Entries are (p12, s8)-sorted, so a bucket boundary is a group head
    # even if the suffix value repeats across it.
    bucket_starts = offs[:-1][np.diff(offs) > 0]
    new[bucket_starts] = True
    starts = np.flatnonzero(new)
    cnt = np.diff(np.append(starts, n)).astype(np.int32)
    p12 = (np.searchsorted(offs, starts, side="right") - 1).astype(np.int32)
    out = (p12, index.suffix_vals[starts].astype(np.int32), cnt,
           index.positions[starts].astype(np.uint32))
    return out + (starts,) if with_starts else out


def rc_kmer(k64: np.ndarray, a: int) -> np.ndarray:
    """Reverse complement of base-4-packed k-mers (uint64, big-endian
    digits: first base most significant, SPEC.md §1)."""
    k = k64.astype(np.uint64).copy()
    rc = np.zeros_like(k)
    three = np.uint64(3)
    two = np.uint64(2)
    for _ in range(a):
        rc = (rc << two) | (three - (k & three))
        k >>= two
    return rc


def canonical_keys(index: SeedIndex):
    """Distinct CANONICAL k-mers with both orientations' payloads.

    Returns (p12c, s8c, cnt_f, pos_f, cnt_r, pos_r, st_f, st_r), where the
    _f fields describe occurrences of the canonical k-mer itself and the
    _r fields occurrences of its reverse complement; a missing orientation
    has count 0 / pos LARGE_POS / start 0. Palindromic k-mers carry the
    same payload on both sides. `st_f`/`st_r` (int64) are each
    orientation's group-head offset into `index.positions` — consumed by
    the §2b extras builder (`_build_from_keys`)."""
    p12, s8, cnt, fpos, gstart = distinct_kmers(index, with_starts=True)
    a = index.anchor_len
    sk_bits = np.uint64(2 * (a - index.prefix_len))
    k64 = (p12.astype(np.uint64) << sk_bits) | s8.astype(np.uint64)
    rc64 = rc_kmer(k64, a)
    c64 = np.minimum(k64, rc64)
    swapped = k64 != rc64
    swapped &= c64 != k64           # True: this entry is the rc side of c
    palin = k64 == rc64

    order = np.lexsort((swapped, c64))
    c_s = c64[order]
    sw_s = swapped[order]
    cnt_s = cnt[order]
    pos_s = fpos[order]
    pal_s = palin[order]
    gst_s = gstart[order]
    n = c_s.size
    if n == 0:
        z = np.zeros(0, np.int32)
        z64 = np.zeros(0, np.int64)
        return z, z, z, z, z, z, z64, z64
    first = np.empty(n, bool)
    first[0] = True
    first[1:] = c_s[1:] != c_s[:-1]
    uid = np.cumsum(first) - 1
    U = int(uid[-1]) + 1
    cnt_f = np.zeros(U, np.int32)
    pos_f = np.full(U, LARGE_POS, np.uint32)
    cnt_r = np.zeros(U, np.int32)
    pos_r = np.full(U, LARGE_POS, np.uint32)
    st_f = np.zeros(U, np.int64)
    st_r = np.zeros(U, np.int64)
    fwd = ~sw_s
    cnt_f[uid[fwd]] = cnt_s[fwd]
    pos_f[uid[fwd]] = pos_s[fwd]
    st_f[uid[fwd]] = gst_s[fwd]
    cnt_r[uid[sw_s]] = cnt_s[sw_s]
    pos_r[uid[sw_s]] = pos_s[sw_s]
    st_r[uid[sw_s]] = gst_s[sw_s]
    cnt_r[uid[pal_s]] = cnt_s[pal_s]
    pos_r[uid[pal_s]] = pos_s[pal_s]
    st_r[uid[pal_s]] = gst_s[pal_s]
    cu = c_s[first]
    p12c = (cu >> sk_bits).astype(np.int32)
    s8c = (cu & ((np.uint64(1) << sk_bits) - np.uint64(1))).astype(np.int32)
    return p12c, s8c, cnt_f, pos_f, cnt_r, pos_r, st_f, st_r


def _derive_salts(seed: int, attempt: int) -> np.ndarray:
    rng = np.random.default_rng((seed << 8) + attempt)
    return rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)


def _try_place(p12, s8, T: int, salts: np.ndarray, rng,
               max_rounds: int = 1024, log=None):
    """Parallel random-walk cuckoo insertion. Returns slot->key_id array
    of shape [T * SLOTS] (EMPTY_KEY where free) or None on failure.

    Bucket indices are int64 throughout (a whole-genome table can need
    T beyond uint32 — the r3 3.3 Gbp build crashed on np.uint32(T)).
    The 32-bit hash is widened by folding the key's high entropy back
    in: T within 2^32 uses the plain `mix % T`; larger T combines both
    salted mixes. Rounds are capped generously but abort early when the
    unplaced count stops improving (livelock detection) instead of
    burning the full budget — the r3 failure mode was ~19 silent
    256-round attempts over 4+ hours."""
    D = p12.size
    up = p12.astype(np.uint32)
    us = s8.astype(np.uint32)
    m0 = mix_hash(up, us, salts[0]).astype(np.int64)
    m1 = mix_hash(up, us, salts[1]).astype(np.int64)
    if T <= 2 ** 32:
        h = np.stack([m0 % T, m1 % T])                    # [2, D]
    else:
        h = np.stack([(m0 | (m1 << 32)) % T,
                      (m1 | (m0 << 32)) % T])
    del m0, m1
    slot_key = np.full(T * SLOTS, EMPTY_KEY, np.int64)
    side = np.zeros(D, np.int8)
    unplaced = np.arange(D)
    lanes = np.arange(SLOTS)
    best_u = D + 1
    stall = 0
    for rnd in range(max_rounds):
        if unplaced.size == 0:
            if log is not None:
                log(f"cuckoo: placed {D:,} keys in {rnd} rounds")
            return slot_key
        if unplaced.size < best_u:
            best_u = unplaced.size
            stall = 0
        else:
            stall += 1
            if stall >= 64:       # livelocked: no progress in 64 rounds
                break
        if log is not None and rnd and rnd % 32 == 0:
            log(f"cuckoo: round {rnd}, {unplaced.size:,} unplaced")
        b = h[side[unplaced], unplaced]
        rows = slot_key[b[:, None] * SLOTS + lanes]       # [U, SLOTS]
        empty = rows < 0
        has_empty = empty.any(axis=1)
        r = rng.random((unplaced.size, SLOTS))
        pick_empty = np.argmax(empty * (1.0 + r), axis=1)
        pick_evict = rng.integers(0, SLOTS, unplaced.size)
        s = np.where(has_empty, pick_empty, pick_evict)
        target = b * SLOTS + s
        prev = slot_key[target]
        slot_key[target] = unplaced                       # last write wins
        winner = slot_key[target] == unplaced
        evicted = prev[winner & (prev >= 0)]
        losers = unplaced[~winner]
        side[losers] ^= 1
        side[evicted] ^= 1
        unplaced = np.concatenate([losers, evicted])
    if log is not None:
        log(f"cuckoo: FAILED with {unplaced.size:,}/{D:,} unplaced "
            f"after {rnd + 1} rounds")
    return None


def build_query_table(index: SeedIndex, cfg: Config = Config(), *,
                      load: float = 0.8, seed: int = 0,
                      pad_buckets: int | None = None,
                      extras: bool = True, log=None) -> QueryTable:
    """Aggregate distinct canonical k-mers and place them in a cuckoo
    table. Deterministic given (index, seed). `pad_buckets` pads the
    table with unaddressable empty rows (sharded stacking). `extras`
    additionally builds the §2b multi-hit position rows (QueryTable.ext).
    `log` (callable) reports canonical-key and cuckoo progress — always
    pass one for genome-scale builds."""
    if cfg.max_bucket + 1 >= (1 << CNT_BITS):
        raise ValueError(f"max_bucket must be < {(1 << CNT_BITS) - 1} "
                         "to fit the packed count field")
    keys = canonical_keys(index)
    if log is not None:
        log(f"canonical keys aggregated: {keys[0].size:,} distinct")
    return _build_from_keys(*keys, load=load, seed=seed,
                            pad_buckets=pad_buckets,
                            max_bucket=cfg.max_bucket,
                            positions=index.positions if extras else None,
                            max_pair_hits=cfg.max_pair_hits, log=log)


def _build_extras(cnt_f, st_f, cnt_r, st_r, positions, max_bucket: int,
                  K: int):
    """Fixed-width §2b extras rows: for each orientation with true count
    c in [2, max_bucket], positions[start+1 : start+min(c, K)] (the
    smallest-8-of-a-union property makes per-list K-prefixes sufficient
    for the frozen first-K candidate cap). Returns (ext, row_id)."""
    need_f = (cnt_f >= 2) & (cnt_f <= max_bucket)
    need_r = (cnt_r >= 2) & (cnt_r <= max_bucket)
    has = need_f | need_r
    n_rows = int(has.sum())
    if n_rows >= 2 ** 31 - 1:
        raise ValueError("extras row count overflows int32")
    row_id = np.zeros(cnt_f.size, np.int32)
    row_id[has] = 1 + np.arange(n_rows, dtype=np.int32)
    ext = np.full((1 + n_rows, 2 * (K - 1)), LARGE_POS, np.uint32)
    j = np.arange(K - 1, dtype=np.int64)[None, :]
    pmax = max(0, positions.size - 1)
    for need, cnt, st, col in ((need_f, cnt_f, st_f, 0),
                               (need_r, cnt_r, st_r, K - 1)):
        sel = np.flatnonzero(need)
        if sel.size == 0:
            continue
        m = (np.minimum(cnt[sel], K) - 1)[:, None]        # extras per kmer
        idx = st[sel][:, None] + 1 + j
        vals = positions[np.minimum(idx, pmax)].astype(np.uint32)
        ext[row_id[sel], col:col + K - 1] = np.where(j < m, vals,
                                                     LARGE_POS)
    return ext, row_id


def _build_from_keys(p12, s8, cnt_f, pos_f, cnt_r, pos_r,
                     st_f=None, st_r=None, *, load: float,
                     seed: int, pad_buckets: int | None = None,
                     max_bucket: int, positions=None,
                     max_pair_hits: int = 8, log=None) -> QueryTable:
    D = int(p12.size)
    T = max(1, int(np.ceil(D / (SLOTS * load))))
    slot_key = None
    salts = _derive_salts(seed, 0)
    for attempt in range(24):
        salts = _derive_salts(seed, attempt)
        rng = np.random.default_rng((seed << 16) ^ (attempt << 1) ^ 1)
        if log is not None:
            log(f"cuckoo: attempt {attempt}, {D:,} keys, "
                f"{T:,} buckets (load {D / (SLOTS * T):.3f})")
        slot_key = _try_place(p12, s8, T, salts, rng, log=log)
        if slot_key is not None:
            break
        T = int(T * 1.2) + 1
    if slot_key is None:
        raise RuntimeError(f"cuckoo build failed for {D} keys")
    T_pad = max(T, pad_buckets or 0)
    table = np.full((T_pad * SLOTS, LANES), EMPTY_KEY, np.int32)
    placed = np.flatnonzero(slot_key >= 0)
    kid = slot_key[placed]
    # Counts clamp to max_bucket + 1: the query-side repetitive-k-mer
    # guard maps anything > max_bucket to 0, so the clamp is lossless.
    clamp = np.int32(max_bucket + 1)
    cf = np.minimum(cnt_f[kid], clamp).astype(np.int32)
    cr = np.minimum(cnt_r[kid], clamp).astype(np.int32)
    table[placed, 0] = p12[kid]
    table[placed, 1] = s8[kid] | (cf << 16) | (cr << (16 + CNT_BITS))
    # uint32 positions bitcast into the int32 lanes (fancy-index copies
    # are contiguous, so .view is safe).
    table[placed, 2] = pos_f[kid].astype(np.uint32).view(np.int32)
    table[placed, 3] = pos_r[kid].astype(np.uint32).view(np.int32)
    meta = np.array([np.uint32(salts[0]).view(np.int32),
                     np.uint32(salts[1]).view(np.int32), T], np.int32)
    ext = ext_id = None
    if positions is not None:
        ext, row_id = _build_extras(cnt_f, st_f, cnt_r, st_r, positions,
                                    max_bucket, max_pair_hits)
        ext_id = np.zeros(T_pad * SLOTS, np.int32)
        ext_id[placed] = row_id[kid]
        ext_id = ext_id.reshape(T_pad, SLOTS)
    return QueryTable(table=table.reshape(T_pad, SLOTS * LANES), meta=meta,
                      ext=ext, ext_id=ext_id)


NBR_LANES = 4      # neighbor-table lanes: S1_f, minpos1_f, S1_r, minpos1_r


def build_neighbor_table(index: SeedIndex, cfg: Config = Config(), *,
                         chunk: int = 1 << 23, log=None) -> np.ndarray:
    """Precomputed 1-mm-ball aggregates per table slot — K1 v4's
    build-time enumeration (docs/DESIGN.md "exact-first K1").

    For each distinct canonical k-mer c, over its 60 Hamming-1
    neighbors v (guard-filtered exactly as SPEC §2: a variant with
    count > MAX_BUCKET contributes nothing):

      S1_f(c)      = sum of occ(v)      — 1-mm hit count, '+' query
      minpos1_f(c) = min first_pos of those occurrences
      S1_r(c)      = sum of occ(rc(v))  — 1-mm hit count, '-' query
      minpos1_r(c) = min first_pos of those

    With these, an anchor whose 20-mer EXISTS in the table resolves its
    full frozen §2 statistics (m0, n_best, strand, pos, second_mm,
    qual) from FOUR 16-32 B row gathers instead of enumerating 61
    variants x 2 probes — the swap trick works unchanged because the
    _f/_r pair of canon(q) serves q and rc(q) symmetrically
    (occ(ball1(rc c)) = occ(rc(ball1 c))). Absent-key anchors (a
    sequencing error usually makes the 20-mer absent genome-wide) still
    need the enumeration fallback.

    Returns int32 [T_pad, SLOTS * NBR_LANES], row-aligned with
    qt.table (same bucket index, same slot order); position lanes carry
    uint32 bit patterns like the main table. Built FROM the clamped
    table payloads (clamp mb+1 marks exactly the guard-excluded
    variants, so the aggregates are exact), so no re-aggregation of the
    genome-scale distinct-k-mer pass is needed."""
    qt = index.qtable
    if qt is None:
        raise ValueError("build_neighbor_table needs a built query table")
    a = index.anchor_len
    pk = index.prefix_len
    mb = cfg.max_bucket
    tab = np.asarray(qt.table).reshape(-1, LANES)
    occ_slots = np.flatnonzero(tab[:, 0] != EMPTY_KEY)
    D = occ_slots.size
    if log is not None:
        log(f"neighbor table: {D:,} occupied slots")
    p12 = tab[occ_slots, 0].astype(np.uint64)
    packed = tab[occ_slots, 1]
    sk_bits = np.uint64(2 * (a - pk))
    c64 = (p12 << sk_bits) | (packed & S8_MASK).astype(np.uint64)
    cnt_f = ((packed >> 16) & CNT_MASK).astype(np.int32)
    cnt_r = ((packed >> (16 + CNT_BITS)) & CNT_MASK).astype(np.int32)
    pos_f = tab[occ_slots, 2].view(np.uint32)
    pos_r = tab[occ_slots, 3].view(np.uint32)
    order = np.argsort(c64, kind="stable")
    cs = c64[order]
    cf_s = cnt_f[order]
    cr_s = cnt_r[order]
    pf_s = pos_f[order]
    pr_s = pos_r[order]
    # Guard filter [FROZEN]: a variant with count > mb contributes
    # nothing (the stored clamp mb+1 marks exactly those).
    vf = (cf_s >= 1) & (cf_s <= mb)
    vr = (cr_s >= 1) & (cr_s <= mb)
    cf_v = np.where(vf, cf_s, 0).astype(np.int64)
    cr_v = np.where(vr, cr_s, 0).astype(np.int64)
    pf_v = np.where(vf, pf_s, LARGE_POS)
    pr_v = np.where(vr, pr_s, LARGE_POS)

    s1f = np.zeros(D, np.int64)
    s1r = np.zeros(D, np.int64)
    mp1f = np.full(D, LARGE_POS, np.uint32)
    mp1r = np.full(D, LARGE_POS, np.uint32)
    four = np.uint64(4)
    for lo in range(0, D, chunk):
        hi = min(lo + chunk, D)
        c = cs[lo:hi]
        rcc = rc_kmer(c, a)
        af = np.zeros(hi - lo, np.int64)
        ar = np.zeros(hi - lo, np.int64)
        mf = np.full(hi - lo, LARGE_POS, np.uint32)
        mr = np.full(hi - lo, LARGE_POS, np.uint32)
        for j in range(a):
            pj = four ** np.uint64(a - 1 - j)
            qj = four ** np.uint64(j)
            dig = (c // pj) % four
            for r in (1, 2, 3):
                b = (dig + np.uint64(r)) % four
                delta = b.astype(np.int64) - dig.astype(np.int64)
                v = (c.astype(np.int64)
                     + delta * np.int64(pj)).astype(np.uint64)
                rv = (rcc.astype(np.int64)
                      - delta * np.int64(qj)).astype(np.uint64)
                swap = rv < v
                cv = np.where(swap, rv, v)
                idx = np.searchsorted(cs, cv)
                idx = np.minimum(idx, D - 1)
                hit = cs[idx] == cv
                # occ(v) lives on the target's fwd lane when canon(v)
                # == v, else on its rc lane; occ(rc(v)) on the other.
                tf = np.where(swap, cr_v[idx], cf_v[idx])
                tr = np.where(swap, cf_v[idx], cr_v[idx])
                qfp = np.where(swap, pr_v[idx], pf_v[idx])
                qrp = np.where(swap, pf_v[idx], pr_v[idx])
                af += np.where(hit, tf, 0)
                ar += np.where(hit, tr, 0)
                mf = np.minimum(mf, np.where(hit & (tf > 0), qfp,
                                             LARGE_POS))
                mr = np.minimum(mr, np.where(hit & (tr > 0), qrp,
                                             LARGE_POS))
        s1f[lo:hi] = af
        s1r[lo:hi] = ar
        mp1f[lo:hi] = mf
        mp1r[lo:hi] = mr
        if log is not None and hi < D:
            log(f"neighbor table: {hi:,}/{D:,} keys aggregated")
    inv = np.empty(D, np.int64)
    inv[order] = np.arange(D)
    T_pad = qt.table.shape[0]
    nt = np.zeros((T_pad * SLOTS, NBR_LANES), np.int32)
    nt[occ_slots, 0] = s1f[inv].astype(np.int32)
    nt[occ_slots, 1] = mp1f[inv].view(np.int32)
    nt[occ_slots, 2] = s1r[inv].astype(np.int32)
    nt[occ_slots, 3] = mp1r[inv].view(np.int32)
    # Empty slots: S1 = 0, minpos = LARGE_POS.
    empty = np.setdiff1d(np.arange(T_pad * SLOTS), occ_slots,
                         assume_unique=True)
    nt[empty, 1] = np.int32(-1)     # LARGE_POS bit pattern
    nt[empty, 3] = np.int32(-1)
    return nt.reshape(T_pad, SLOTS * NBR_LANES)


def shard_neighbor_tables(qt: QueryTable, tables: np.ndarray
                          ) -> np.ndarray:
    """Per-shard K1 v4 neighbor tables, row-aligned with `tables`
    (the output of shard_query_table).

    1-mm neighbors cross prefix-range shard boundaries, so the
    aggregates are properties of the FULL key set: they are built once
    on the full table (build_neighbor_table -> qt.ntable) and RELOCATED
    here — each shard slot's key is probed in the full table and its
    aggregate row copied. Returns int32
    [n_shards, T_pad, SLOTS * NBR_LANES]."""
    if qt.ntable is None:
        raise ValueError("full-table ntable missing; call "
                         "build_neighbor_table first")
    ftab = np.asarray(qt.table).reshape(-1, LANES)
    ntf = np.asarray(qt.ntable).reshape(-1, NBR_LANES)
    salts = np.asarray(qt.meta[:2], np.int32).view(np.uint32)
    nb = np.int64(qt.n_buckets)
    n_shards, T_pad, _ = tables.shape
    out = np.zeros((n_shards, T_pad * SLOTS, NBR_LANES), np.int32)
    out[:, :, 1] = -1           # LARGE_POS bit pattern for empty slots
    out[:, :, 3] = -1
    for i in range(n_shards):
        tab = tables[i].reshape(-1, LANES)
        occ = np.flatnonzero(tab[:, 0] != EMPTY_KEY)
        if occ.size == 0:
            continue
        p12 = tab[occ, 0].astype(np.uint32)
        s8 = (tab[occ, 1] & S8_MASK).astype(np.uint32)
        rows = np.zeros((occ.size, NBR_LANES), np.int32)
        found = np.zeros(occ.size, bool)
        for salt in salts:
            h = (mix_hash(p12, s8, salt).astype(np.int64)) % nb
            for s in range(SLOTS):
                slot = h * SLOTS + s
                m = (~found) \
                    & (ftab[slot, 0] == tab[occ, 0]) \
                    & ((ftab[slot, 1] & S8_MASK)
                       == (tab[occ, 1] & S8_MASK))
                rows[m] = ntf[slot[m]]
                found |= m
        if not found.all():
            raise RuntimeError(
                f"shard {i}: {int((~found).sum())} keys not found in "
                f"the full table (table/ntable mismatch)")
        out[i, occ] = rows
    return out.reshape(n_shards, T_pad, SLOTS * NBR_LANES)


def _shard_from_table(qt: QueryTable, n_shards: int, n_buckets: int,
                      cfg: Config, load: float, seed: int):
    """Carve prefix-range shards out of an EXISTING full table.

    Every occupied slot stores its canonical key (p12, s8) and both
    orientations' clamped payloads, so sharding is filter + re-place —
    no re-aggregation of the (possibly multi-hour at 3 Gbp) distinct
    k-mer pass. Table contents are placement-permutations of the
    slow-path shards; all lookups are exact key compares, so results
    are bit-identical (tests/test_sharded.py)."""
    # No ascontiguousarray: qt.table may be a tens-of-GiB memmap; the
    # reshape is a view and the boolean filter copies only kept rows.
    tab = np.asarray(qt.table).reshape(-1, LANES)
    occupied = tab[:, 0] != EMPTY_KEY
    S = -(-n_buckets // n_shards)
    parts = []
    for i in range(n_shards):
        keep = occupied & (tab[:, 0] >= i * S) & (tab[:, 0] < (i + 1) * S)
        rows = tab[keep]
        packed = rows[:, 1]
        parts.append(_build_from_keys(
            rows[:, 0], packed & S8_MASK,
            (packed >> 16) & CNT_MASK,
            rows[:, 2].view(np.uint32),
            (packed >> (16 + CNT_BITS)) & CNT_MASK,
            rows[:, 3].view(np.uint32),
            load=load, seed=seed + i, max_bucket=cfg.max_bucket))
    T_pad = max(p.table.shape[0] for p in parts)
    tables = np.full((n_shards, T_pad, SLOTS * LANES), EMPTY_KEY,
                     np.int32)
    metas = np.zeros((n_shards, 3), np.int32)
    for i, p in enumerate(parts):
        tables[i, :p.table.shape[0]] = p.table
        metas[i] = p.meta
    return tables, metas


def shard_query_table(index: SeedIndex, n_shards: int,
                      cfg: Config = Config(), *, load: float = 0.8,
                      seed: int = 0, extras: bool = False):
    """Range-partition distinct canonical k-mers by prefix12 and build
    one QueryTable per shard, padded to a common bucket count.

    Returns (tables int32 [n_shards, T_pad, SLOTS*LANES],
             metas int32 [n_shards, 3]); with `extras` additionally
             (exts uint32 [n_shards, n_rows, 2*(K-1)],
              ext_ids int32 [n_shards, T_pad, SLOTS]) — each distinct
             canonical k-mer's §2b positions live on its owning shard,
             so cross-shard candidate merging is an all_gather + re-cap
             (ops/explore.py).

    When the index already carries a built full table, non-extras
    shards are carved from it directly (`_shard_from_table`) instead of
    re-running the whole-genome distinct-k-mer aggregation."""
    if cfg.max_bucket + 1 >= (1 << CNT_BITS):
        raise ValueError(f"max_bucket must be < {(1 << CNT_BITS) - 1} "
                         "to fit the packed count field")
    if index.qtable is not None and not extras:
        return _shard_from_table(index.qtable, n_shards, index.n_buckets,
                                 cfg, load, seed)
    p12, s8, cnt_f, pos_f, cnt_r, pos_r, st_f, st_r = canonical_keys(index)
    nb = index.n_buckets
    S = -(-nb // n_shards)
    bounds = np.searchsorted(p12, np.arange(n_shards + 1) * S)
    parts = []
    for i in range(n_shards):
        lo, hi = bounds[i], bounds[i + 1]
        parts.append(_build_from_keys(
            p12[lo:hi], s8[lo:hi], cnt_f[lo:hi], pos_f[lo:hi],
            cnt_r[lo:hi], pos_r[lo:hi], st_f[lo:hi], st_r[lo:hi],
            load=load, seed=seed + i, max_bucket=cfg.max_bucket,
            positions=index.positions if extras else None,
            max_pair_hits=cfg.max_pair_hits))
    T_pad = max(qt.table.shape[0] for qt in parts)
    tables = np.full((n_shards, T_pad, SLOTS * LANES), EMPTY_KEY, np.int32)
    metas = np.zeros((n_shards, 3), np.int32)
    for i, qt in enumerate(parts):
        tables[i, :qt.table.shape[0]] = qt.table
        metas[i] = qt.meta
    if not extras:
        return tables, metas
    K = cfg.max_pair_hits
    R_pad = max(qt.ext.shape[0] for qt in parts)
    exts = np.full((n_shards, R_pad, 2 * (K - 1)), LARGE_POS, np.uint32)
    ext_ids = np.zeros((n_shards, T_pad, SLOTS), np.int32)
    for i, qt in enumerate(parts):
        exts[i, :qt.ext.shape[0]] = qt.ext
        ext_ids[i, :qt.ext_id.shape[0]] = qt.ext_id
    return tables, metas, exts, ext_ids
