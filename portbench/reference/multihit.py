"""Vectorized host multi-hit path (SPEC.md §2b), bit-identical to
`models.oracle.call_read`.

The device flags reads whose anchors tie at the best mismatch level
(`multi`, ops/detect.detect_core); those route to a host pair
exploration. Round-2 measurement: the per-candidate oracle costs ~32 ms
per multi read (repeat-rich libraries are ~15-20% multi), dominating
end-to-end throughput. This module reimplements the same frozen
semantics with numpy vectorization over variants (anchor statistics),
candidates (prefilter extensions) and pairs×splits (breakpoint search,
prefix sums exactly like ops/breakpoint.py) — ~20x faster per read. The
oracle stays the per-candidate ground truth; tests/test_multihit.py
asserts field-level equality on repeat-heavy libraries.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.config import (
    Config,
    KIND_CIRCULAR,
    KIND_LINEAR,
    SENSE_MINUS,
    SENSE_PLUS,
    ST_ANCHOR_OVERLAP,
    ST_DIFF_CHROM,
    ST_DIFF_STRAND,
    ST_JUNCTION,
    ST_NO_JUNCTION,
    ST_PREFILTERED,
    ST_TOO_LONG,
    ST_TOO_SHORT,
    ST_UNALIGNED_A,
    ST_UNALIGNED_B,
)
from portbench.reference.seedindex import SeedIndex
from portbench.reference.genome import Genome
from portbench.reference.twobit import REVCOMP_LUT, seq_to_codes
from portbench.reference.oracle import (AnchorHit, ReadCall,
                                               _sense_signal)

_G, _T, _A, _C = 2, 3, 0, 1


def _enum_pattern(a: int, pk: int, ball: int):
    """Static per-(a, pk, ball) enumeration scaffolding, cached.

    Returns (wp, ws, js, r, j1, j2, r1, r2, mm): place-value weights per
    digit (prefix / suffix) and the substitution index patterns of the
    oracle's enumeration order (1-mm: position-major, r=1..3; 2-mm:
    (j1, j2, r1, r2) nested loops exactly as oracle.anchor_candidates)."""
    key = (a, pk, ball)
    pat = _ENUM_CACHE.get(key)
    if pat is not None:
        return pat
    j = np.arange(a)
    wp = np.where(j < pk, 4 ** np.clip(pk - 1 - j, 0, None),
                  0).astype(np.int64)
    ws = np.where(j >= pk, 4 ** np.clip(a - 1 - j, 0, a - pk - 1),
                  0).astype(np.int64)
    js = np.repeat(np.arange(a), 3)
    r = np.tile(np.arange(1, 4), a)
    mm = np.concatenate([[0], np.ones(3 * a, np.int64)])
    j1 = j2 = r1 = r2 = None
    if ball >= 2:
        j1, j2 = np.triu_indices(a, k=1)
        P = j1.size                                # a*(a-1)/2 pairs
        j1 = np.repeat(j1, 9)
        j2 = np.repeat(j2, 9)
        r1 = np.tile(np.repeat(np.arange(1, 4), 3), P)
        r2 = np.tile(np.tile(np.arange(1, 4), 3), P)
        mm = np.concatenate([mm, np.full(9 * P, 2, np.int64)])
    pat = (wp, ws, js, r, j1, j2, r1, r2, mm)
    _ENUM_CACHE[key] = pat
    return pat


_ENUM_CACHE: dict = {}


def _variant_keys(q: np.ndarray, pk: int, ball: int = 1
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p12, s8, mm) int64 [V] for the exact query + all variants within
    Hamming distance `ball`, in the oracle's enumeration order.

    Computed as weighted digit deltas off the exact key (a substitution
    at position j moves the key by (b - q_j) * weight[j]) — O(V) instead
    of the O(V*a) variant-matrix matmul; bit-identical output."""
    a = q.size
    wp, ws, js, r, j1, j2, r1, r2, mm = _enum_pattern(a, pk, ball)
    q64 = q.astype(np.int64)
    base_p = q64 @ wp
    base_s = q64 @ ws
    d = (q64[js] + r) % 4 - q64[js]
    p12 = np.concatenate([[base_p], base_p + d * wp[js]])
    s8 = np.concatenate([[base_s], base_s + d * ws[js]])
    if ball >= 2:
        d1 = (q64[j1] + r1) % 4 - q64[j1]
        d2 = (q64[j2] + r2) % 4 - q64[j2]
        p12 = np.concatenate([p12, base_p + d1 * wp[j1] + d2 * wp[j2]])
        s8 = np.concatenate([s8, base_s + d1 * ws[j1] + d2 * ws[j2]])
    return p12, s8, mm


def _segmented_searchsorted(sv: np.ndarray, lo_b: np.ndarray,
                            hi_b: np.ndarray, keys: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized per-row searchsorted: (left, right) insertion points of
    keys[i] within the sorted segment sv[lo_b[i]:hi_b[i]].

    Branchless binary search over all rows at once — vectorized rounds
    instead of one Python searchsorted per row (the pre-r5 form cost
    ~5 ms per 2-mm rescue read, 91% of end-to-end pipeline wall at r4;
    see BENCH_r04 stage table). Two tricks keep the vector work near the
    information-theoretic minimum: (a) on integer keys right_insertion(k)
    == left_insertion(k+1), so ONE combined program computes both
    bounds; (b) rows that converge (prefix buckets average ~4 entries;
    only repeat-heavy buckets need many rounds) are compacted out of the
    active set, so late rounds touch only the few large segments."""
    K = keys.size
    lo = np.tile(lo_b.astype(np.int64), 2)
    hi_a = np.tile(hi_b.astype(np.int64), 2)
    k_a = np.concatenate([keys, keys + 1])
    act = np.flatnonzero(lo < hi_a)
    lo_a = lo[act]
    hi_a = hi_a[act]
    k_a = k_a[act]
    while act.size:
        # Active rows have lo < hi <= sv.size, so mid is in-bounds.
        mid = (lo_a + hi_a) >> 1
        go = sv[mid] < k_a
        lo_a = np.where(go, mid + 1, lo_a)
        hi_a = np.where(go, hi_a, mid)
        live = lo_a < hi_a
        n_live = int(live.sum())
        if n_live != act.size:
            lo[act] = lo_a
            keep = np.flatnonzero(live)
            act = act[keep]
            lo_a = lo_a[keep]
            hi_a = hi_a[keep]
            k_a = k_a[keep]
    return lo[:K], lo[K:]


def anchor_candidates_fast(genome: Genome, index: SeedIndex,
                           anchor: np.ndarray, cfg: Config, ball: int = 1
                           ) -> tuple[AnchorHit, list[tuple[int, int]]]:
    """Drop-in equivalent of oracle.anchor_candidates (SPEC §2/§2b,
    incl. the [FROZEN v4] ball=2 rescue enumeration)."""
    a, pk = cfg.anchor_len, cfg.prefix_len
    if np.any(anchor >= 4):
        return AnchorHit(aligned=False), []
    rc = REVCOMP_LUT[anchor[::-1]]
    p12s, s8s, mms = [], [], []
    for q in (anchor, rc):
        p12, s8, mm1 = _variant_keys(q, pk, ball)
        p12s.append(p12)
        s8s.append(s8)
        mms.append(mm1)
    p12 = np.concatenate(p12s)          # [2V]: '+' variants then '-'
    s8 = np.concatenate(s8s)
    mm = np.concatenate(mms)
    V = p12s[0].size
    strand = np.repeat(np.arange(2, dtype=np.int64), V)

    offs = index.offsets          # uint32 [4^pk + 1]; never copy (16M+)
    sv = index.suffix_vals
    lo_b = offs[p12].astype(np.int64)
    hi_b = offs[p12 + 1].astype(np.int64)
    lo, hi = _segmented_searchsorted(sv, lo_b, hi_b, s8)
    count = hi - lo
    # Empty or repetitive-20-mer guard [FROZEN]: contributes nothing.
    valid = (count > 0) & (count <= cfg.max_bucket)
    if not valid.any():
        return AnchorHit(aligned=False), []
    first = np.where(valid, index.positions[np.minimum(
        lo, index.positions.size - 1)].astype(np.int64), 0)
    # Best variant: lexicographic min of (mm, strand, first_pos) over
    # valid variants (variant position sets are disjoint, so ties below
    # the position level cannot occur).
    key = ((mm * 2 + strand) << np.int64(33)) | first
    key = np.where(valid, key, np.int64(1) << 62)
    b = int(np.argmin(key))
    best_mm = int(mm[b])
    n_best = int(count[valid & (mm == best_mm)].sum())
    if n_best > 1:
        second_mm = best_mm
    else:
        others = valid.copy()
        others[b] = False
        second_mm = int(mm[others].min()) if others.any() else a + 1
    qual = 0 if n_best > 1 else min(40, 10 * (second_mm - best_mm))
    hit = AnchorHit(aligned=best_mm <= max(cfg.max_anchor_mm, ball),
                    pos=int(first[b]), strand=int(strand[b]), mm=best_mm,
                    n_best=n_best, second_mm=second_mm, qual=qual)
    at_best = np.flatnonzero(valid & (mm == best_mm))
    pairs = sorted((int(strand[i]), int(p))
                   for i in at_best
                   for p in index.positions[lo[i]:hi[i]])
    return hit, pairs[:cfg.max_pair_hits]


def _variant_keys_batch(Q: np.ndarray, pk: int, ball: int = 1
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """_variant_keys over a batch of anchors Q [N, a]: returns
    (p12 [N, V], s8 [N, V], mm [V]) — row-wise identical."""
    _, a = Q.shape
    wp, ws, js, r, j1, j2, r1, r2, mm = _enum_pattern(a, pk, ball)
    Q64 = Q.astype(np.int64)
    base_p = Q64 @ wp
    base_s = Q64 @ ws
    qj = Q64[:, js]
    d = (qj + r) % 4 - qj
    p12 = np.concatenate([base_p[:, None], base_p[:, None] + d * wp[js]],
                         axis=1)
    s8 = np.concatenate([base_s[:, None], base_s[:, None] + d * ws[js]],
                        axis=1)
    if ball >= 2:
        q1 = Q64[:, j1]
        q2 = Q64[:, j2]
        d1 = (q1 + r1) % 4 - q1
        d2 = (q2 + r2) % 4 - q2
        p12 = np.concatenate(
            [p12, base_p[:, None] + d1 * wp[j1] + d2 * wp[j2]], axis=1)
        s8 = np.concatenate(
            [s8, base_s[:, None] + d1 * ws[j1] + d2 * ws[j2]], axis=1)
    return p12, s8, mm


def anchor_candidates_batch(genome: Genome, index: SeedIndex,
                            Q: np.ndarray, cfg: Config, ball: int = 1):
    """Batched anchor_candidates_fast over anchors Q (uint8 [N, a]).

    Returns (hits: list[AnchorHit], pairs: list[list[(strand, pos)]]),
    row-wise identical to N separate anchor_candidates_fast calls —
    ONE vectorized segmented binary search over all N * 2V variant keys
    instead of N python calls (the r5 batched-rescue path;
    tests/test_multihit.py asserts element-wise equality)."""
    N, a = Q.shape
    pk = cfg.prefix_len
    hits: list = [None] * N
    pairs_out: list = [None] * N
    dirty = (Q >= 4).any(axis=1)
    for i in np.flatnonzero(dirty):
        hits[i] = AnchorHit(aligned=False)
        pairs_out[i] = []
    ok = np.flatnonzero(~dirty)
    if ok.size == 0:
        return hits, pairs_out
    Qo = Q[ok]
    RC = REVCOMP_LUT[Qo[:, ::-1]]
    p12f, s8f, mm1 = _variant_keys_batch(Qo, pk, ball)
    p12r, s8r, _ = _variant_keys_batch(RC, pk, ball)
    p12 = np.concatenate([p12f, p12r], axis=1)          # [M, 2V]
    s8 = np.concatenate([s8f, s8r], axis=1)
    mm = np.concatenate([mm1, mm1])
    V = mm1.size
    strand = np.repeat(np.arange(2, dtype=np.int64), V)

    offs = index.offsets
    sv = index.suffix_vals
    fp = p12.reshape(-1)
    lo, hi = _segmented_searchsorted(sv, offs[fp].astype(np.int64),
                                     offs[fp + 1].astype(np.int64),
                                     s8.reshape(-1))
    M, W = p12.shape
    lo = lo.reshape(M, W)
    hi = hi.reshape(M, W)
    count = hi - lo
    valid = (count > 0) & (count <= cfg.max_bucket)
    positions = index.positions
    # Gather first positions ONLY for valid variants (a few % of the
    # 2-mm ball) and pack them into the lexicographic key; the winning
    # position is recovered from the key's low 33 bits, so the full
    # [M, W] first-position gather disappears.
    vi, vj = np.nonzero(valid)
    key = np.full((M, W), np.int64(1) << 62)
    key[vi, vj] = (((mm[vj] * 2 + strand[vj]) << np.int64(33))
                   | positions[lo[vi, vj]].astype(np.int64))
    b = np.argmin(key, axis=1)
    rows = np.arange(M)
    best_mm = mm[b]
    pos_b = key[rows, b] & ((np.int64(1) << 33) - 1)
    sel_best = valid & (mm[None, :] == best_mm[:, None])
    n_best = (count * sel_best).sum(axis=1)
    others = valid.copy()
    others[rows, b] = False
    mm_o = np.where(others, mm[None, :], np.int64(1) << 40)
    second_mm = np.where(n_best > 1, best_mm,
                         np.where(others.any(axis=1), mm_o.min(axis=1),
                                  a + 1))
    qual = np.where(n_best > 1, 0,
                    np.minimum(40, 10 * (second_mm - best_mm)))
    has = valid.any(axis=1)
    aligned = (best_mm <= max(cfg.max_anchor_mm, ball)) & has
    K = cfg.max_pair_hits
    # Candidate pair lists, vectorized: expand every best-mm variant's
    # position run [lo, hi) in one ragged gather, lexsort globally by
    # (read, strand, pos) — identical to the old per-read
    # sorted((strand, pos)) since variant position sets are disjoint —
    # then slice the first K per read.
    mi, vi = np.nonzero(sel_best)
    c = count[mi, vi]
    tot = int(c.sum())
    if tot:
        k_of = np.repeat(np.arange(c.size), c)
        cs = np.concatenate([[0], np.cumsum(c)[:-1]])
        flat = lo[mi, vi][k_of] + (np.arange(tot) - cs[k_of])
        pos_f = positions[flat].astype(np.int64)
        str_f = strand[vi][k_of]
        m_f = mi[k_of]
        order = np.lexsort((pos_f, str_f, m_f))
        pos_l = pos_f[order].tolist()
        str_l = str_f[order].tolist()
        bounds = np.searchsorted(m_f[order], np.arange(M + 1))
    else:
        bounds = np.zeros(M + 1, np.int64)
        pos_l = str_l = []
    for m, i in enumerate(ok):
        if not has[m]:
            hits[i] = AnchorHit(aligned=False)
            pairs_out[i] = []
            continue
        hits[i] = AnchorHit(
            aligned=bool(aligned[m]), pos=int(pos_b[m]),
            strand=int(strand[b[m]]), mm=int(best_mm[m]),
            n_best=int(n_best[m]), second_mm=int(second_mm[m]),
            qual=int(qual[m]))
        s, e = int(bounds[m]), int(bounds[m + 1])
        e = min(e, s + K)
        pairs_out[i] = list(zip(str_l[s:e], pos_l[s:e]))
    return hits, pairs_out


def call_reads_multi_batch(genome: Genome, index: SeedIndex, items,
                           cfg: Config, prefilter: bool = True
                           ) -> list[ReadCall]:
    """Batched call_read_multi over `items` = [(name, seq)] — element-
    wise identical output, but candidate searches (the dominant cost,
    91% of r4 pipeline wall) run as at most two vectorized programs:
    one ball-1 search over both anchors of every read, one ball-2 search
    over the mate-gated rescue subset [FROZEN v4 semantics]."""
    a = cfg.anchor_len
    out: list = [None] * len(items)
    work = []
    for i, (name, seq) in enumerate(items):
        l = len(seq)
        if l < 2 * a:
            out[i] = ReadCall(name, seq, ST_TOO_SHORT)
        elif l > cfg.max_read_len:
            out[i] = ReadCall(name, seq, ST_TOO_LONG)
        else:
            work.append(i)
    if not work:
        return out
    codes_list = [seq_to_codes(items[i][1]) for i in work]
    QA = np.stack([c[:a] for c in codes_list])
    QB = np.stack([c[-a:] for c in codes_list])
    N = len(work)
    hits, cands = anchor_candidates_batch(
        genome, index, np.concatenate([QA, QB]), cfg)
    hitsA, hitsB = hits[:N], hits[N:]
    candsA, candsB = cands[:N], cands[N:]
    if cfg.rescue_anchor_mm >= 2:
        needA = [m for m in range(N)
                 if not hitsA[m].aligned and hitsB[m].aligned]
        needB = [m for m in range(N)
                 if not hitsB[m].aligned and hitsA[m].aligned]
        if needA or needB:
            h2, c2 = anchor_candidates_batch(
                genome, index, np.concatenate([QA[needA], QB[needB]]),
                cfg, ball=2)
            for k, m in enumerate(needA):
                hitsA[m], candsA[m] = h2[k], c2[k]
            for k, m in enumerate(needB):
                hitsB[m] = h2[len(needA) + k]
                candsB[m] = c2[len(needA) + k]
    for m, i in enumerate(work):
        name, seq = items[i]
        codes = codes_list[m]
        out[i] = _finish_call(genome, name, seq, codes,
                              REVCOMP_LUT[codes[::-1]], hitsA[m],
                              candsA[m], hitsB[m], candsB[m], cfg,
                              prefilter)
    return out


def _window_mm(G: np.ndarray, starts: np.ndarray, query: np.ndarray
               ) -> np.ndarray:
    """Hamming(query, G[start:start+l]) per start (codes >=4 mismatch)."""
    l = query.size
    win = G[starts[:, None] + np.arange(l)[None, :]]
    q = query[None, :]
    return ((q != win) | (q >= 4) | (win >= 4)).sum(axis=1)


def _prefiltered(genome: Genome, codes, codes_rc, candsA, candsB,
                 cfg: Config) -> bool:
    """SPEC §2b prefilter: ANY candidate extends contiguously (§6)."""
    G = genome.codes
    l, a = codes.size, cfg.anchor_len
    for cands, side in ((candsA, "A"), (candsB, "B")):
        if not cands:
            continue
        s = np.asarray([c[0] for c in cands], np.int64)
        p = np.asarray([c[1] for c in cands], np.int64)
        # §6 geometries: A+: G[p:p+l] vs R; A-: G[p+a-l:p+a] vs R';
        # B+: G[p+a-l:p+a] vs R; B-: G[p:p+l] vs R'.
        plus_at_p = (side == "A")
        starts = np.where((s == 0) == plus_at_p, p, p + a - l)
        for st in (0, 1):
            m = s == st
            if not m.any():
                continue
            q = codes if st == 0 else codes_rc
            if (_window_mm(G, starts[m], q) <= cfg.prefilter_mm).any():
                return True
    return False


def _explore_pairs(genome: Genome, codes, codes_rc, candsA, candsB,
                   hitA: AnchorHit, hitB: AnchorHit, cfg: Config):
    """SPEC §2b pair exploration, vectorized over pairs x splits.

    Returns (align_strand, pA, pB, qual_left, qual_right,
    (kind, start, end, edits, n_bp, best_bp)) of the winning pair, or
    None. Matches oracle.call_read's loop exactly: winning pair =
    lexicographic min of (edits, !canon+, !canon-, pA, pB) [FROZEN]."""
    G = genome.codes
    l, a = codes.size, cfg.anchor_len
    wins = []
    for st in (0, 1):
        pa_list = [p for s, p in (candsA if st == 0 else candsB)
                   if s == st]
        pb_list = [p for s, p in (candsB if st == 0 else candsA)
                   if s == st]
        if not pa_list or not pb_list:
            continue
        # Strand canonicalization [FROZEN] SPEC §3: '-' pairs swap roles.
        R = codes if st == 0 else codes_rc
        quals = ((hitA.qual, hitB.qual) if st == 0
                 else (hitB.qual, hitA.qual))
        pA = np.repeat(np.asarray(pa_list, np.int64), len(pb_list))
        pB = np.tile(np.asarray(pb_list, np.int64), len(pa_list))
        ok = np.asarray(genome.chrom_of(pA)) == \
            np.asarray(genome.chrom_of(pB))
        endB = pB + a
        linear = pA + a <= pB
        circular = endB <= pA
        ok &= linear | circular
        if not ok.any():
            continue
        pA, pB, endB = pA[ok], pB[ok], endB[ok]
        kind = np.where(endB <= pA, KIND_CIRCULAR, KIND_LINEAR)
        P = pA.size
        # Windows of l+2: left piece + donor dinuc, right piece + acceptor
        # dinuc (gap padding >= max_read_len+2 keeps these in-bounds).
        GA = G[pA[:, None] + np.arange(l + 2)[None, :]].astype(np.int64)
        GB = G[(endB - l - 2)[:, None]
               + np.arange(l + 2)[None, :]].astype(np.int64)
        Rq = R[None, :].astype(np.int64)
        neqA = (Rq != GA[:, :l]) | (Rq >= 4) | (GA[:, :l] >= 4)
        neqB = (Rq != GB[:, 2:]) | (Rq >= 4) | (GB[:, 2:] >= 4)
        prefA = np.zeros((P, l + 1), np.int64)
        prefB = np.zeros((P, l + 1), np.int64)
        np.cumsum(neqA, axis=1, out=prefA[:, 1:])
        np.cumsum(neqB, axis=1, out=prefB[:, 1:])
        score = prefA + (prefB[:, l:l + 1] - prefB)     # [P, l+1] at k
        k = np.arange(l + 1)[None, :]
        k_valid = (k >= a) & (k <= l - a)
        BIG = np.int64(1 << 40)
        score = np.where(k_valid, score, BIG)
        edits = score.min(axis=1)
        n_bp = ((score == edits[:, None]) & k_valid).sum(axis=1)
        # Signal dinucs per split, exactly as ops/breakpoint.py: donor
        # dinuc = GA[k:k+2], acceptor dinuc = GB[k:k+2].
        d0, d1 = GA[:, :l + 1], GA[:, 1:l + 2]
        a0, a1 = GB[:, :l + 1], GB[:, 1:l + 2]
        canon_p = (d0 == _G) & (d1 == _T) & (a0 == _A) & (a1 == _G)
        canon_m = (d0 == _C) & (d1 == _T) & (a0 == _A) & (a1 == _C)
        # Frozen split tie-break: (score, !canon+, !canon-, k).
        tkey = ((score * 2 + ~canon_p) * 2 + ~canon_m) * (l + 2) + k
        tkey = np.where(k_valid, tkey, BIG * (l + 2))
        best_k = tkey.argmin(axis=1)
        rows = np.arange(P)
        donor = pA + best_k
        acceptor = endB - (l - best_k)
        start = np.where(kind == KIND_CIRCULAR, acceptor, donor)
        end = np.where(kind == KIND_CIRCULAR, donor, acceptor)
        viable = ~((kind == KIND_LINEAR) & (end <= start))
        cp = canon_p[rows, best_k]
        cm = canon_m[rows, best_k]
        for i in np.flatnonzero(viable):
            wins.append(((int(edits[i]), not cp[i], not cm[i],
                          int(pA[i]), int(pB[i])),
                         (st, int(pA[i]), int(pB[i]), quals[0], quals[1],
                          (int(kind[i]), int(start[i]), int(end[i]),
                           int(edits[i]), int(n_bp[i]),
                           int(best_k[i])))))
    if not wins:
        return None
    win = min(wins, key=lambda w: w[0])[1]
    if cfg.pair_rescue and (hitA.n_best > 1 or hitB.n_best > 1):
        # Pair-margin bridge rescue [FROZEN v4], exactly as
        # oracle.call_read: margin vs the best explored pair at a
        # different (kind, start, end).
        kind, start, end, w_edits = win[5][0], win[5][1], win[5][2], \
            win[5][3]
        alts = [w[5][3] for _, w in wins
                if (w[5][0], w[5][1], w[5][2]) != (kind, start, end)]
        margin = (min(alts) - w_edits) if alts else (a + 1)
        if margin > 0:
            rq = min(40, 10 * margin)
            win = (win[0], win[1], win[2], max(win[3], rq),
                   max(win[4], rq), win[5])
    return win


def call_read_multi(genome: Genome, index: SeedIndex, name: str,
                    seq: str, cfg: Config,
                    prefilter: bool = True) -> ReadCall:
    """Vectorized twin of oracle.call_read (SPEC §2-§4 + §2b)."""
    l = len(seq)
    a = cfg.anchor_len
    if l < 2 * a:
        return ReadCall(name, seq, ST_TOO_SHORT)
    if l > cfg.max_read_len:
        return ReadCall(name, seq, ST_TOO_LONG)
    codes = seq_to_codes(seq)
    codes_rc = REVCOMP_LUT[codes[::-1]]
    hitA, candsA = anchor_candidates_fast(genome, index, codes[:a], cfg)
    hitB, candsB = anchor_candidates_fast(genome, index, codes[-a:], cfg)
    # §2 2-mm anchor rescue [FROZEN v4], gated exactly as
    # oracle.call_read (mate must align at <=1 mm).
    if cfg.rescue_anchor_mm >= 2:
        if not hitA.aligned and hitB.aligned:
            hitA, candsA = anchor_candidates_fast(genome, index,
                                                  codes[:a], cfg, ball=2)
        elif not hitB.aligned and hitA.aligned:
            hitB, candsB = anchor_candidates_fast(genome, index,
                                                  codes[-a:], cfg,
                                                  ball=2)
    return _finish_call(genome, name, seq, codes, codes_rc, hitA, candsA,
                        hitB, candsB, cfg, prefilter)


def _finish_call(genome: Genome, name: str, seq: str, codes, codes_rc,
                 hitA: AnchorHit, candsA, hitB: AnchorHit, candsB,
                 cfg: Config, prefilter: bool) -> ReadCall:
    """Shared tail of call_read_multi after anchor candidate generation:
    prefilter, status chain, pair exploration, junction assembly."""
    l = codes.size
    a = cfg.anchor_len
    if prefilter and _prefiltered(genome, codes, codes_rc, candsA,
                                  candsB, cfg):
        return ReadCall(name, seq, ST_PREFILTERED)
    if not hitA.aligned:
        return ReadCall(name, seq, ST_UNALIGNED_A)
    if not hitB.aligned:
        return ReadCall(name, seq, ST_UNALIGNED_B)

    best = _explore_pairs(genome, codes, codes_rc, candsA, candsB,
                          hitA, hitB, cfg)
    if best is not None:
        s, pA, pB, qual_left, qual_right, pj = best
        kind, start, end, edits, n_bp, best_bp = pj
        endB = pB + a
        sense, signal = _sense_signal(genome.codes, kind, start, end, s)
        seg1 = (pA, pA + best_bp)
        seg2 = (endB - (l - best_bp), endB)
        overlap = max(0, min(seg1[1], seg2[1]) - max(seg1[0], seg2[0]))
        return ReadCall(
            name=name, seq=seq, status=ST_JUNCTION, kind=kind,
            chrom_idx=int(genome.chrom_of(pA)), start=start, end=end,
            sense=sense, align_strand=s, edits=edits, n_bp=n_bp,
            overlap=overlap, qual_left=qual_left, qual_right=qual_right,
            signal=signal,
        )

    # Fallback [FROZEN]: v2 single-best status chain.
    if hitA.strand != hitB.strand:
        return ReadCall(name, seq, ST_DIFF_STRAND)
    if int(genome.chrom_of(hitA.pos)) != int(genome.chrom_of(hitB.pos)):
        return ReadCall(name, seq, ST_DIFF_CHROM)
    s = hitA.strand
    pA, pB = ((hitA.pos, hitB.pos) if s == 0 else (hitB.pos, hitA.pos))
    endB = pB + a
    if pA + a <= pB or endB <= pA:
        return ReadCall(name, seq, ST_NO_JUNCTION)
    return ReadCall(name, seq, ST_ANCHOR_OVERLAP)
