"""K-g: §2b multi-hit pair exploration (reference:
find_circ2_tpu/ops/explore.py; SPEC.md §2b fixes the semantics).

A read whose anchor ties at the best mismatch level is re-called over
its anchors' first K = `max_pair_hits` hits in (strand, position) order:
every pairing of an anchor-A candidate with an anchor-B candidate on the
same strand and chromosome, every split of the read, the frozen split
and pair tie-breaks, then the v2 single-best status chain for reads with
no viable pair. Each candidate has exactly one pairing role (left or
right piece), so one (Lp+2)-wide genome window per candidate serves its
prefix sums, its full-read prefilter count and its splice dinucleotides.

On the card K1 (`explore_k1`: both anchors in one launch of
ops/anchor_align.classic_anchor_stats, csrc/classic_k1.cu) and
everything after it (`explore_pairs`) are one hand-written CUDA kernel
each per chunk (csrc/explore.cu, one thread block per read, its stages
at warp level: csrc/explore.cu's header says why); a CPU tensor takes
the plain versions, `explore_pairs_ref` here. In the plain version
the reference's bf16 triangular-ones matmul prefix sums are an int32
`cumsum`, which is exact. Global positions are int64 holding the
reference's uint32 values; every sum that wraps in uint32 there is masked
with `& 0xFFFFFFFF` here (invalid lanes hold LARGE_POS, and LARGE_POS + a
wraps to a - 1). Its [B, K, K, Lp+1] split grid stays int32 and is updated
in place.
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.config import (
    RPAD_CODE,
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
    ST_UNALIGNED_A,
    ST_UNALIGNED_B,
)
from find_circ2_tpu_torch.index.hashtable import M32
from find_circ2_tpu_torch.ops.anchor_align import (LARGE_POS, AnchorHits,
                                                   classic_anchor_stats,
                                                   read_anchors,
                                                   variant_metadata)
from find_circ2_tpu_torch.ops.breakpoint import as_int32
from find_circ2_tpu_torch.ops.detect import _pack
from find_circ2_tpu_torch.ops.packed import gather_window

_A, _C, _G, _T = 0, 1, 2, 3
BIG = 1 << 20
# The kernel's limits: its block flags one (i, j) pair a thread, 256
# threads; a warp pair holds one strand's V * K list lanes in registers,
# 16 a lane; its split rows are int16.
MAX_PAIR_HITS = 16
MAX_LIST_LANES = 1024
MAX_READ_LEN = 4096

# Kernel launches of explore_pairs since the last reset (set to 0 to
# reset).
launches = 0


def merged_candidates(count, first_pos, extras, mm_v, best_mm,
                      cfg: Config):
    """First-K (strand, position) hits at the best mm [FROZEN §2b order].

    count/first_pos: [B, 2V] per-strand-slot stats; extras: int64
    [B, 2V, K-1] positions 2..K of each slot's hit list; best_mm: [B]
    from finalize_hits. Returns (pos int64 [B, K], strand int32 [B, K],
    valid bool [B, K]); invalid lanes hold LARGE_POS and strand 0."""
    B, V2 = count.shape
    V = V2 // 2
    K = cfg.max_pair_hits
    dev = count.device
    lane = torch.arange(K, device=dev)
    cand = torch.cat([first_pos[..., None], extras], dim=-1)   # [B, 2V, K]
    at_best = (mm_v[None, :] == best_mm[:, None]) & (count > 0)
    lane_ok = lane < torch.clamp(count, max=K)[..., None]
    cand = torch.where(at_best[..., None] & lane_ok, cand, LARGE_POS)
    # Per-variant lists ascend, so each strand's first K live inside the
    # per-variant K-prefixes; a position holds one 20-mer, so positions
    # are distinct across one strand's variants and need no dedup.
    plus = cand[:, :V].reshape(B, V * K).sort(-1).values[:, :K]
    minus = cand[:, V:].reshape(B, V * K).sort(-1).values[:, :K]
    # Merge in frozen order ('+' entries before '-'), capped at K:
    # compact the valid entries of [plus, minus] by rank.
    both = torch.cat([plus, minus], dim=1)                    # [B, 2K]
    strand2k = torch.arange(2, device=dev).repeat_interleave(K)
    ok2k = both != LARGE_POS
    rank = torch.cumsum(ok2k, 1) - 1
    sel = ok2k[:, None, :] & (rank[:, None, :] == lane[None, :, None])
    valid = sel.any(-1)
    pos = torch.where(valid, torch.where(sel, both[:, None, :], 0).sum(-1),
                      LARGE_POS)
    strand = torch.where(sel, strand2k, 0).sum(-1).to(torch.int32)
    return pos, strand, valid


def _candidate_side(words, nbases: int, pos, strand, lens, R32, rc32,
                    in_read, is_A: bool, cfg: Config) -> dict:
    """Per-candidate role window, prefix sums and dinucleotide flags.

    A candidate is the LEFT piece iff (anchor A and '+') or (anchor B
    and '-') — SPEC §3 strand canonicalization — so its window is
    G[p : p+Lp+2]; a RIGHT piece reads G[p+a-l-2 : p+a-l+Lp] (the layout
    of ops/breakpoint.py's GA and GBw). The full-read §6 prefilter
    geometry is the same window and query, so `tot` doubles as the §2b
    extension mismatch count."""
    Lp = R32.shape[1]
    a = cfg.anchor_len
    role_left = (strand == 0) if is_A else (strand == 1)
    start = torch.where(role_left, pos,
                        (pos + a - lens.to(torch.int64)[:, None] - 2) & M32)
    W = gather_window(words, torch.clamp(start, 0, nbases - (Lp + 2)),
                      Lp + 2)                                 # [B, K, Lp+2]
    Q = torch.where((strand == 0)[..., None], R32[:, None, :],
                    rc32[:, None, :])
    Wseg = torch.where(role_left[..., None], W[..., :Lp], W[..., 2:])
    neq = ((Q != Wseg) | (Q >= 4) | (Wseg >= 4)) & in_read[:, None, :]
    pref = torch.cumsum(neq, -1, dtype=torch.int32)
    # Splice-signal dinucleotides at split k: donor = W[k:k+2] of the
    # left role, acceptor = W[k:k+2] of the right role.
    w0, w1 = W[..., :Lp + 1], W[..., 1:Lp + 2]
    return dict(
        W=W, prefx=torch.nn.functional.pad(pref, (1, 0)),  # mm(:k)
        tot=pref[..., Lp - 1],                             # full read (§6)
        cpL=(w0 == _G) & (w1 == _T), cmL=(w0 == _C) & (w1 == _T),
        cpR=(w0 == _A) & (w1 == _G), cmR=(w0 == _A) & (w1 == _C))


def explore_core(words, nbases: int, chrom_offsets, reads, lens, hits_a,
                 hits_b, posA, strA, valA, posB, strB, valB, cfg: Config,
                 prefilter: bool) -> dict:
    """§2b per-read resolution given merged candidate lists: prefilter
    over all candidates, the K x K pair grid with the frozen tie-breaks,
    the v2 single-best fallback chain and the pair-margin rescue qual.
    Output dict as ops/detect.detect_core (multi == 0: final)."""
    B, Lp = reads.shape
    a = cfg.anchor_len
    K = cfg.max_pair_hits
    dev = reads.device
    lens_u = lens.to(torch.int64)
    pos_ax = torch.arange(Lp, device=dev)[None, :]
    in_read = pos_ax < lens_u[:, None]

    R32 = reads.to(torch.int32)
    rc32 = torch.gather(R32, 1, torch.clamp(lens_u[:, None] - 1 - pos_ax,
                                            0, Lp - 1))
    rc32 = torch.where(rc32 < 4, 3 - rc32, rc32)
    rc32 = torch.where(in_read, rc32, RPAD_CODE)

    SA = _candidate_side(words, nbases, posA, strA, lens, R32, rc32,
                         in_read, True, cfg)
    SB = _candidate_side(words, nbases, posB, strB, lens, R32, rc32,
                         in_read, False, cfg)

    # --- §2b prefilter: ANY candidate extending contiguously (§6) ------
    contig = ((valA & (SA["tot"] <= cfg.prefilter_mm)).any(1)
              | (valB & (SB["tot"] <= cfg.prefilter_mm)).any(1))

    # --- K x K pair grid [B, K(A), K(B)] --------------------------------
    s = strA[:, :, None].expand(B, K, K)     # the common strand where ok
    strand_ok = ((strA[:, :, None] == strB[:, None, :])
                 & valA[:, :, None] & valB[:, None, :])
    is0 = s == 0
    # Strand canonicalization [FROZEN] SPEC §3: '-' pairs swap roles.
    pA = torch.where(is0, posA[:, :, None], posB[:, None, :])
    pB = torch.where(is0, posB[:, None, :], posA[:, :, None])
    endB = (pB + a) & M32
    linear = ((pA + a) & M32) <= pB
    circular = endB <= pA
    kind = torch.where(circular, KIND_CIRCULAR, KIND_LINEAR).to(torch.int32)
    chA = torch.searchsorted(chrom_offsets, pA, right=True) - 1
    chB = torch.searchsorted(chrom_offsets, pB, right=True) - 1
    pair_ok = strand_ok & (chA == chB) & (linear | circular)

    # --- §4 split scores for every pair, int32 [B, K, K, Lp+1] ----------
    # '+' pairs: mm_A(:k) + mm_B(k:); '-' pairs: mm_B(:k) + mm_A(k:).
    # Both are sign * (pfxA - pfxB) + (totB or totA), built in place.
    k_ax = torch.arange(Lp + 1, dtype=torch.int32, device=dev)
    is0k = is0[..., None]
    score = SA["prefx"][:, :, None, :] - SB["prefx"][:, None, :, :]
    score.mul_(torch.where(is0k, 1, -1).to(torch.int32))
    score.add_(torch.where(is0, SB["tot"][:, None, :],
                           SA["tot"][:, :, None])[..., None])
    k_valid = (k_ax >= a) & (k_ax[None, :] <= lens[:, None] - a)
    k_valid = k_valid[:, None, None, :]                   # [B, 1, 1, Lp+1]
    score.masked_fill_(~k_valid, BIG)
    edits = score.amin(-1)                                # [B, K, K]
    n_bp = ((score == edits[..., None]) & k_valid).sum(-1,
                                                       dtype=torch.int32)

    def pair_and(xA, xB, yA, yB):
        """Per split: '+' pairs xA & xB, '-' pairs yB & yA (the
        candidate flags [B, K, Lp+1] broadcast over the grid)."""
        return torch.where(is0k, xA[:, :, None, :] & xB[:, None, :, :],
                           yB[:, None, :, :] & yA[:, :, None, :])

    # Frozen split tie-break (score, !canon+, !canon-, k) as one packed
    # int32 key: score <= BIG, so key < (4 * BIG + 4) * (Lp+2) < 2^31.
    key = score.mul_(4)
    key.add_(pair_and(SA["cpL"], SB["cpR"], SA["cpR"], SB["cpL"])
             .logical_not_().to(torch.int32).mul_(2))
    key.add_(pair_and(SA["cmL"], SB["cmR"], SA["cmR"], SB["cmL"])
             .logical_not_().to(torch.int32))
    key.mul_(Lp + 2).add_(k_ax)
    key.masked_fill_(~k_valid, 2 ** 30)
    kmin = key.amin(-1)                                   # [B, K, K]
    del score, key
    best_k = kmin % (Lp + 2)
    rest = kmin // (Lp + 2)
    cm_b = (rest & 1) == 0
    cp_b = ((rest >> 1) & 1) == 0

    # Junction coordinates and viability at each pair's chosen split.
    ku = best_k.to(torch.int64)
    donor = (pA + ku) & M32
    acceptor = (endB + ku - lens_u[:, None, None]) & M32
    startj = torch.where(circular, acceptor, donor)
    endj = torch.where(circular, donor, acceptor)
    pair_ok = pair_ok & ~((kind == KIND_LINEAR) & (endj <= startj))

    # --- frozen pair tie-break: (edits, !c+, !c-, pA, pB), '+' pairs
    # first on full ties (oracle iteration order), as masked min passes.
    def flat(x):
        return x.reshape(B, K * K)

    ok = flat(pair_ok)
    for x, fill in ((edits * 4 + torch.where(cp_b, 0, 2)
                     + torch.where(cm_b, 0, 1), BIG),
                    (pA, LARGE_POS), (pB, LARGE_POS), (s, 2)):
        xf = torch.where(ok, flat(x), fill)
        ok = ok & (xf == xf.amin(1, keepdim=True))
    first = ok & (torch.cumsum(ok, 1) == 1)
    any_pair = ok.any(1)

    def pick(x):
        return torch.where(first, flat(x), 0).sum(1)

    kind_s, start_s, end_s = pick(kind), pick(startj), pick(endj)
    edits_s, k_s, s_s = pick(edits), pick(best_k), pick(s)
    pA_s, pB_s = pick(pA), pick(pB)
    cp_s = (first & flat(cp_b)).any(1)
    cm_s = (first & flat(cm_b)).any(1)

    # --- signal dinucleotides of the winning pair -----------------------
    f3 = first.reshape(B, K, K)
    WselA = torch.where(f3.any(2)[..., None], SA["W"], 0).sum(1)
    WselB = torch.where(f3.any(1)[..., None], SB["W"], 0).sum(1)
    left0 = (s_s == 0)[:, None]
    Wleft = torch.where(left0, WselA, WselB)
    Wright = torch.where(left0, WselB, WselA)

    def tk(W, off):
        idx = torch.clamp(k_s + off, 0, Lp + 1)
        return torch.gather(W, 1, idx[:, None])[:, 0]

    d0, d1 = tk(Wleft, 0), tk(Wleft, 1)
    a0, a1 = tk(Wright, 0), tk(Wright, 1)
    sense = torch.where(cp_s, SENSE_PLUS, torch.where(cm_s, SENSE_MINUS, s_s))

    def comp(x):
        return torch.where(x < 4, 3 - x, x)

    sig_p = torch.stack([d0, d1, a0, a1], dim=1)
    sig_m = torch.stack([comp(a1), comp(a0), comp(d1), comp(d0)], dim=1)
    signal = torch.where((sense == SENSE_MINUS)[:, None], sig_m, sig_p)

    # anchor_overlap at the winning split (SPEC §4): max(0, min_e - max_s).
    endB_s = (pB_s + a) & M32
    min_e = torch.minimum((pA_s + k_s) & M32, endB_s)
    max_s = torch.maximum(pA_s, (endB_s + k_s - lens_u) & M32)
    overlap = torch.where(min_e > max_s, min_e - max_s, 0)

    # --- status [FROZEN §2b priority]: prefiltered > unaligned_A >
    # unaligned_B > junction > v2 single-best fallback chain.
    ch_a1 = torch.searchsorted(chrom_offsets, hits_a.pos, right=True)
    ch_b1 = torch.searchsorted(chrom_offsets, hits_b.pos, right=True)
    minus1 = hits_a.strand == 1
    pA1 = torch.where(minus1, hits_b.pos, hits_a.pos)
    pB1 = torch.where(minus1, hits_a.pos, hits_b.pos)
    geom1 = (((pA1 + a) & M32) <= pB1) | (((pB1 + a) & M32) <= pA1)
    status = torch.where(
        hits_a.strand != hits_b.strand, ST_DIFF_STRAND,
        torch.where(ch_a1 != ch_b1, ST_DIFF_CHROM,
                    torch.where(geom1, ST_NO_JUNCTION, ST_ANCHOR_OVERLAP)))
    status = torch.where(any_pair, ST_JUNCTION, status)
    status = torch.where(~hits_b.aligned, ST_UNALIGNED_B, status)
    status = torch.where(~hits_a.aligned, ST_UNALIGNED_A, status)
    if prefilter:
        status = torch.where(contig, ST_PREFILTERED, status)

    qual_left = torch.where(s_s == 0, hits_a.qual, hits_b.qual)
    qual_right = torch.where(s_s == 0, hits_b.qual, hits_a.qual)
    if cfg.pair_rescue:
        # Pair-margin bridge rescue [FROZEN v4] (config.py pair_rescue),
        # as oracle.call_read: min edits over viable pairs at a DIFFERENT
        # (kind, start, end) than the winner; no competitor -> margin
        # a+1. Gated on the §2b multi condition, like detect_core's rows.
        diff = ((flat(kind) != kind_s[:, None])
                | (flat(startj) != start_s[:, None])
                | (flat(endj) != end_s[:, None]))
        alt = torch.where(flat(pair_ok) & diff, flat(edits), BIG).amin(1)
        margin = torch.where(alt >= BIG, a + 1, alt - edits_s)
        is_multi = (hits_a.n_best > 1) | (hits_b.n_best > 1)
        rq = torch.where(any_pair & is_multi & (margin > 0),
                         torch.clamp(10 * margin, max=40), 0)
        qual_left = torch.maximum(qual_left, rq)
        qual_right = torch.maximum(qual_right, rq)
    i32 = torch.int32
    return dict(
        status=status.to(i32), kind=kind_s.to(i32),
        chrom=pick(chA).to(i32), start=start_s, end=end_s,
        sense=sense.to(i32), align_strand=s_s.to(i32), edits=edits_s.to(i32),
        n_bp=pick(n_bp).to(i32), overlap=as_int32(overlap),
        qual_left=qual_left.to(i32), qual_right=qual_right.to(i32),
        multi=torch.zeros(B, dtype=i32, device=dev),
        signal=signal.to(i32))


def explore_pairs_ref(words, nbases: int, chrom_offsets, reads, lens,
                      stats_a, stats_b, hits_a, hits_b, mm_v, cfg: Config,
                      prefilter: bool = True) -> torch.Tensor:
    """Plain version of explore_pairs: merged_candidates for both
    anchors, explore_core and the packing."""
    posA, strA, valA = merged_candidates(*stats_a, mm_v, hits_a.mm, cfg)
    posB, strB, valB = merged_candidates(*stats_b, mm_v, hits_b.mm, cfg)
    return _pack(explore_core(words, nbases, chrom_offsets, reads, lens,
                              hits_a, hits_b, posA, strA, valA, posB, strB,
                              valB, cfg, prefilter))


# What the kernel reads of each anchor's finalize_hits, in ExploreArgs
# order, with the dtypes it takes.
_HIT_FIELDS = (("pos", torch.int64), ("strand", torch.int32),
               ("aligned", torch.bool), ("mm", torch.int32),
               ("n_best", torch.int32), ("qual", torch.int32))


def _check(words, nbases: int, chrom_offsets, reads, lens, stats_a,
           stats_b, hits_a, hits_b, mm_v, cfg: Config) -> list:
    """Every tensor the kernel reads, in ExploreArgs order, after checking
    that it is what the kernel takes; raises otherwise."""
    B, Lp = reads.shape
    V2 = mm_v.shape[0]
    K = cfg.max_pair_hits
    want = [(words, torch.int32, (words.shape[0],)),
            (chrom_offsets, torch.int64, (chrom_offsets.shape[0],)),
            (reads, torch.uint8, (B, Lp)), (lens, torch.int32, (B,)),
            (mm_v, torch.int32, (V2,))]
    for stats, hits in ((stats_a, hits_a), (stats_b, hits_b)):
        count, first_pos, extras = stats
        want += [(count, torch.int32, (B, V2)),
                 (first_pos, torch.int64, (B, V2)),
                 (extras, torch.int64, (B, V2, K - 1))]
        want += [(getattr(hits, f), dt, (B,)) for f, dt in _HIT_FIELDS]
    dev = reads.device
    for t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"explore_pairs: a tensor on {t.device}, reads "
                             f"on {dev}; all must be on one CUDA device")
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"explore_pairs: want a contiguous {dtype} "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"explore_pairs: tensors on {dev}; the kernel "
                         "takes one CUDA device (CPU tensors take the "
                         "plain version)")
    if (not 1 <= K <= MAX_PAIR_HITS or V2 % 2
            or V2 // 2 * K > MAX_LIST_LANES or Lp > MAX_READ_LEN
            or chrom_offsets.shape[0] < 1):
        raise ValueError(f"explore_pairs: max_pair_hits {K} (kernel: 1..."
                         f"{MAX_PAIR_HITS}), 2V = {V2} (V * K <= "
                         f"{MAX_LIST_LANES}), Lp = {Lp} (<= {MAX_READ_LEN}),"
                         f" {chrom_offsets.shape[0]} chromosomes")
    if not Lp + 2 <= nbases < 2 ** 32:
        raise ValueError(f"explore_pairs: genome of {nbases} bases; the "
                         f"kernel needs {Lp + 2} <= n < 2^32")
    return [t for t, _, _ in want]


def explore_pairs(words, nbases: int, chrom_offsets, reads, lens, stats_a,
                  stats_b, hits_a, hits_b, mm_v, cfg: Config,
                  prefilter: bool = True) -> torch.Tensor:
    """§2b after K1, packed: int32 [B, 14] rows in ops/detect
    PACK_FIELDS order (multi 0: final). `stats_a`/`stats_b` are each
    anchor's (count int32 [B, 2V], first_pos int64 [B, 2V], extras int64
    [B, 2V, K-1]) from candidate_stats, `hits_a`/`hits_b` their
    finalize_hits, `mm_v` int32 [2V]. CPU tensors take the plain version;
    CUDA tensors launch csrc/explore.cu on the current stream (one launch,
    no wait) or raise."""
    args = (words, nbases, chrom_offsets, reads, lens, stats_a, stats_b,
            hits_a, hits_b, mm_v)
    if all(t.is_cpu for t in (words, chrom_offsets, reads, lens, mm_v,
                              *stats_a, *stats_b, *hits_a, *hits_b)):
        return explore_pairs_ref(*args, cfg, prefilter)
    return _launch(args, cfg, prefilter)


def _launch(args: tuple, cfg: Config, prefilter: bool,
            lib=None) -> torch.Tensor:
    """explore_pairs on CUDA tensors: one C call into `lib` (default: the
    kernel library), made with the tensors' device current (the C entry
    refuses any other, and the default stream's null handle launches on
    the current device)."""
    global launches
    ptrs = [t.data_ptr() for t in _check(*args, cfg)]
    words, nbases, chrom_offsets, reads, lens, *_, mm_v = args
    B, Lp = reads.shape
    out = torch.empty((B, 14), dtype=torch.int32, device=reads.device)
    if B == 0:
        return out
    dev = reads.get_device()
    lib = lib or _build.load()
    with torch.cuda.device(dev):
        got = lib.fc2t_explore(_build.EXPLORE_ARGS.pack(
            *ptrs[:5], out.data_ptr(), *ptrs[5:],
            torch._C._cuda_getCurrentRawStream(dev), nbases, B, Lp,
            mm_v.shape[0] // 2, cfg.max_pair_hits, chrom_offsets.shape[0],
            cfg.anchor_len, cfg.prefilter_mm, int(cfg.pair_rescue),
            int(prefilter), dev))
    if got < 0:
        _build.check(-got, "explore_pairs launch")
    launches += got
    return out


# The stages of csrc/explore.cu between its stage clocks (STAMP).
STAGES = ("prologue", "merge", "rank", "windows", "candidate sides",
          "compaction", "pairs", "tie-break and row")


def stage_cycles(args: tuple, cfg: Config, prefilter: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """explore_pairs(*args, cfg, prefilter) on CUDA tensors through the
    measurement build of the kernel (_build.load_stamped): its rows, and
    int64 [B, len(STAGES)] SM clock cycles of each block's stages (thread
    0's clock64 at the start, at the barrier that ends each stage and
    before the row). One launch, counted on `launches`."""
    reads = args[3]
    return _build.stamped("fc2t_explore_stamps", reads.shape[0],
                          len(STAGES), reads,
                          lambda lib: _launch(args, cfg, prefilter, lib))


def resources(cfg: Config, n_chroms: int, device) -> dict:
    """What csrc/explore.cu's kernel takes on CUDA `device` at `cfg`'s
    widths: registers and spilled bytes a thread, shared bytes a block,
    resident blocks an SM, threads a block."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        got = _build.load().fc2t_explore_resources(
            cfg.max_read_len, cfg.max_pair_hits, 1 + 3 * cfg.anchor_len,
            n_chroms, out)
    _build.check(-got, "explore_pairs resources")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "threads"), out))


def explore_k1(words, nbases: int, table, meta, ext, ext_id, chrom_offsets,
               reads, lens, cfg: Config) -> tuple:
    """K1 with the §2b extras for both anchors of a batch of routed reads
    (uint8 [B, Lp], int32 [B]): explore_pairs' arguments before `cfg`.
    Both anchors go through one classic_anchor_stats call ([2B], one
    kernel launch on the card), whose rows split into contiguous halves."""
    B = reads.shape[0]
    hits, stats = classic_anchor_stats(table, meta,
                                       torch.cat(read_anchors(reads, lens,
                                                              cfg)),
                                       cfg, ext, ext_id, stats=True)
    halves = [AnchorHits(*(x[:B] for x in hits)),
              AnchorHits(*(x[B:] for x in hits))]
    return (words, nbases, chrom_offsets, reads, lens,
            tuple(x[:B] for x in stats), tuple(x[B:] for x in stats),
            *halves, variant_metadata(cfg, reads.device)[0])


def explore_batch_packed(words, nbases: int, table, meta, ext, ext_id,
                         chrom_offsets, reads, lens, cfg: Config,
                         prefilter: bool = True) -> torch.Tensor:
    """Full §2b multi-hit re-call of a batch of routed reads (uint8
    [B, Lp], int32 [B]), packed as int32 [B, 14] in
    ops/detect.PACK_FIELDS order (multi 0: the rows are final): K1
    with the §2b extras, then explore_pairs, under the profiler labels
    explore_k1 and explore_pairs."""
    with record_function("explore_k1"):
        args = explore_k1(words, nbases, table, meta, ext, ext_id,
                          chrom_offsets, reads, lens, cfg)
    with record_function("explore_pairs"):
        return explore_pairs(*args, cfg, prefilter)
