"""The least bytes and operations of the detect and explore programs' work,
and the least time the H100 could take for them: a frozen copy of
`chip_smoke.py`'s bound arithmetic (`detect_bounds`, `classic_bound`,
`_bound`, `explore_bound`, with the port's `ops/explore.merged_candidates`
copied in), written over counts and host arrays where `chip_smoke.py`
reads them off tensors. Each input byte counts once and each output byte
once. Hit-field widths are those of the port's AnchorHits when the copy
was made, fixed here so that a later change to the program's types does
not move the yardstick.
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA's data sheet for the H100 SXM: HBM3 at 3.35 TB/s, and 67 TFLOP/s
# of float32 outside the tensor cores (int32 runs at no more).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# Operations counted from the kernels' sources (chip_smoke.py).
EXPLORE_OPS_PER_SPLIT = 12
DETECT_OPS_PER_SPLIT = 12
EXACT_OPS_PER_ANCHOR = 220
CLASSIC_OPS_PER_VARIANT = 150
# Bytes of an anchor's hit fields as the core reads them (pos 8, strand
# 4, aligned 1, n_best 4, qual 4), as K1's enumeration writes them
# (aligned 1, pos 8 and five int32), as explore_pairs reads them (the
# core's and mm 4), and of a probe's outputs per anchor.
CORE_HIT_BYTES = 21
CLASSIC_HIT_BYTES = 1 + 8 + 5 * 4
EXPLORE_HIT_BYTES = 25
EXACT_OUT_BYTES = 30
ROW_BYTES = 32           # one cuckoo bucket row: 2 slots x 4 int32 lanes
META_WORDS = 3
PACKED_ROW_BYTES = 4 * 14
M32 = 0xFFFFFFFF
LARGE_POS = 0xFFFFFFFF


def bound(nbytes: int, ops: int) -> dict:
    """chip_smoke._bound: the larger of bytes over the HBM rate and int32
    operations over the SMs' rate, in ms, and which of them bounds."""
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def probe(n: int, a: int) -> dict:
    """detect_bounds' "exact": n anchors, four bucket rows each (table and
    neighbour table, two probes), meta, the probe's outputs."""
    return bound(n * (a + 4 * ROW_BYTES + EXACT_OUT_BYTES) + 4 * META_WORDS,
                 EXACT_OPS_PER_ANCHOR * n)


def core(lens: np.ndarray, n_offsets: int, a: int,
         prefilter: bool) -> dict:
    """detect_bounds' "core" for one batch of read lengths (rows of
    length 0 are padding): the bases of each read and of its reverse
    complement, the lengths, both anchors' hit fields, the two K2
    windows and (prefilter on) the two prefilter windows at half a byte
    a base, the chromosome offsets, the overflow flag, the packed rows;
    DETECT_OPS_PER_SPLIT a valid split."""
    bases = np.clip(np.asarray(lens, np.int64), 0, None)
    B = bases.size
    k2 = 2 * ((bases + 3) // 2)[bases > 0]
    windows = int(k2.sum()) + (2 * int(((bases + 1) // 2).sum())
                               if prefilter else 0)
    nbytes = (2 * int(bases.sum()) + 4 * B + 2 * B * CORE_HIT_BYTES
              + windows + 8 * n_offsets + 1 + PACKED_ROW_BYTES * B)
    splits = np.clip(bases - 2 * a + 1, 0, None)
    return bound(nbytes, DETECT_OPS_PER_SPLIT * int(splits.sum()))


def classic(n: int, a: int, slots: bool = False, stats=None) -> dict:
    """classic_bound: K1's enumeration of n anchors, two bucket rows a
    canonical variant; in slot mode their slot indices; with `stats`
    (count [n, 2V], first_pos [n, 2V], optional extras [n, 2V, K-1] as
    tensors) the rows written and the §2b extras read and written."""
    V = 1 + 3 * a
    nbytes = (n * (a + 2 * V * ROW_BYTES + CLASSIC_HIT_BYTES)
              + 4 * META_WORDS + (8 * n if slots else 0))
    if stats is not None:
        count, first_pos, *extras = stats
        nbytes += 4 * count.numel() + 8 * first_pos.numel()
        if extras:
            x = extras[0]
            real = (x.reshape(n, 2, V, -1) != M32).any(-1).any(1)
            held = (first_pos.reshape(n, 2, V) != M32).any(1)
            nbytes += (4 * int(held.sum())
                       + int(real.sum()) * 4 * 2 * x.shape[-1]
                       + 8 * x.numel())
    return bound(nbytes, CLASSIC_OPS_PER_VARIANT * V * n)


def merged_candidates(count, first_pos, extras, mm_v, best_mm, K: int):
    """The port's ops/explore.merged_candidates, frozen: the first K
    (strand, position) hits of each read at its best mismatch level."""
    B, V2 = count.shape
    V = V2 // 2
    dev = count.device
    lane = torch.arange(K, device=dev)
    cand = torch.cat([first_pos[..., None], extras], dim=-1)
    at_best = (mm_v[None, :] == best_mm[:, None]) & (count > 0)
    lane_ok = lane < torch.clamp(count, max=K)[..., None]
    cand = torch.where(at_best[..., None] & lane_ok, cand, LARGE_POS)
    plus = cand[:, :V].reshape(B, V * K).sort(-1).values[:, :K]
    minus = cand[:, V:].reshape(B, V * K).sort(-1).values[:, :K]
    both = torch.cat([plus, minus], dim=1)
    strand2k = torch.arange(2, device=dev).repeat_interleave(K)
    ok2k = both != LARGE_POS
    rank = torch.cumsum(ok2k, 1) - 1
    sel = ok2k[:, None, :] & (rank[:, None, :] == lane[None, :, None])
    valid = sel.any(-1)
    pos = torch.where(valid, torch.where(sel, both[:, None, :], 0).sum(-1),
                      LARGE_POS)
    strand = torch.where(sel, strand2k, 0).sum(-1).to(torch.int32)
    return pos, strand, valid


def explore_pairs(args, a: int, K: int) -> dict:
    """explore_bound for explore_pairs' arguments before `cfg` (words,
    nbases, offsets, reads, lens, (count, first, extras) of anchors A and
    B, their hits, mm_v): EXPLORE_OPS_PER_SPLIT for every split of every
    pair that can pair; bytes of the reads and lengths, both anchors'
    count rows and hit fields, the candidate lanes at the best mismatch
    level, each valid candidate's window words, the chromosome offsets
    and the packed rows."""
    (words, nbases, offsets, reads, lens, sa, sb, ha, hb, mm_v) = args
    B, Lp = reads.shape
    cands, lanes = [], 0
    for (count, first, extras), hits in ((sa, ha), (sb, hb)):
        cands.append(merged_candidates(count, first, extras, mm_v, hits.mm,
                                       K))
        at_best = (mm_v[None, :] == hits.mm[:, None]) & (count > 0)
        lanes += int(torch.where(at_best, torch.clamp(count, max=K),
                                 0).sum())
    (pa, sta, va), (pb, stb, vb) = cands
    s0 = (sta == 0)[:, :, None]
    pA = torch.where(s0, pa[:, :, None], pb[:, None, :])
    pB = torch.where(s0, pb[:, None, :], pa[:, :, None])
    geom = (((pA + a) & M32) <= pB) | (((pB + a) & M32) <= pA)
    same = torch.searchsorted(offsets, pA, right=True) == torch.searchsorted(
        offsets, pB, right=True)
    can = ((sta[:, :, None] == stb[:, None, :]) & va[:, :, None]
           & vb[:, None, :] & geom & same)
    splits = torch.clamp(torch.clamp(lens.to(torch.int64) - a, max=Lp)
                         - a + 1, min=0)
    ops = EXPLORE_OPS_PER_SPLIT * int((can.sum((1, 2)) * splits).sum())
    window = 4 * ((Lp + 2) // 8 + 2)
    nbytes = (B * Lp + 4 * B + 2 * 4 * sa[0].numel() + 4 * mm_v.numel()
              + 2 * B * EXPLORE_HIT_BYTES + 8 * lanes
              + window * int(va.sum() + vb.sum()) + 8 * offsets.numel()
              + PACKED_ROW_BYTES * B)
    return bound(nbytes, ops)
