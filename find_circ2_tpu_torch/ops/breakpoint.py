"""K2: batched breakpoint search (reference: find_circ2_tpu/ops/breakpoint.py;
SPEC.md §4 fixes the semantics).

Ungapped alignment makes the left piece's mismatches a prefix sum and
the right piece's a suffix sum of per-position mismatch indicators, so
one pass of cumulative sums scores every split. The reference computes
the prefix sums as a bf16 triangular-ones matmul for the TPU's matrix
unit; here they are an int32 `cumsum`.

Global positions are int64 holding the reference's uint32 values; every
sum that wraps in uint32 there is masked with `& 0xFFFFFFFF` here.
"""

from __future__ import annotations

import torch

from find_circ2_tpu_torch.config import (Config, KIND_CIRCULAR, KIND_LINEAR,
                                         SENSE_MINUS, SENSE_PLUS)
from find_circ2_tpu_torch.index.hashtable import M32
from find_circ2_tpu_torch.ops.packed import gather_window

# Genome base codes (SPEC.md §0) used for signal tests.
_A, _C, _G, _T = 0, 1, 2, 3

BIG = 1 << 20


def breakpoint_search(words: torch.Tensor, nbases: int,
                      reads: torch.Tensor, lens: torch.Tensor,
                      pA: torch.Tensor, endB: torch.Tensor,
                      kind: torch.Tensor, align_strand: torch.Tensor,
                      cfg: Config) -> dict:
    """Per-read junction fields (SPEC.md §4) for genome-forward
    canonicalized reads (uint8 [B, Lp]), the left piece's start `pA` and
    the right piece's end `endB` (int64, uint32 values). Rows the caller
    masks still compute safely: every window start is clamped."""
    B, Lp = reads.shape
    a = cfg.anchor_len
    dev = reads.device
    lens_u = lens.to(torch.int64)
    hi = nbases - (Lp + 2)
    # GA[i] = genome[pA + i], i in [0, Lp+2): left piece + donor dinuc.
    GA = gather_window(words, torch.clamp(pA, 0, hi), Lp + 2)
    # GB covers genome[endB - l - 2 : endB - l + Lp]; the right-piece
    # base under read position i is GB[i + 2].
    GBw = gather_window(words, torch.clamp((endB - lens_u - 2) & M32, 0, hi),
                        Lp + 2)

    R = reads.to(torch.int32)
    in_read = torch.arange(Lp, device=dev)[None, :] < lens[:, None]
    GA_r, GB_r = GA[:, :Lp], GBw[:, 2:]
    neqA = ((R != GA_r) | (R >= 4) | (GA_r >= 4)) & in_read
    neqB = ((R != GB_r) | (R >= 4) | (GB_r >= 4)) & in_read
    prefA = torch.cumsum(neqA.to(torch.int32), 1, dtype=torch.int32)
    prefB = torch.cumsum(neqB.to(torch.int32), 1, dtype=torch.int32)
    totB = torch.gather(prefB, 1,
                        torch.clamp(lens_u[:, None] - 1, 0, Lp - 1))

    # Score at split k: mmL(k) + (totB - prefB_x[k]), k in [a, l-a].
    k_ax = torch.arange(Lp + 1, device=dev)[None, :]
    prefA_x = torch.nn.functional.pad(prefA, (1, 0))
    prefB_x = torch.nn.functional.pad(prefB, (1, 0))
    k_valid = (k_ax >= a) & (k_ax <= lens_u[:, None] - a)
    score = torch.where(k_valid, prefA_x + (totB - prefB_x), BIG)
    edits = score.amin(1)
    n_bp = ((score == edits[:, None]) & k_valid).sum(1, dtype=torch.int32)

    # Junction coordinates and dinucleotides of every split.
    donor = (pA[:, None] + k_ax) & M32
    acceptor = (endB[:, None] + k_ax - lens_u[:, None]) & M32
    is_circ = (kind == KIND_CIRCULAR)[:, None]
    j_start = torch.where(is_circ, acceptor, donor)
    j_end = torch.where(is_circ, donor, acceptor)
    d0, d1 = GA[:, :Lp + 1], GA[:, 1:Lp + 2]
    a0, a1 = GBw[:, :Lp + 1], GBw[:, 1:Lp + 2]
    # SPEC §4 canonical patterns, genome-forward: sense + is GT..AG,
    # sense - is CT..AC (kind only swaps which side is start or end).
    canon_p = (d0 == _G) & (d1 == _T) & (a0 == _A) & (a1 == _G)
    canon_m = (d0 == _C) & (d1 == _T) & (a0 == _A) & (a1 == _C)

    # Frozen tie-break: (score, !canon+, !canon-, k) lexicographic.
    key = (score * 8 + torch.where(canon_p, 0, 4)
           + torch.where(canon_m, 0, 2)) * (Lp + 2) + k_ax
    key = torch.where(k_valid, key, 2 ** 30)
    best_k = torch.argmin(key, dim=1)

    def take(x):
        return torch.gather(x, 1, best_k[:, None])[:, 0]

    b_start, b_end = take(j_start), take(j_end)
    b_d0, b_d1, b_a0, b_a1 = take(d0), take(d1), take(a0), take(a1)
    sense = torch.where(take(canon_p), SENSE_PLUS,
                        torch.where(take(canon_m), SENSE_MINUS,
                                    align_strand.to(torch.int64)))

    # Signal dinucs in splice-sense orientation (SPEC §4): '+' reads
    # donor then acceptor forward, '-' their reverse complement.
    def comp(x):
        return torch.where(x < 4, 3 - x, x)

    sig_p = torch.stack([b_d0, b_d1, b_a0, b_a1], dim=1)
    sig_m = torch.stack([comp(b_a1), comp(b_a0), comp(b_d1), comp(b_d0)],
                        dim=1)
    signal = torch.where((sense == SENSE_MINUS)[:, None], sig_m, sig_p)

    # Anchor overlap at the best split: max(0, min_e - max_s).
    min_e = torch.minimum((pA + best_k) & M32, endB)
    max_s = torch.maximum(pA, (endB + best_k - lens_u) & M32)
    overlap = torch.where(min_e > max_s, min_e - max_s, 0)

    # Linear junctions need end > start (SPEC §4).
    no_junction = (kind == KIND_LINEAR) & (b_end <= b_start)
    return dict(start=b_start, end=b_end, sense=sense.to(torch.int32),
                edits=edits.to(torch.int32), n_bp=n_bp,
                overlap=as_int32(overlap), signal=signal.to(torch.int32),
                no_junction=no_junction, best_k=best_k.to(torch.int32))


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values carried in int64 -> their int32 bit pattern."""
    x = x & M32
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)
