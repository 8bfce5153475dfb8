"""CPU oracle: per-read reference implementation of the frozen algorithm.

This is the semantics ground truth (SURVEY.md §0 consequence 3, §7 step 2):
a plain numpy implementation of SPEC.md §2-§4 / SURVEY.md §3.3, deliberately
written as per-candidate loops (the breakpoint search recomputes Hamming
distance per split, O(L²) exactly as the reference does) so that the
vectorized prefix-sum TPU path in ops/ is cross-checked against an
independent formulation. Golden test fixtures are generated from this
module.
"""

from __future__ import annotations

from dataclasses import dataclass

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
from portbench.reference.twobit import (REVCOMP_LUT, codes_to_seq,
                                           seq_to_codes)


@dataclass
class AnchorHit:
    aligned: bool
    pos: int = 0          # global anchor start
    strand: int = 0       # 0='+', 1='-'
    mm: int = 0
    n_best: int = 0
    second_mm: int = 0
    qual: int = 0


@dataclass
class ReadCall:
    """Per-read outcome; the unit compared between oracle and TPU path."""
    name: str
    seq: str
    status: int
    kind: int = 0             # KIND_LINEAR / KIND_CIRCULAR
    chrom_idx: int = -1
    start: int = 0            # global coordinates (convert via Genome)
    end: int = 0
    sense: int = 0            # SENSE_PLUS / SENSE_MINUS
    align_strand: int = 0     # strand both anchors aligned to
    edits: int = 0
    n_bp: int = 0             # breakpoint ambiguity count
    overlap: int = 0
    qual_left: int = 0
    qual_right: int = 0
    signal: str = ""


def _hamming(a: np.ndarray, b: np.ndarray) -> int:
    """Mismatch count; any code >= 4 on either side mismatches (SPEC §0)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return int(np.sum((a != b) | (a >= 4) | (b >= 4)))


def _kmer(codes: np.ndarray) -> int:
    v = 0
    for c in codes:
        v = v * 4 + int(c)
    return v


def anchor_candidates(genome: Genome, index: SeedIndex,
                      anchor: np.ndarray, cfg: Config, ball: int = 1
                      ) -> tuple[AnchorHit, list[tuple[int, int]]]:
    """SPEC.md §2 [FROZEN v2] single-best statistics plus the §2b
    [FROZEN v3] capped candidate list of best-mm hits.

    Anchors containing any non-ACGT code are unalignable; otherwise every
    20-mer within Hamming distance `ball` (A_MM for the first pass;
    rescue_anchor_mm for the §2 [FROZEN v4] 2-mm rescue pass) of the
    (strand-adjusted) query is looked up exactly; candidate sets are
    disjoint across variants so best/second/count statistics are pure
    range arithmetic. The returned list holds all (strand, position)
    hits at best mm, sorted by (strand '+' first, position), capped at
    max_pair_hits.
    """
    a, pk = cfg.anchor_len, cfg.prefix_len
    if np.any(anchor >= 4):
        return AnchorHit(aligned=False), []
    # (mm, strand, first_pos, count, hits) per non-empty variant.
    cands: list[tuple[int, int, int, int, np.ndarray]] = []
    for strand in (0, 1):
        q = anchor if strand == 0 else REVCOMP_LUT[anchor[::-1]]
        variants = [(q, 0)]
        for j in range(a):
            for r in (1, 2, 3):
                u = q.copy()
                u[j] = (q[j] + r) % 4
                variants.append((u, 1))
        if ball >= 2:
            for j1 in range(a):
                for j2 in range(j1 + 1, a):
                    for r1 in (1, 2, 3):
                        for r2 in (1, 2, 3):
                            u = q.copy()
                            u[j1] = (q[j1] + r1) % 4
                            u[j2] = (q[j2] + r2) % 4
                            variants.append((u, 2))
        for u, mm in variants:
            hits = index.lookup(_kmer(u[:pk]), _kmer(u[pk:]))
            if hits.size == 0 or hits.size > cfg.max_bucket:
                continue  # empty, or repetitive-20-mer guard [FROZEN]
            cands.append((mm, strand, int(hits[0]), int(hits.size), hits))
    if not cands:
        return AnchorHit(aligned=False), []
    cands.sort(key=lambda c: c[:4])
    best_mm, strand, pos, _, _ = cands[0]
    n_best = sum(c[3] for c in cands if c[0] == best_mm)
    second_mm = (best_mm if n_best > 1
                 else (cands[1][0] if len(cands) > 1 else a + 1))
    qual = 0 if n_best > 1 else min(40, 10 * (second_mm - best_mm))
    hit = AnchorHit(aligned=best_mm <= max(cfg.max_anchor_mm, ball),
                    pos=pos, strand=strand, mm=best_mm, n_best=n_best,
                    second_mm=second_mm, qual=qual)
    pairs = sorted((s, int(p)) for mm, s, _, _, hits in cands
                   if mm == best_mm for p in hits)
    return hit, pairs[:cfg.max_pair_hits]


def align_anchor(genome: Genome, index: SeedIndex, anchor: np.ndarray,
                 cfg: Config) -> AnchorHit:
    """Single-best anchor statistics (SPEC.md §2 [FROZEN v2])."""
    return anchor_candidates(genome, index, anchor, cfg)[0]


def _contiguous(genome: Genome, R: np.ndarray, Rrc: np.ndarray,
                strand: int, p: int, side: str, cfg: Config) -> bool:
    """SPEC.md §6 pass-1 contiguous extension for one anchor hit."""
    G, l, a = genome.codes, len(R), cfg.anchor_len
    if side == "A":
        seg, query = ((G[p:p + l], R) if strand == 0
                      else (G[p + a - l:p + a], Rrc))
    else:
        seg, query = ((G[p + a - l:p + a], R) if strand == 0
                      else (G[p:p + l], Rrc))
    if seg.size != l:
        return False
    return _hamming(query, seg) <= cfg.prefilter_mm


_CANON = {  # (kind, sense) -> (left_dinuc, right_dinuc) genome-forward
    (KIND_LINEAR, SENSE_PLUS): ("GT", "AG"),
    (KIND_LINEAR, SENSE_MINUS): ("CT", "AC"),
    (KIND_CIRCULAR, SENSE_PLUS): ("AG", "GT"),
    (KIND_CIRCULAR, SENSE_MINUS): ("AC", "CT"),
}


def _junction_coords(kind: int, pA: int, endB: int, l: int, bp: int
                     ) -> tuple[int, int]:
    donor = pA + bp
    acceptor = endB - (l - bp)
    if kind == KIND_LINEAR:
        return donor, acceptor
    return acceptor, donor


def _dinucs(G: np.ndarray, kind: int, start: int, end: int
            ) -> tuple[str, str]:
    """Genome-forward dinucleotides at the junction edges (SPEC §4)."""
    if kind == KIND_LINEAR:
        left = codes_to_seq(G[start:start + 2])
        right = codes_to_seq(G[end - 2:end])
    else:
        left = codes_to_seq(G[start - 2:start])
        right = codes_to_seq(G[end:end + 2])
    return left, right


def _canonical(G, kind, start, end, sense) -> bool:
    want = _CANON[(kind, sense)]
    return _dinucs(G, kind, start, end) == want


def _sense_signal(G, kind, start, end, align_strand) -> tuple[int, str]:
    """Chosen sense and the signal string in splice orientation (SPEC §4)."""
    if _canonical(G, kind, start, end, SENSE_PLUS):
        sense = SENSE_PLUS
    elif _canonical(G, kind, start, end, SENSE_MINUS):
        sense = SENSE_MINUS
    else:
        sense = align_strand
    left, right = _dinucs(G, kind, start, end)
    if kind == KIND_LINEAR:
        donor_fwd, acc_fwd = left, right
    else:
        donor_fwd, acc_fwd = right, left
    if sense == SENSE_PLUS:
        signal = donor_fwd + acc_fwd
    else:
        # Splice-sense orientation: revcomp and swap roles.
        from portbench.reference.twobit import revcomp_seq
        signal = revcomp_seq(acc_fwd) + revcomp_seq(donor_fwd)
    return sense, signal


def _pair_junction(genome: Genome, R: np.ndarray, pA: int, pB: int,
                   l: int, cfg: Config):
    """§4 breakpoint search for one canonicalized anchor pair.

    Returns None if the pair geometry is invalid or the chosen split
    yields a linear junction with end <= start (SPEC §2b: not viable);
    else (kind, start, end, edits, n_bp, best_bp, canon_p, canon_m)."""
    a = cfg.anchor_len
    endB = pB + a
    if pA + a <= pB:
        kind = KIND_LINEAR
    elif endB <= pA:
        kind = KIND_CIRCULAR
    else:
        return None
    G = genome.codes
    # Naive per-split recomputation (SURVEY §3.3) — deliberately the
    # independent O(L^2) formulation the TPU prefix sums are checked
    # against.
    scores = {}
    for bp in range(a, l - a + 1):
        mmL = _hamming(R[:bp], G[pA:pA + bp])
        mmR = _hamming(R[bp:], G[endB - (l - bp):endB])
        scores[bp] = mmL + mmR
    edits = min(scores.values())
    argmin = [bp for bp, sc in scores.items() if sc == edits]
    n_bp = len(argmin)
    # Tie-break [FROZEN]: prefer canonical '+', then canonical '-', then
    # smallest split.
    def tiekey(bp: int):
        st, en = _junction_coords(kind, pA, endB, l, bp)
        return (not _canonical(G, kind, st, en, SENSE_PLUS),
                not _canonical(G, kind, st, en, SENSE_MINUS), bp)
    best_bp = min(argmin, key=tiekey)
    start, end = _junction_coords(kind, pA, endB, l, best_bp)
    if kind == KIND_LINEAR and end <= start:
        return None
    canon_p = _canonical(G, kind, start, end, SENSE_PLUS)
    canon_m = _canonical(G, kind, start, end, SENSE_MINUS)
    return kind, start, end, edits, n_bp, best_bp, canon_p, canon_m


def call_read(genome: Genome, index: SeedIndex, name: str, seq: str,
              cfg: Config, prefilter: bool = True) -> ReadCall:
    """Full per-read pipeline: SPEC.md §2-§4 + §2b multi-hit pairing,
    SURVEY.md §3.3 call stack."""
    l = len(seq)
    a = cfg.anchor_len
    if l < 2 * a:
        return ReadCall(name, seq, ST_TOO_SHORT)
    if l > cfg.max_read_len:
        return ReadCall(name, seq, ST_TOO_LONG)
    codes = seq_to_codes(seq)
    codes_rc = REVCOMP_LUT[codes[::-1]]
    hitA, candsA = anchor_candidates(genome, index, codes[:a], cfg)
    hitB, candsB = anchor_candidates(genome, index, codes[-a:], cfg)
    # §2 2-mm anchor rescue [FROZEN v4] (config.rescue_anchor_mm): an
    # anchor with no <=1-mm hit whose MATE aligned at <=1 mm re-searches
    # at distance 2. Gated on the mate so unmappable junk (both anchors
    # random) never pays the wide enumeration.
    if cfg.rescue_anchor_mm >= 2:
        if not hitA.aligned and hitB.aligned:
            hitA, candsA = anchor_candidates(genome, index, codes[:a],
                                             cfg, ball=2)
        elif not hitB.aligned and hitA.aligned:
            hitB, candsB = anchor_candidates(genome, index, codes[-a:],
                                             cfg, ball=2)
    # §2b prefilter: ANY candidate hit extending contiguously drops the
    # read (single-candidate lists reduce to the v2 rule).
    if prefilter and (
            any(_contiguous(genome, codes, codes_rc, s, p, "A", cfg)
                for s, p in candsA)
            or any(_contiguous(genome, codes, codes_rc, s, p, "B", cfg)
                   for s, p in candsB)):
        return ReadCall(name, seq, ST_PREFILTERED)
    if not hitA.aligned:
        return ReadCall(name, seq, ST_UNALIGNED_A)
    if not hitB.aligned:
        return ReadCall(name, seq, ST_UNALIGNED_B)

    # §2b pair exploration over the candidate lists. Winning pair =
    # lexicographic min of (edits, !canon+, !canon-, pA, pB) [FROZEN].
    best_key = None
    best = None
    explored = []     # (edits, kind, start, end) of every viable pair
    for sA, posA in candsA:
        for sB, posB in candsB:
            if sA != sB:
                continue
            if sA == 0:
                R, pA, pB = codes, posA, posB
            else:
                # Strand canonicalization [FROZEN], SPEC §3.
                R, pA, pB = codes_rc, posB, posA
            if int(genome.chrom_of(pA)) != int(genome.chrom_of(pB)):
                continue
            pj = _pair_junction(genome, R, pA, pB, l, cfg)
            if pj is None:
                continue
            kind, start, end, edits, n_bp, best_bp, c_p, c_m = pj
            explored.append((edits, kind, start, end))
            key = (edits, not c_p, not c_m, pA, pB)
            if best_key is None or key < best_key:
                best_key = key
                if sA == 0:
                    qual_left, qual_right = hitA.qual, hitB.qual
                else:
                    qual_left, qual_right = hitB.qual, hitA.qual
                best = (sA, pA, pB, qual_left, qual_right, pj)
    if best is not None:
        s, pA, pB, qual_left, qual_right, pj = best
        kind, start, end, edits, n_bp, best_bp, _, _ = pj
        if cfg.pair_rescue and (hitA.n_best > 1 or hitB.n_best > 1):
            # Pair-margin bridge rescue [FROZEN v4] (config.py
            # pair_rescue): margin over the best explored pair at a
            # DIFFERENT junction; no competitor behaves like second_mm's
            # a+1 convention.
            alts = [e for e, k2, s2, e2 in explored
                    if (k2, s2, e2) != (kind, start, end)]
            margin = (min(alts) - edits) if alts else (a + 1)
            if margin > 0:
                rq = min(40, 10 * margin)
                qual_left = max(qual_left, rq)
                qual_right = max(qual_right, rq)
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

    # Fallback [FROZEN]: no viable pair — v2 single-best status chain.
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
