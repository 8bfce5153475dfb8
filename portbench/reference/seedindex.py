"""Genome seed index v2: the TPU-native replacement for bowtie2-build's
FM-index (SURVEY.md §2.2, L0 in §1).

Two-level exact-20-mer index (SPEC.md §1): a direct-addressed table on the
first `prefix_len` (=12) bases plus, within each bucket, positions sorted
by the 16-bit value of the remaining `a - prefix_len` (=8) bases. An exact
anchor-window query is one offsets lookup + a short binary search; K1
(ops/anchor_align.py) enumerates the <=A_MM-mismatch neighborhood of each
anchor and resolves every variant exactly — dense arrays, O(1)+O(log)
lookups, trivially shardable by prefix range across chips
(find_circ2_tpu/index/shard.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.config import Config
from portbench.reference.genome import Genome


@dataclass
class SeedIndex:
    """Two-level exact anchor-window index over a concatenated genome.

    positions:   uint32 starts of valid windows (all `anchor_len` codes
                 < 4), sorted by (prefix12, suffix8, position).
    suffix_vals: uint16 suffix value per entry of `positions`.
    offsets:     uint32[4^prefix_len + 1] bucket ranges by prefix.
    bsearch_iters: static number of binary-search rounds that suffices for
                 the largest prefix bucket (ceil(log2(max_bucket_size+1))).
    """
    anchor_len: int
    prefix_len: int
    positions: np.ndarray
    suffix_vals: np.ndarray
    offsets: np.ndarray
    bsearch_iters: int
    # Query-optimized device form (index/hashtable.py); built lazily by
    # DeviceIndex.build when absent, persisted by save_index.
    qtable: "object | None" = None

    @property
    def n_buckets(self) -> int:
        return 4 ** self.prefix_len

    def lookup(self, p12: int, s8: int) -> np.ndarray:
        """Exact-20-mer query -> position array (host/debug use)."""
        lo, hi = int(self.offsets[p12]), int(self.offsets[p12 + 1])
        left = lo + np.searchsorted(self.suffix_vals[lo:hi], s8, "left")
        right = lo + np.searchsorted(self.suffix_vals[lo:hi], s8, "right")
        return self.positions[left:right]


def kmer_values(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized rolling k-mers.

    Returns (kmers, valid) of length len(codes)-k+1. kmers[p] is the
    big-endian base-4 value of codes[p:p+k] (SPEC.md §1); valid[p] is False
    if any base in the window has code >= 4 (N or sentinel).

    Computed by recursive doubling — ceil(log2 k) combine passes instead
    of k shift-add passes (a w-mer and the leading digits of the w-mer
    starting w positions later form a (w+step)-mer), ~3x fewer passes
    over the array at whole-genome scale. Bit-identical to the direct
    accumulation (tests/test_index.py).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint32), np.zeros(0, bool))
    if k > 16:
        raise ValueError("kmer_values supports k <= 16 (uint32 output)")
    v = np.where(codes < 4, codes, 0).astype(np.uint32)
    pows = {1: v}
    w = 1
    while w * 2 <= k:
        # 2w-mer(p) = w-mer(p) * 4^w + w-mer(p+w).
        v = v[:v.size - w] * np.uint32(4 ** w) + v[w:]
        w *= 2
        pows[w] = v
    # Combine the power-of-two component arrays of k, high to low.
    bits = sorted((b for b in pows if k & b), reverse=True)
    vals = pows[bits[0]]
    off = bits[0]
    for b in bits[1:]:
        tail = pows[b][off:]
        vals = vals[:tail.size] * np.uint32(4 ** b) + tail
        off += b
    vals = vals[:n]
    bad = (codes >= 4).astype(np.int64)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    valid = (cbad[k:] - cbad[:-k]) == 0
    return vals, valid


def build_index(genome: Genome, cfg: Config = Config()) -> SeedIndex:
    """Build the two-level index over the full concatenated genome (the
    monolithic sort; the benchmark's genomes are far below the sizes
    that need a chunked build)."""
    a, pk = cfg.anchor_len, cfg.prefix_len
    sk = a - pk
    codes = genome.codes
    pref, pref_ok = kmer_values(codes, pk)
    suf, suf_ok = kmer_values(codes[pk:], sk)
    n = min(pref.size, suf.size)
    valid = pref_ok[:n] & suf_ok[:n]
    pos = np.nonzero(valid)[0]
    p12 = pref[pos]
    s8 = suf[pos].astype(np.uint16)
    # Sort by (prefix, suffix, position): one single-key stable argsort
    # on the packed 40-bit key (position order within equal keys is
    # preserved ascending) — measured 1.6x faster than the two-key
    # np.lexsort at 64M entries.
    order = np.argsort((p12.astype(np.uint64) << np.uint64(16))
                       | s8.astype(np.uint64), kind="stable")
    positions = pos[order].astype(np.uint32)
    suffix_vals = s8[order]
    counts = np.bincount(p12, minlength=4 ** pk)
    offsets = np.zeros(4 ** pk + 1, dtype=np.uint32)
    offsets[1:] = np.cumsum(counts, dtype=np.uint64).astype(np.uint32)
    max_bucket_size = int(counts.max()) if counts.size else 0
    iters = max(1, int(np.ceil(np.log2(max_bucket_size + 1)))) \
        if max_bucket_size else 1
    return SeedIndex(anchor_len=a, prefix_len=pk, positions=positions,
                     suffix_vals=suffix_vals, offsets=offsets,
                     bsearch_iters=iters)
