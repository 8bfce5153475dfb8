"""K-mer-range sharding of the *sorted* seed index (host artifact form).

The device runtime consumes the query-optimized hash-table form instead
(index/hashtable.shard_query_table, same prefix ranges); this partitioner
remains for host-side artifact distribution and as the reference for the
range semantics.

This is the tensor-parallel analog mandated by BASELINE.json:5/10 and
SURVEY.md §2.4: the *index* (bucket offsets + position lists — the memory
hog) shards by k-mer range, hash-routing style; the genome code array is
replicated (2-bit packable; a whole human genome fits one chip's HBM).
Each shard owns k-mers [i*S, (i+1)*S); SPEC.md §2's seed-dedup rule makes
the union of per-shard candidate sets exact without communication, so the
pmin/psum combination in ops/anchor_align.finalize_hits is bit-identical
to the single-shard path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from find_circ2_tpu_torch.index.build import SeedIndex


@dataclass
class ShardedIndex:
    n_shards: int
    kmers_per_shard: int          # S: prefix12 range width per shard
    offsets: np.ndarray           # int32 [n_shards, S+1], local offsets
    suffix_vals: np.ndarray       # int32 [n_shards, Pmax], zero-padded
    positions: np.ndarray         # uint32 [n_shards, Pmax], zero-padded
    bsearch_iters: int


def shard_index(index: SeedIndex, n_shards: int) -> ShardedIndex:
    nb = index.n_buckets
    S = -(-nb // n_shards)  # ceil; trailing shards may own fewer prefixes
    offs = index.offsets.astype(np.int64)
    shard_offsets = np.zeros((n_shards, S + 1), dtype=np.int64)
    pos_slices = []
    suf_slices = []
    for i in range(n_shards):
        lo_k = min(i * S, nb)
        hi_k = min((i + 1) * S, nb)
        local = offs[lo_k:hi_k + 1] - offs[lo_k]
        # Pad with the final value so padded prefixes have empty buckets.
        shard_offsets[i, :local.size] = local
        shard_offsets[i, local.size:] = local[-1] if local.size else 0
        pos_slices.append(index.positions[offs[lo_k]:offs[hi_k]])
        suf_slices.append(index.suffix_vals[offs[lo_k]:offs[hi_k]])
    pmax = max(max((p.size for p in pos_slices), default=0), 1)
    positions = np.zeros((n_shards, pmax), dtype=np.uint32)
    suffix_vals = np.zeros((n_shards, pmax), dtype=np.int32)
    for i, (p, sv) in enumerate(zip(pos_slices, suf_slices)):
        positions[i, :p.size] = p.astype(np.uint32)
        suffix_vals[i, :sv.size] = sv.astype(np.int32)
    return ShardedIndex(n_shards=n_shards, kmers_per_shard=S,
                        offsets=shard_offsets.astype(np.int32),
                        suffix_vals=suffix_vals, positions=positions,
                        bsearch_iters=index.bsearch_iters)
