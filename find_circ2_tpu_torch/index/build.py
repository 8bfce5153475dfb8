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

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.io.genome import Genome


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


def build_index(genome: Genome, cfg: Config = Config(),
                chunk: int | None = None) -> SeedIndex:
    """Build the two-level index over the full concatenated genome.

    Genomes beyond ~512 Mbp automatically take the chunked builder
    (`build_index_chunked`, bit-identical output, bounded memory) so a
    whole human genome (~3.1 Gbp) builds within ~40 GB host RAM instead
    of the several-hundred-GB peak of the monolithic sort.
    """
    if chunk is not None or len(genome) > (512 << 20):
        return build_index_chunked(genome, cfg, chunk=chunk or (256 << 20))
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


def _chunk_kmers(codes: np.ndarray, lo: int, hi: int, a: int, pk: int):
    """(p12, s8, pos) of valid anchor windows starting in [lo, hi)."""
    seg = codes[lo:min(hi + a - 1, codes.size)]
    pref, pref_ok = kmer_values(seg, pk)
    suf, suf_ok = kmer_values(seg[pk:], a - pk)
    n = min(pref.size, suf.size, hi - lo)
    valid = pref_ok[:n] & suf_ok[:n]
    rel = np.nonzero(valid)[0]
    return (pref[rel], suf[rel].astype(np.uint16),
            (rel + lo).astype(np.uint32))


def build_index_chunked(genome: Genome, cfg: Config = Config(),
                        chunk: int = 256 << 20) -> SeedIndex:
    """Memory-bounded three-pass builder, bit-identical to build_index.

    Pass 1 counts windows per prefix12 bucket; pass 2 scatters
    (position, suffix) into their bucket ranges — chunks are processed in
    genome order, so within a bucket entries land position-sorted; pass 3
    stable-sorts each bucket by suffix (position order preserved),
    processed in bounded slices of whole buckets. Peak extra memory is
    O(chunk) + the output arrays themselves.
    """
    a, pk = cfg.anchor_len, cfg.prefix_len
    codes = genome.codes
    G = codes.size
    nb = 4 ** pk

    counts = np.zeros(nb, np.int64)
    for lo in range(0, G, chunk):
        p12, _, _ = _chunk_kmers(codes, lo, min(lo + chunk, G), a, pk)
        counts += np.bincount(p12, minlength=nb)
    total = int(counts.sum())
    offsets64 = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=offsets64[1:])
    if total >= 2 ** 32:
        raise ValueError("index exceeds uint32 offsets")

    positions = np.empty(total, np.uint32)
    suffix_vals = np.empty(total, np.uint16)
    cursor = np.zeros(nb, np.int64)
    for lo in range(0, G, chunk):
        p12, s8, pos = _chunk_kmers(codes, lo, min(lo + chunk, G), a, pk)
        order = np.argsort(p12, kind="stable")   # pos stays ascending
        p12 = p12[order]
        s8 = s8[order]
        pos = pos[order]
        # Rank within this chunk's bucket group.
        if p12.size:
            head = np.empty(p12.size, bool)
            head[0] = True
            head[1:] = p12[1:] != p12[:-1]
            gstart = np.flatnonzero(head)
            gcnt = np.diff(np.append(gstart, p12.size))
            rank = np.arange(p12.size, dtype=np.int64) - np.repeat(
                gstart, gcnt)
            dest = offsets64[p12] + cursor[p12] + rank
            positions[dest] = pos
            suffix_vals[dest] = s8
            np.add.at(cursor, p12[gstart], gcnt)

    # Pass 3: per-bucket stable sort by suffix, in slices of whole buckets.
    slice_target = max(1, chunk // 8)
    b = 0
    while b < nb:
        e = b
        while e < nb and offsets64[e + 1] - offsets64[b] < slice_target:
            e += 1
        e = max(e, b + 1)
        lo, hi = int(offsets64[b]), int(offsets64[e])
        if hi > lo:
            bucket_local = (np.searchsorted(
                offsets64[b:e + 1], np.arange(lo, hi), side="right") - 1
            ).astype(np.uint64)
            key = (bucket_local << np.uint64(16)) | suffix_vals[lo:hi]
            order = np.argsort(key, kind="stable")
            positions[lo:hi] = positions[lo:hi][order]
            suffix_vals[lo:hi] = suffix_vals[lo:hi][order]
        b = e

    max_bucket_size = int(counts.max()) if counts.size else 0
    iters = max(1, int(np.ceil(np.log2(max_bucket_size + 1)))) \
        if max_bucket_size else 1
    return SeedIndex(anchor_len=a, prefix_len=pk, positions=positions,
                     suffix_vals=suffix_vals,
                     offsets=offsets64.astype(np.uint32),
                     bsearch_iters=iters)


def save_index(path, genome: Genome, index: SeedIndex) -> None:
    """Persist genome + index as one .npz (bowtie2-build artifact analog:
    SURVEY.md §2.2 L0). Includes the query table when built, so loads
    skip the cuckoo construction."""
    extra = {}
    if index.qtable is not None:
        from find_circ2_tpu_torch.index.hashtable import TABLE_FORMAT
        # qmeta carries the table-format generation as a 4th element:
        # a table built under a different mix_hash would silently miss
        # every K1 lookup (see hashtable.TABLE_FORMAT).
        qmeta = np.concatenate([
            np.asarray(index.qtable.meta, np.int32),
            np.asarray([TABLE_FORMAT], np.int32)])
        extra = {"qtable": index.qtable.table, "qmeta": qmeta}
    np.savez_compressed(
        path,
        codes=genome.codes,
        chrom_names=np.asarray(genome.chrom_names),
        chrom_offsets=genome.chrom_offsets,
        chrom_lengths=genome.chrom_lengths,
        positions=index.positions,
        suffix_vals=index.suffix_vals,
        offsets=index.offsets,
        meta=np.asarray([index.anchor_len, index.prefix_len,
                         index.bsearch_iters], dtype=np.int64),
        **extra,
    )


def load_index_dir(path) -> tuple[Genome, SeedIndex]:
    """Load the raw-.npy artifact DIRECTORY layout written by
    scripts/big_genome.py build (whole-genome scale: codes/
    chrom_offsets/chrom_lengths/positions/suffix_vals/offsets .npy +
    meta.json + optional qtable/qmeta .npy).

    Arrays are memory-mapped — a 3.3 Gbp genome plus its 8.8 GiB query
    table "loads" in milliseconds and pages on demand — so the CLI can
    run directly against whole-genome artifacts (`find_circ -x DIR`),
    the configs[4]/[5] deployment shape."""
    import json as _json
    import os as _os
    meta = _json.load(open(_os.path.join(path, "meta.json")))
    n_chroms = int(meta["n_chroms"])
    names = meta.get("chrom_names") \
        or [f"chr{i + 1}" for i in range(n_chroms)]

    def arr(name, mmap=True):
        return np.load(_os.path.join(path, f"{name}.npy"),
                       mmap_mode="r" if mmap else None)

    genome = Genome(codes=arr("codes"), chrom_names=names,
                    chrom_offsets=arr("chrom_offsets", mmap=False),
                    chrom_lengths=arr("chrom_lengths", mmap=False))
    qtable = None
    if _os.path.exists(_os.path.join(path, "qtable.npy")):
        from find_circ2_tpu_torch.index.hashtable import (QueryTable,
                                                          TABLE_FORMAT)
        qmeta = arr("qmeta", mmap=False)
        version = int(qmeta[3]) if qmeta.size >= 4 else 1
        if version != TABLE_FORMAT:
            raise ValueError(
                f"{path}/qmeta.npy records table format {version}, "
                f"current code is {TABLE_FORMAT}: the hash mixer "
                f"changed since this table was built — rebuild with "
                f"big_genome.py build")
        qtable = QueryTable(table=arr("qtable"), meta=qmeta[:3])
    index = SeedIndex(
        anchor_len=int(meta.get("anchor_len", 20)),
        prefix_len=int(meta.get("prefix_len", 12)),
        positions=arr("positions"), suffix_vals=arr("suffix_vals"),
        offsets=arr("offsets", mmap=False),
        bsearch_iters=int(meta["bsearch_iters"]), qtable=qtable)
    return genome, index


def load_index(path) -> tuple[Genome, SeedIndex]:
    z = np.load(path, allow_pickle=False)
    genome = Genome(
        codes=z["codes"],
        chrom_names=[str(n) for n in z["chrom_names"]],
        chrom_offsets=z["chrom_offsets"],
        chrom_lengths=z["chrom_lengths"],
    )
    a, pk, iters = (int(x) for x in z["meta"])
    qtable = None
    if "qtable" in z:
        from find_circ2_tpu_torch.index.hashtable import (QueryTable,
                                                          TABLE_FORMAT)
        qmeta = z["qmeta"]
        version = int(qmeta[3]) if qmeta.size >= 4 else 1
        if version == TABLE_FORMAT:
            qtable = QueryTable(table=z["qtable"], meta=qmeta[:3])
        else:
            # A stale-format table hashes to the wrong buckets and
            # misses every lookup; drop it (rebuilt lazily by
            # DeviceIndex.build) instead of silently misbehaving.
            import sys
            print(f"load_index: dropping saved query table with format "
                  f"{version} (current {TABLE_FORMAT}; the hash mixer "
                  f"changed) — it will be rebuilt", file=sys.stderr)
    index = SeedIndex(anchor_len=a, prefix_len=pk,
                      positions=z["positions"],
                      suffix_vals=z["suffix_vals"],
                      offsets=z["offsets"], bsearch_iters=iters,
                      qtable=qtable)
    return genome, index
