"""Sharded detection over a (data, index) mesh, or (dhost, data, index)
for the hierarchical merge (reference: find_circ2_tpu/parallel/sharded.py).

Reads split across data rows; the seed index shards by k-mer prefix
range (index/hashtable.shard_query_table) across the index axis. Each
data row runs K1 on its row's index shards and combines the shards'
integer partials on the row's first device (ops/anchor_align
`*_sharded`); the rest of the detect step runs once there. Each shard
carries the range of the keys it owns (ops/anchor_align.key_ranges)
and looks up only those. On the card every shard but the first on the
row's device writes one record an anchor, a partials-mode launch of the
probe's or the enumeration's kernel on its own device, into the row's
[shards - 1, n, fields] buffer; that shard runs last, in the same
kernel's combining mode, and folds the buffer into its own partials and
finishes in the kernel's epilogue: no launch of its own for the combine.
On the CPU the plain parts.
Results equal the single-device path bit for bit.

The reference runs one program per slot, with psum/pmin collectives
inside; here one process drives every slot of its mesh block, so the
combine is a sum or minimum over stacked partials, with no host sync.

`detect_merged` collapses each data row's classic results (the packed
rows of detect's core, unpacked on the row's device) into a junction
table (ops/merge, K-h: csrc/merge.cu on the card), re-merges the rows'
tables, and with a "dhost" axis merges each dhost group first and the
groups' collapsed tables after.
Across processes (parallel/distributed.py) the tables cross on host
copies over gloo and merge on the card.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.index.build import SeedIndex
from find_circ2_tpu_torch.index.hashtable import (M32, build_neighbor_table,
                                                  build_query_table,
                                                  shard_neighbor_tables,
                                                  shard_query_table)
from find_circ2_tpu_torch.io.genome import Genome
from find_circ2_tpu_torch.models.pipeline import unpack_results
from find_circ2_tpu_torch.ops.anchor_align import (
    Shard, align_anchor_pair_fast_sharded, align_anchor_pair_sharded,
    key_ranges, read_anchors)
from find_circ2_tpu_torch.ops.detect import (PACK_FIELDS, detect_core,
                                            detect_core_packed)
from find_circ2_tpu_torch.ops.merge import (ALL_FIELDS, merge_junctions,
                                            merge_tables)
from find_circ2_tpu_torch.ops.packed import pack_words
from find_circ2_tpu_torch.utils.profiling import span


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in ("dhost", "data") if n in mesh.shape)


class _Row:
    """One data row: its first device, the genome there, and its index
    shards (`Shard`s, ntable None off the exact-first path), each on its
    slot's device."""

    def __init__(self, device, words, chrom_offsets, shards) -> None:
        self.device = device
        self.words = words
        self.chrom_offsets = chrom_offsets
        self.shards = shards


class ShardedEngine:
    """Places the genome and the index shards on the mesh and runs
    batches through the sharded step."""

    def __init__(self, genome: Genome, index: SeedIndex, mesh,
                 cfg: Config = Config(), prefilter: bool = True,
                 exact_first: bool | None = None) -> None:
        """`exact_first`: K1 v4 (4 row gathers per anchor), whose
        neighbour table is built once on the full table and relocated to
        the shards; None enables it below 256 Mi genome positions.
        `setup_s` records the seconds spent carving the shards
        ("carve") and relocating the neighbour table ("relocate")."""
        self.cfg = cfg
        self.mesh = mesh
        self.prefilter = prefilter
        self.nbases = len(genome)
        n_index = mesh.shape["index"]
        self.n_data = math.prod(mesh.shape[n] for n in _data_axes(mesh))
        if exact_first is None:
            exact_first = index.positions.size <= (256 << 20)
        if exact_first and index.qtable is None:
            index.qtable = build_query_table(index, cfg, extras=False)
        t0 = time.perf_counter()
        tables, metas = shard_query_table(index, n_index, cfg)
        self.setup_s = {"carve": time.perf_counter() - t0}
        ntables = None
        if exact_first:
            if index.qtable.ntable is None:
                index.qtable.ntable = build_neighbor_table(index, cfg)
            t0 = time.perf_counter()
            ntables = shard_neighbor_tables(index.qtable, tables)
            self.setup_s["relocate"] = time.perf_counter() - t0
        self.fast = ntables is not None

        # One copy of the genome per device and of each shard per
        # (device, shard): data rows that share a device share these.
        on_device: dict = {}

        def put(key, dev, make):
            if (key, dev) not in on_device:
                on_device[key, dev] = torch.from_numpy(make()).to(dev)
            return on_device[key, dev]

        words = pack_words(genome.codes)
        offsets = genome.chrom_offsets.astype(np.int64)
        owns = key_ranges(index.n_buckets, n_index)
        self.rows = []
        for devs in mesh.local_devices.reshape(-1, n_index):
            shards = tuple(
                Shard(put(("table", i), dev, lambda i=i: tables[i]),
                      None if ntables is None else
                      put(("ntable", i), dev, lambda i=i: ntables[i]),
                      put(("meta", i), dev, lambda i=i: metas[i]), owns[i])
                for i, dev in enumerate(devs))
            dev0 = devs[0]
            self.rows.append(_Row(dev0, put("words", dev0, lambda: words),
                                  put("offsets", dev0, lambda: offsets),
                                  shards))

    def _split(self, reads: np.ndarray, lens: np.ndarray):
        """This process's batch (its local slice of the global batch in a
        multi-process run) as one (row, reads, lens) per data row, each
        on its row's device."""
        n = len(self.rows)
        if reads.shape[0] % n:
            raise ValueError(f"batch of {reads.shape[0]} does not split over "
                             f"{n} data rows")
        per = reads.shape[0] // n
        with span("upload"):
            return [(row, *(torch.from_numpy(np.ascontiguousarray(
                            x[r * per:(r + 1) * per])).to(row.device)
                            for x in (reads, lens)))
                    for r, row in enumerate(self.rows)]

    def _align_row(self, row: _Row, reads, lens, classic: bool):
        """One data row's K1 over its index shards: (hits_a, hits_b,
        overflow), overflow None on the classic path. The phases carry
        the profiler labels read_anchors, k1_exact and k1_fallback, or
        k1_classic, as the single device's programs do."""
        cfg = self.cfg
        with record_function("read_anchors"):
            anchors_a, anchors_b = read_anchors(reads, lens, cfg)
        if self.fast and not classic:
            return align_anchor_pair_fast_sharded(row.shards, anchors_a,
                                                  anchors_b, cfg)
        with record_function("k1_classic"):
            return (*align_anchor_pair_sharded(row.shards, anchors_a,
                                               anchors_b, cfg), None)

    def _detect_row(self, row: _Row, reads, lens,
                    classic: bool = False) -> dict:
        """One data row's detect_core result dict; on the exact-first
        path `multi` bit 3 carries the row's fallback-overflow flag."""
        hits_a, hits_b, overflow = self._align_row(row, reads, lens, classic)
        res = detect_core(row.words, self.nbases, row.chrom_offsets, reads,
                          lens, hits_a, hits_b, self.cfg, self.prefilter)
        if overflow is not None:
            res["multi"] = res["multi"] | (overflow.to(torch.int32) << 3)
        return res

    def _packed_row(self, row: _Row, reads, lens,
                    classic: bool) -> torch.Tensor:
        """One data row's packed rows: K1, then detect_core_packed (the
        kernel on the card)."""
        hits_a, hits_b, overflow = self._align_row(row, reads, lens, classic)
        with record_function("detect_core"):
            return detect_core_packed(row.words, self.nbases,
                                      row.chrom_offsets, reads, lens,
                                      hits_a, hits_b, overflow, self.cfg,
                                      self.prefilter)

    def _packed(self, reads, lens, classic: bool) -> torch.Tensor:
        dev = self.rows[0].device
        parts = self._split(reads, lens)
        with span("launch"):
            return torch.cat([self._packed_row(*part, classic=classic)
                              .to(dev, non_blocking=True)
                              for part in parts])

    def detect(self, reads: np.ndarray, lens: np.ndarray) -> dict:
        """reads uint8 [B, Lp], lens int32 [B]; B % n_data == 0. The
        result arrays on the host; a fallback-overflow batch (multi bit
        3) is redone on the classic path."""
        dev = self.rows[0].device
        outs = [self._detect_row(*part) for part in self._split(reads, lens)]
        out = {k: torch.cat([o[k].to(dev) for o in outs]).cpu().numpy()
               for k in outs[0]}
        if self.fast and (out["multi"] & 8).any():
            out = unpack_results(self.redo_packed(reads, lens).cpu().numpy())
        return out

    def dispatch_packed(self, reads: np.ndarray, lens: np.ndarray
                        ) -> torch.Tensor:
        """The packed rows of a batch, enqueued without waiting (the
        streaming loops' `dispatch`). Pair with `redo_packed` on the
        multi bit 3 overflow flag (their `redo`)."""
        return self._packed(reads, lens, classic=False)

    def redo_packed(self, reads: np.ndarray, lens: np.ndarray
                    ) -> torch.Tensor:
        """The classic path's packed rows (the fallback-overflow redo)."""
        return self._packed(reads, lens, classic=True)

    def _merge_row(self, row: _Row, reads, lens) -> dict:
        """One data row's classic detect result as merge_junctions reads
        it: its packed rows (detect_core_packed, the kernel on the card)
        unpacked on the row's device, start and end back to int64."""
        packed = self._packed_row(row, reads, lens, classic=True)
        res = {k: packed[:, i].contiguous()
               for i, k in enumerate(PACK_FIELDS[:-1])}
        for k in ("start", "end"):
            res[k] = res[k].to(torch.int64) & M32
        return res

    def detect_merged(self, reads: np.ndarray, lens: np.ndarray) -> dict:
        """Sharded classic detect, then the junction merge over data rows,
        dhost groups and processes; one table of the global batch's
        length, on the host. Multi-hit-flagged reads are left out of the
        table (ops/merge.merge_junctions)."""
        dev = self.rows[0].device
        tables = [merge_junctions(self._merge_row(*part), part[2], self.cfg)
                  for part in self._split(reads, lens)]

        def stack(ts):
            return {k: torch.stack([t[k].to(dev) for t in ts])
                    for k in ALL_FIELDS}

        if "dhost" in self.mesh.shape:
            per = self.mesh.shape["data"]
            tables = [merge_tables(stack(tables[g:g + per]))
                      for g in range(0, len(tables), per)]
        out = merge_tables(self._gather_procs(stack(tables)))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _gather_procs(self, t: dict) -> dict:
        """Stacked tables [k, N] of every process, concatenated in rank
        order: one gloo all_gather of a host copy, packed as int64."""
        if self.mesh.nproc == 1:
            return t
        import torch.distributed as dist
        dev = t["valid"].device
        packed = torch.stack([t[k].to(torch.int64) for k in ALL_FIELDS]).cpu()
        parts = [torch.empty_like(packed) for _ in range(self.mesh.nproc)]
        dist.all_gather(parts, packed)
        whole = torch.cat(parts, dim=1).to(dev)
        return {k: whole[i].to(t[k].dtype) for i, k in enumerate(ALL_FIELDS)}
