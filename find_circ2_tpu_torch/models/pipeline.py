"""Single-device detect path (reference: find_circ2_tpu/models/pipeline.py).

One batch goes through K1 (ops/anchor_align: exact-first with the
enumeration fallback), pair canonicalization, the pass-1 contiguous
prefilter (SPEC.md §6) and K2 (ops/breakpoint), and comes back as one
packed int32 row per read. On the card K1 (the exact-first probe, the
fallback slice's compaction and enumeration, and the classic redo's
enumeration) and everything after it are hand-written CUDA kernels
(ops/anchor_align.exact_anchor_stats, fallback_slice, refill_slice,
classic_anchor_stats; ops/detect.detect_core_packed);
ops/detect.detect_core is the core's plain version, which CPU tensors
and the unpacked entries take. Reads whose anchors tie at the best hit go
through the §2b explore program (ops/explore, `DeviceExplorer`) one
stage later. Host code (`run_reads`) batches reads, streams them through
the device steps and yields the oracle's ReadCalls, so the CPU oracle
and this path give byte-identical BED tables.

Global positions are int64 tensors holding the reference's uint32
values; sums that wrap there are masked with `& 0xFFFFFFFF` here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from find_circ2_tpu_torch.config import (
    RPAD_CODE,
    Config,
    ST_JUNCTION,
    ST_PREFILTERED,
    ST_TOO_LONG,
    ST_TOO_SHORT,
    ST_UNALIGNED_A,
    ST_UNALIGNED_B,
)
from find_circ2_tpu_torch.index.build import SeedIndex, build_index
from find_circ2_tpu_torch.index.hashtable import (build_neighbor_table,
                                                  build_query_table)
from find_circ2_tpu_torch.io.genome import Genome
from find_circ2_tpu_torch.io.twobit import codes_to_seq, seq_to_codes
from find_circ2_tpu_torch.models.multihit import (call_read_multi,
                                                  call_reads_multi_batch)
from find_circ2_tpu_torch.models.oracle import ReadCall
from find_circ2_tpu_torch.ops.anchor_align import (
    AnchorHits, align_anchor_pair, align_anchor_pair_fast, read_anchors)
from find_circ2_tpu_torch.ops.detect import (PACK_FIELDS, detect_core,
                                            detect_core_packed)
from find_circ2_tpu_torch.ops.packed import pack_words
from find_circ2_tpu_torch.utils.profiling import span, timed

# Largest table (buckets) for which DeviceIndex.build makes the K1 v4
# neighbour table itself; beyond it the one-time build is a deliberate
# step (hashtable.build_neighbor_table, cached on the QueryTable).
AUTO_NTABLE_BUCKETS = 64 << 20


@dataclass(frozen=True)
class DeviceIndex:
    """Genome and k-mer query table as tensors on one device."""
    words: torch.Tensor          # int32 [ceil(G/8) + spare], ops/packed
    nbases: int                  # total genome codes
    table: torch.Tensor          # int32 [T, SLOTS*LANES] cuckoo table
    meta: torch.Tensor           # int32 [3] = (salt0, salt1, n_buckets)
    chrom_offsets: torch.Tensor  # int64 [n_chroms]
    # K1 v4 neighbour table (index/hashtable.build_neighbor_table); None
    # selects the classic enumeration. Results are identical either way.
    ntable: torch.Tensor | None = None
    # SPEC §2b extras of the device explore program (ops/explore); None
    # on tables built without extras (the host twin handles multi reads).
    ext: torch.Tensor | None = None      # int32 [R, 2*(K-1)], uint32 bits
    ext_id: torch.Tensor | None = None   # int32 [T, SLOTS]

    @classmethod
    def build(cls, genome: Genome, index: SeedIndex | None = None,
              cfg: Config = Config(), device="cuda") -> "DeviceIndex":
        """Tables from the numpy builders (index/hashtable; built and
        cached on `index.qtable` if missing), moved to `device`: the card
        unless the caller asks for the CPU (RuntimeError without one)."""
        if index is None:
            index = build_index(genome, cfg)
        if len(genome) >= 2 ** 32 - 2 * cfg.chrom_gap:
            raise ValueError("genome must fit uint32 positions "
                             "(< ~4.29 Gbp incl. sentinel gaps)")
        if index.qtable is None:
            index.qtable = build_query_table(index, cfg)
        qtable = index.qtable
        if qtable.ntable is None and qtable.n_buckets <= AUTO_NTABLE_BUCKETS:
            qtable.ntable = build_neighbor_table(index, cfg)
        return cls._from_arrays(pack_words(genome.codes), len(genome),
                                qtable.table, qtable.meta,
                                genome.chrom_offsets, qtable.ntable,
                                qtable.ext, qtable.ext_id, device)

    @classmethod
    def from_reference(cls, ref, device="cuda") -> "DeviceIndex":
        """The same index from the JAX package's DeviceIndex, read
        through np.asarray (nothing of that package is imported here):
        its 2-D [n_rows, WPR] packed genome becomes the flat word array.
        On the card unless the caller asks for the CPU."""
        def arr(x):
            return None if x is None else np.asarray(x)
        gpacked = np.asarray(ref.gpacked)
        return cls._from_arrays(gpacked.reshape(-1).view(np.int32),
                                int(ref.nbases), np.asarray(ref.table),
                                np.asarray(ref.meta),
                                np.asarray(ref.chrom_offsets),
                                arr(ref.ntable), arr(ref.ext),
                                arr(ref.ext_id), device)

    @classmethod
    def _from_arrays(cls, words, nbases, table, meta, chrom_offsets, ntable,
                     ext, ext_id, device) -> "DeviceIndex":
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceIndex: device 'cuda' but no CUDA "
                               "device is available (pass device='cpu' to "
                               "run on the CPU)")

        def t(x, dtype):
            if x is None:
                return None
            a = np.ascontiguousarray(x)
            if a.dtype == np.uint32 and dtype == np.int32:
                a = a.view(np.int32)       # uint32 rows keep their bits
            a = np.ascontiguousarray(a, dtype)
            if not a.flags.writeable:      # e.g. a view of a jax array
                a = a.copy()
            return torch.from_numpy(a).to(device)
        return cls(words=t(words, np.int32), nbases=nbases,
                   table=t(table, np.int32), meta=t(meta, np.int32),
                   chrom_offsets=t(chrom_offsets, np.int64),
                   ntable=t(ntable, np.int32), ext=t(ext, np.int32),
                   ext_id=t(ext_id, np.int32))

    @property
    def device(self) -> torch.device:
        return self.table.device


def encode_batch(seqs, rows: int, Lp: int):
    """Reads (str) -> uint8 [rows, Lp] codes, RPAD-padded, and int32
    [rows] lengths; rows past len(seqs) are padding (length 0)."""
    arr = np.full((rows, Lp), RPAD_CODE, dtype=np.uint8)
    lens = np.zeros(rows, np.int32)
    for i, seq in enumerate(seqs):
        codes = seq_to_codes(seq)
        arr[i, :codes.size] = codes
        lens[i] = codes.size
    return arr, lens


def revcomp_batch(arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Host-side left-aligned reverse complement of an encoded batch. No
    detect path calls it (the detect kernel and ops/detect's plain
    version build the reverse complement themselves); `--pe`'s second
    mates (models/stream.run_fastq) and the tests do."""
    Lp = arr.shape[1]
    pos = np.arange(Lp, dtype=np.int64)[None, :]
    idx = np.clip(lens[:, None] - 1 - pos, 0, Lp - 1)
    r = np.take_along_axis(arr, idx, axis=1)
    r = np.where(r < 4, 3 - r, r)
    return np.where(pos < lens[:, None], r, RPAD_CODE).astype(np.uint8)


def detect_batch(words, nbases: int, table, meta, chrom_offsets, reads,
                 lens, cfg: Config, prefilter: bool = True,
                 rc=None) -> dict:
    """Full classic detection step (enumeration K1) as the dict of [B]
    result tensors (signal [B, 4]); the unpacked form of
    detect_batch_packed."""
    hits_a, hits_b = _align_phase(table, meta, reads, lens, cfg)
    return detect_core(words, nbases, chrom_offsets, reads, lens, hits_a,
                       hits_b, cfg, prefilter, rc)


def _align_phase(table, meta, reads, lens, cfg: Config
                 ) -> tuple[AnchorHits, AnchorHits]:
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    return align_anchor_pair(table, meta, anchors_a, anchors_b, cfg)


def _align_phase_fast(table, ntable, meta, reads, lens, cfg: Config):
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    return align_anchor_pair_fast(table, ntable, meta, anchors_a, anchors_b,
                                  cfg)


def _core_phase(words, nbases: int, chrom_offsets, reads, lens, hits_a,
                hits_b, cfg: Config, prefilter: bool, rc=None) -> dict:
    return detect_core(words, nbases, chrom_offsets, reads, lens, hits_a,
                       hits_b, cfg, prefilter, rc)


def detect_batch_phased(dindex: "DeviceIndex", reads, lens, cfg: Config,
                        prefilter: bool = True, rc=None) -> dict:
    """The detection step as its two phases, K1 (exact-first when the
    index has a neighbour table) then the core, as the dict of
    detect_batch. The fallback-overflow flag is dropped: this entry does
    not redo a batch (the streaming paths do)."""
    d = dindex
    if d.ntable is not None:
        hits_a, hits_b, _ = _align_phase_fast(d.table, d.ntable, d.meta,
                                              reads, lens, cfg)
    else:
        hits_a, hits_b = _align_phase(d.table, d.meta, reads, lens, cfg)
    return _core_phase(d.words, d.nbases, d.chrom_offsets, reads, lens,
                       hits_a, hits_b, cfg, prefilter, rc)


def detect_batch_packed(words, nbases: int, table, meta, chrom_offsets,
                        reads, lens, cfg: Config,
                        prefilter: bool) -> torch.Tensor:
    """Full classic detection step (enumeration K1) -> int32 [B, 14]."""
    with record_function("read_anchors"):
        anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    with record_function("k1_classic"):
        hits_a, hits_b = align_anchor_pair(table, meta, anchors_a,
                                           anchors_b, cfg)
    with record_function("detect_core"):
        return detect_core_packed(words, nbases, chrom_offsets, reads, lens,
                                  hits_a, hits_b, None, cfg, prefilter)


def detect_batch_packed_fast(words, nbases: int, table, ntable, meta,
                             chrom_offsets, reads, lens, cfg: Config,
                             prefilter: bool) -> torch.Tensor:
    """detect_batch_packed on the K1 v4 exact-first path. Identical rows,
    except that `multi` bit 3 carries the batch-wide fallback-overflow
    flag: when set, the batch's fast-path statistics are not to be
    trusted and the caller redoes it (`redo_if_overflow`). Its phases
    carry the profiler labels read_anchors, k1_exact, k1_fallback and
    detect_core."""
    with record_function("read_anchors"):
        anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    hits_a, hits_b, overflow = align_anchor_pair_fast(
        table, ntable, meta, anchors_a, anchors_b, cfg)
    with record_function("detect_core"):
        return detect_core_packed(words, nbases, chrom_offsets, reads, lens,
                                  hits_a, hits_b, overflow, cfg, prefilter)


def _to_device(dindex: DeviceIndex, arr: np.ndarray, lens: np.ndarray):
    dev = dindex.device
    with span("upload"):
        return (torch.from_numpy(np.ascontiguousarray(arr)).to(dev),
                torch.from_numpy(np.ascontiguousarray(lens, np.int32))
                .to(dev))


def dispatch_packed(dindex: DeviceIndex, arr, lens, cfg: Config,
                    prefilter: bool = True) -> torch.Tensor:
    """Enqueue one encoded batch (uint8 [B, Lp], int32 [B]) on the
    device: exact-first when the index has a neighbour table, classic
    otherwise. Returns the packed rows without waiting; pair with
    `redo_if_overflow` when they are read."""
    d = dindex
    reads, lens_t = _to_device(d, arr, lens)
    with span("launch"):
        if d.ntable is not None:
            return detect_batch_packed_fast(
                d.words, d.nbases, d.table, d.ntable, d.meta,
                d.chrom_offsets, reads, lens_t, cfg, prefilter)
        return detect_batch_packed(d.words, d.nbases, d.table, d.meta,
                                   d.chrom_offsets, reads, lens_t, cfg,
                                   prefilter)


def redo_if_overflow(dindex: DeviceIndex | None, res: dict, arr, lens,
                     cfg: Config, prefilter: bool = True,
                     redo=None) -> dict:
    """If the unpacked batch carries the fallback-overflow flag (multi
    bit 3), redo it on the classic program and return its results;
    otherwise return `res`. `redo(arr, lens) -> packed rows`, when given,
    is that program (the sharded engine's `redo_packed`) in place of the
    single device's. Synchronous (rare path)."""
    if not (res["multi"] & 8).any():
        return res
    if redo is not None:
        return unpack_results(redo(arr, lens).cpu().numpy())
    if dindex is None or dindex.ntable is None:
        return res
    d = dindex
    reads, lens_t = _to_device(d, arr, lens)
    packed = detect_batch_packed(d.words, d.nbases, d.table, d.meta,
                                 d.chrom_offsets, reads, lens_t, cfg,
                                 prefilter)
    return unpack_results(packed.cpu().numpy())


def unpack_results(packed: np.ndarray) -> dict:
    """Host-side inverse of the packing (numpy)."""
    out = {k: packed[:, i] for i, k in enumerate(PACK_FIELDS[:-1])}
    out["start"] = out["start"].view(np.uint32)
    out["end"] = out["end"].view(np.uint32)
    sig = packed[:, len(PACK_FIELDS) - 1]
    out["signal"] = np.stack([sig & 7, (sig >> 3) & 7, (sig >> 6) & 7,
                              (sig >> 9) & 7], axis=1).astype(np.uint8)
    return out


def call_from_row(res: dict, i: int, name: str, seq: str) -> ReadCall:
    """One unpacked result row -> ReadCall (non-junction statuses carry
    no junction fields, as the oracle's)."""
    status = int(res["status"][i])
    if status != ST_JUNCTION:
        return ReadCall(name, seq, status)
    return ReadCall(
        name=name, seq=seq, status=status,
        kind=int(res["kind"][i]),
        chrom_idx=int(res["chrom"][i]),
        start=int(res["start"][i]),
        end=int(res["end"][i]),
        sense=int(res["sense"][i]),
        align_strand=int(res["align_strand"][i]),
        edits=int(res["edits"][i]),
        n_bp=int(res["n_bp"][i]),
        overlap=int(res["overlap"][i]),
        qual_left=int(res["qual_left"][i]),
        qual_right=int(res["qual_right"][i]),
        signal=codes_to_seq(res["signal"][i]),
    )


class HostCopy:
    """A packed device result on its way to the host: a non-blocking
    copy into pinned memory plus a CUDA event recorded behind it, so the
    streaming loops can enqueue later batches before reading this one.
    On the CPU the tensor is used as it is."""

    def __init__(self, packed: torch.Tensor) -> None:
        with span("readback"):
            if packed.device.type == "cuda":
                self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                        pin_memory=True)
                self.host.copy_(packed, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(packed.device))
            else:
                self.host, self.event = packed, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class DeviceExplorer:
    """Asynchronous dispatcher of the §2b explore program
    (ops/explore.explore_batch_packed) for routed reads.

    Reads go in chunks of at most BUCKETS[-1] rows, each padded to the
    smallest bucket that holds it, so a chunk takes one of three shapes.
    On the card the pair kernel keeps no split grid (one block per read);
    a CPU chunk's plain version holds a [B, K, K, Lp+1] grid, which the
    buckets bound. Each chunk's packed rows come back through a
    HostCopy, so a streaming loop can enqueue later detect batches
    before it fetches the results. A failure raises: there is no host
    fallback."""

    BUCKETS = (32, 256, 1024)

    def __init__(self, dindex: DeviceIndex, cfg: Config,
                 prefilter: bool = True) -> None:
        if dindex.ext is None or dindex.ext_id is None:
            raise ValueError("DeviceIndex was built without §2b extras "
                             "(extras=False); use the host twin "
                             "(explore=False)")
        self.dindex = dindex
        self.cfg = cfg
        self.prefilter = prefilter

    def dispatch(self, items: list[tuple[str, str]]):
        """Enqueue routed (name, seq) reads of valid length; returns a
        handle for `fetch`."""
        arr, lens = encode_batch([seq for _, seq in items], len(items),
                                 self.cfg.max_read_len)
        return items, self.dispatch_arrays(arr, lens)

    def fetch(self, handle) -> list[ReadCall]:
        """Wait for a `dispatch` handle; its ReadCalls in order."""
        items, chunks = handle
        res = self.fetch_arrays(chunks)
        return [call_from_row(res, i, name, seq)
                for i, (name, seq) in enumerate(items)]

    def dispatch_arrays(self, arr: np.ndarray, lens: np.ndarray):
        """Enqueue already-encoded routed reads (uint8 [n, Lp], int32
        [n]), as the streaming loop's batch holds them; returns a handle
        for `fetch_arrays`."""
        from find_circ2_tpu_torch.ops.explore import explore_batch_packed
        d, dev = self.dindex, self.dindex.device
        chunks = []
        for lo in range(0, arr.shape[0], self.BUCKETS[-1]):
            n = min(self.BUCKETS[-1], arr.shape[0] - lo)
            bs = next(b for b in self.BUCKETS if b >= n)
            rows = np.full((bs, arr.shape[1]), RPAD_CODE, np.uint8)
            rows[:n] = arr[lo:lo + n]
            blens = np.zeros(bs, np.int32)
            blens[:n] = lens[lo:lo + n]
            packed = explore_batch_packed(
                d.words, d.nbases, d.table, d.meta, d.ext, d.ext_id,
                d.chrom_offsets, torch.from_numpy(rows).to(dev),
                torch.from_numpy(blens).to(dev), self.cfg, self.prefilter)
            chunks.append((n, HostCopy(packed)))
        return chunks

    def fetch_arrays(self, chunks) -> dict:
        """Wait for a `dispatch_arrays` handle; the unpacked result
        arrays over all chunks (row i = routed read i)."""
        packed = np.concatenate([copy.numpy()[:n] for n, copy in chunks])
        return unpack_results(packed)


def run_reads(dindex: DeviceIndex | None, reads, cfg: Config = Config(),
              prefilter: bool = True, batch_size: int | None = None,
              journal=None, times=None, pipeline_depth: int = 2,
              slowpath=None, dispatch=None, explore: bool | None = None,
              redo=None):
    """Host streaming loop: batch (name, seq) reads, run the device step
    `pipeline_depth` batches ahead of the readback, and return the
    ReadCalls in input order.

    `slowpath` = (genome, index) enables SPEC §2b multi-hit pairing and
    the §2 2-mm anchor rescue. Without it multi reads keep their
    single-best device result. `explore` picks where §2b runs: None uses
    the device program (`DeviceExplorer`) when the index has §2b extras,
    else the host twin (models/multihit); True forces the device program
    (ValueError without extras); False forces the host twin. All three
    give the same calls. The 2-mm rescue always runs on the host.

    `dispatch(arr [bs, Lp] uint8, lens [bs] int32) -> packed rows`
    replaces the single-device step, and `redo(arr, lens)` its classic
    redo of a fallback-overflow batch: the sharded engine plugs in here
    (parallel.sharded.ShardedEngine.dispatch_packed, .redo_packed), with
    `dindex` None and no device explore. With a
    `journal` (utils.journal.RunJournal) completed batches replay from
    disk; `times` (utils.profiling.StageTimes) collects per-stage wall
    time.
    """
    from collections import deque

    bs = batch_size or cfg.batch_size
    Lp = cfg.max_read_len
    buf: list[tuple[str, str]] = []
    out: list[ReadCall] = []
    done = journal.completed_batches() if journal is not None else {}
    batch_id = 0
    inflight: deque = deque()   # (batch_id, records, HostCopy, arr, lens)
    if explore is None:
        explore = (slowpath is not None and dindex is not None
                   and dindex.ext is not None)
    explorer = DeviceExplorer(dindex, cfg, prefilter) if explore else None
    # Batches whose routed reads await explore results, one stage behind
    # detect: (batch_id, batch_calls with None slots, slots, handle).
    finishing: deque = deque()

    def finalize() -> None:
        this_id, batch_calls, route_slots, handle = finishing.popleft()
        if handle is not None:
            with timed(times, "explore_multihit"):
                calls = explorer.fetch(handle)
            for slot, call in zip(route_slots, calls):
                batch_calls[slot] = call
        if journal is not None and this_id is not None:
            journal.record(this_id, batch_calls)
        if times is not None and this_id is not None:
            times.add_reads(len(batch_calls))
        out.extend(batch_calls)

    def consume() -> None:
        this_id, records, copy, arr, blens = inflight.popleft()
        if copy is None:            # journal replay / loose ReadCalls
            finishing.append((None, records, (), None))
        else:
            finishing.append((this_id, *recall(records, copy, arr, blens)))
        # One explore-pending batch stays in flight, so its program
        # overlaps the next detect batch.
        while len(finishing) > 1:
            finalize()

    def recall(records, copy, arr, blens):
        """A detect batch's calls: rescued reads re-called on the host
        now, routed reads dispatched to the explorer (their slots stay
        None until finalize)."""
        with timed(times, "device_detect"):
            res = redo_if_overflow(dindex, unpack_results(copy.numpy()),
                                   arr, blens, cfg, prefilter, redo)
        batch_calls: list[ReadCall] = []
        route_slots: list[int] = []
        routed: list[tuple[str, str]] = []
        rescue_slots: list[int] = []
        rescued: list[tuple[str, str]] = []
        for i, (name, seq) in enumerate(records):
            status = int(res["status"][i])
            if (slowpath is not None and cfg.rescue_anchor_mm >= 2
                    and status in (ST_UNALIGNED_A, ST_UNALIGNED_B)
                    and res["multi"][i] & 2):
                # §2 2-mm anchor rescue [FROZEN v4], batched below; only
                # reads whose mate anchor aligned can pass its mate gate.
                # It precedes §2b: the explore program knows only the
                # <=1-mm ball.
                rescue_slots.append(len(batch_calls))
                rescued.append((name, seq))
                batch_calls.append(None)
                continue
            if ((slowpath is not None or explorer is not None)
                    and res["multi"][i] & 1 and status != ST_PREFILTERED):
                # SPEC §2b: anchor best-hit tie -> pair exploration.
                if explorer is not None:
                    route_slots.append(len(batch_calls))
                    routed.append((name, seq))
                    batch_calls.append(None)
                    continue
                with timed(times, "slowpath_multihit"):
                    batch_calls.append(call_read_multi(
                        slowpath[0], slowpath[1], name, seq, cfg,
                        prefilter))
                continue
            batch_calls.append(call_from_row(res, i, name, seq))
        if rescued:
            with timed(times, "slowpath_rescue"):
                calls = call_reads_multi_batch(slowpath[0], slowpath[1],
                                               rescued, cfg, prefilter)
            for slot, call in zip(rescue_slots, calls):
                batch_calls[slot] = call
        handle = None
        if routed:
            with timed(times, "explore_dispatch"):
                handle = explorer.dispatch(routed)
        return batch_calls, route_slots, handle

    def flush() -> None:
        nonlocal batch_id
        if not buf:
            return
        this_id = batch_id
        batch_id += 1
        if this_id in done:
            replay = done[this_id]
            if len(replay) != len(buf):
                raise ValueError(
                    f"journal batch {this_id} has {len(replay)} calls, "
                    f"input has {len(buf)}: input changed since journal")
            inflight.append((this_id, replay, None, None, None))
        else:
            with timed(times, "encode"):
                arr, lens = encode_batch([seq for _, seq in buf], bs, Lp)
            with timed(times, "device_dispatch"):
                copy = HostCopy(
                    dispatch(arr, lens) if dispatch is not None
                    else dispatch_packed(dindex, arr, lens, cfg, prefilter))
            inflight.append((this_id, list(buf), copy, arr, lens))
        buf.clear()
        if len(inflight) > pipeline_depth:
            consume()

    def loose(call: ReadCall) -> None:
        # Skipped reads keep their position relative to batch results
        # by riding the same FIFO (coalesced when consecutive).
        if inflight and inflight[-1][0] is None:
            inflight[-1][1].append(call)
        else:
            inflight.append((None, [call], None, None, None))

    for name, seq in reads:
        if len(seq) < 2 * cfg.anchor_len:
            loose(ReadCall(name, seq, ST_TOO_SHORT))
            continue
        if len(seq) > cfg.max_read_len:
            loose(ReadCall(name, seq, ST_TOO_LONG))
            continue
        buf.append((name, seq))
        if len(buf) == bs:
            flush()
    flush()
    while inflight:
        consume()
    while finishing:
        finalize()
    return out
