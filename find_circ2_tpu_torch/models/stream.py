"""The streaming loop (reference: find_circ2_tpu/models/stream.py):
encoded read batches -> device -> per-read results, from two sources.

One loop (`_Loop`) serves both. It dispatches each encoded batch
PIPELINE_DEPTH batches ahead of its readback: the packed rows come back
through a non-blocking copy into pinned memory with a CUDA event, waited
on only when the batch is consumed. There it redoes a fallback-overflow
batch, splits the reads into plain, junction, rescued and routed, sends
rescued reads (and routed reads when §2b runs on the host twin) to the
batched host re-calls, in a forked worker when one can start, and routed
reads to the device explore program (pipeline.DeviceExplorer) from the
batch's own rows. PIPELINE_DEPTH batches later again the batch is
finished: detect's unpacked arrays with the explore rows written into the
routed rows, and the host calls keyed by row.

- `run_fastq` reads a FASTQ(.gz) file with the native C loader and
  aggregates each finished batch into an Aggregator as arrays; no
  per-read Python object is made except for host-recalled reads (and for
  a journal's record).
- `run_reads` encodes (name, seq) reads and returns the oracle's
  ReadCalls in input order.

The two give the same BED (the tests compare the bytes).
"""

from __future__ import annotations

import gzip
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from find_circ2_tpu_torch import native
from find_circ2_tpu_torch.config import (RPAD_CODE, Config, ST_JUNCTION,
                                         ST_PREFILTERED, ST_TOO_LONG,
                                         ST_TOO_SHORT, ST_UNALIGNED_A,
                                         ST_UNALIGNED_B)
from find_circ2_tpu_torch.io.twobit import _CODE_LUT, revcomp_seq
from find_circ2_tpu_torch.models.aggregate import Aggregator, seq_hash_batch
from find_circ2_tpu_torch.models.multihit import call_reads_multi_batch
from find_circ2_tpu_torch.models.oracle import ReadCall
from find_circ2_tpu_torch.models.pipeline import (
    DeviceExplorer, DeviceIndex, HostCopy, call_from_row, dispatch_packed,
    encode_batch, redo_if_overflow, revcomp_batch, unpack_results)
from find_circ2_tpu_torch.utils.journal import FastBatch
from find_circ2_tpu_torch.utils.profiling import count, span, timed

CHUNK = 16 << 20  # bytes per read(2) chunk
# Batches the loop dispatches ahead of their readback, and batches whose
# host re-calls and explore programs it keeps in flight after that.
PIPELINE_DEPTH = 4


class _RescuePool:
    """One forked worker that runs the batched host re-calls (the 2-mm
    rescue, and §2b multi-hit when explore is off; the port's
    models/multihit.call_reads_multi_batch) off the critical path. Fork
    shares genome and index copy-on-write; the child runs numpy only and
    never touches CUDA or torch. The pool forks after the device is up,
    and a child forked while another thread held a lock can hang: so the
    worker must answer a ping within PING_S at start-up, or the run goes
    inline from the start instead of losing TIMEOUT_S on its first
    batch. Any failure (no fork, no answer, crash, timeout) permanently
    falls back to in-process calls — results are identical either way.
    `fetch` gives the calls and the microseconds their computation took,
    in the worker or inline."""

    TIMEOUT_S = 120.0
    PING_S = 10.0

    def __init__(self, genome, index, cfg, prefilter: bool) -> None:
        self.args = (genome, index, cfg, prefilter)
        self.pool = None
        try:
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            global _RESCUE_STATE
            _RESCUE_STATE = self.args
            self.pool = ctx.Pool(1)
            self.pool.apply_async(_rescue_ping).get(timeout=self.PING_S)
        except Exception:
            self._disable()

    def submit(self, items):
        if self.pool is None:
            return items          # sync marker: compute at fetch time
        try:
            h = self.pool.apply_async(_rescue_entry, (items,))
        except Exception:
            self._disable()
            return items
        h._fc2_items = items
        return h

    def fetch(self, handle):
        if isinstance(handle, list):  # sync marker
            return _recall(*self.args, handle)
        try:
            return handle.get(timeout=self.TIMEOUT_S)
        except Exception:
            # Worker died or hung: kill it, recompute inline, and stay
            # inline for the rest of the run.
            self._disable()
            return self.fetch(handle._fc2_items)

    def _disable(self) -> None:
        if self.pool is not None:
            try:
                self.pool.terminate()
            except Exception:
                pass
            self.pool = None

    def close(self) -> None:
        self._disable()


_RESCUE_STATE = None


def _rescue_ping() -> bool:
    return True


def _recall(genome, index, cfg, prefilter: bool, items):
    """The batched host re-calls of (name, seq) items, and the
    microseconds they took."""
    t0 = time.perf_counter()
    calls = call_reads_multi_batch(genome, index, items, cfg, prefilter)
    return calls, round(1e6 * (time.perf_counter() - t0))


def _rescue_entry(items):
    return _recall(*_RESCUE_STATE, items)


def _iter_records(path):
    """Yield (buffer, spans) chunks via the native FASTQ scanner."""
    opener = gzip.open if os.fspath(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        pending = b""
        while True:
            chunk = fh.read(CHUNK)
            buf = pending + chunk
            if not buf:
                return
            spans, resume = native.parse_fastq(buf)
            if spans.shape[0] == 0 and not chunk:
                if resume < len(buf):
                    raise ValueError("trailing partial FASTQ record")
                return
            yield buf, spans
            pending = buf[resume:]
            if not chunk and not pending:
                return
            if not chunk and pending:
                raise ValueError("trailing partial FASTQ record")


@dataclass
class _Batch:
    """An encoded batch: uint8 [bs, Lp] rows and int32 [bs] lengths, of
    which the first `n` hold reads. `read(i)` gives row i's (name, seq);
    only a host re-call or a journal record asks for it. `slots` are
    run_reads' output positions of the rows."""
    batch_id: int
    n: int
    arr: np.ndarray
    lens: np.ndarray
    read: Callable[[int], tuple[str, str]]
    slots: list | None = None


def _status_counts(status: np.ndarray) -> dict[int, int]:
    """Reads of each status present."""
    n = np.bincount(status)
    return {int(st): int(n[st]) for st in np.flatnonzero(n)}


def _add_counts(stats, counts: dict[int, int]) -> None:
    if counts:
        stats.add("reads_total", sum(counts.values()))
    for st, n in counts.items():
        stats.add_status(st, n)


class _Loop:
    """The dispatch -> consume -> finalize machinery both sources share.
    `put` enqueues a batch; `drain` finishes every batch in flight. Each
    finished batch, in order, is handed to `finish(batch, res, routed,
    host_rows, host_calls)`: `res` holds detect's unpacked arrays, with
    the device explore program's rows written into the `routed` rows
    (bool [n]); `host_calls` are the host re-calls' ReadCalls of
    `host_rows`, whose rows of `res` are detect's and unused. A context
    manager: leaving it stops the rescue worker.

    `slowpath` = (genome, index) enables §2b multi-hit pairing and the §2
    2-mm rescue; the rescue runs on the host (models/multihit), in a
    forked worker when one can start (never with a journal). `explore`
    picks where §2b runs: None uses the device program when the index
    has §2b extras, True forces it (ValueError without extras), False
    sends routed reads to the host twin. `dispatch(arr, lens) -> packed
    rows` and `redo(arr, lens)` replace the single-device step and its
    classic redo of a fallback-overflow batch: the sharded engine's
    (parallel.sharded.ShardedEngine.dispatch_packed, .redo_packed), with
    `dindex` None and routed reads on the host twin."""

    def __init__(self, dindex: DeviceIndex | None, cfg: Config,
                 prefilter: bool, times, slowpath, explore, dispatch, redo,
                 journal, finish) -> None:
        self.dindex, self.cfg, self.prefilter = dindex, cfg, prefilter
        self.times, self.slowpath, self.finish = times, slowpath, finish
        self.dispatch, self.redo = dispatch, redo
        self.inflight: deque = deque()    # (batch, HostCopy)
        # Batches whose host re-calls or explore programs still run:
        # (batch, res, routed, explore handle, host re-calls)
        self.finishing: deque = deque()
        if explore is None:
            explore = (slowpath is not None and dindex is not None
                       and dindex.ext is not None)
        with timed(times, "stream_start"):
            self.explorer = (DeviceExplorer(dindex, cfg, prefilter)
                             if explore else None)
            self.rpool = None
            if (slowpath is not None and cfg.rescue_anchor_mm >= 2
                    and journal is None):
                rpool = _RescuePool(*slowpath, cfg, prefilter)
                if rpool.pool is not None:
                    self.rpool = rpool

    def __enter__(self) -> "_Loop":
        return self

    def __exit__(self, *exc) -> None:
        with timed(self.times, "stream_stop"):
            if self.rpool is not None:
                self.rpool.close()

    def put(self, b: _Batch) -> None:
        with timed(self.times, "device_dispatch"):
            copy = HostCopy(
                self.dispatch(b.arr, b.lens) if self.dispatch is not None
                else dispatch_packed(self.dindex, b.arr, b.lens, self.cfg,
                                     self.prefilter))
        self.inflight.append((b, copy))
        if len(self.inflight) > PIPELINE_DEPTH:
            self._consume()

    def drain(self) -> None:
        while self.inflight:
            self._consume()
        while self.finishing:
            self._finalize()

    def _host_recall(self, b: _Batch, rows: np.ndarray, stage: str):
        """The batched host re-call of `rows`: (stage, rows, handle for
        _finalize, None) when the worker runs, else (stage, rows, None,
        the calls now)."""
        if not rows.size:
            return stage, rows, None, []
        # Each row's (name, seq), cut from the file's buffer (a `--pe`
        # mate 2 reverse-complemented read by read), is a stage of its
        # own, apart from the re-calls' timers.
        with timed(self.times, "recall_items"):
            items = [b.read(i) for i in rows]
        if self.rpool is not None:
            with timed(self.times, "rescue_dispatch"):
                return stage, rows, self.rpool.submit(items), None
        with timed(self.times, stage):
            calls, us = _recall(*self.slowpath, self.cfg, self.prefilter,
                                items)
            count("worker_us", us)
        return stage, rows, None, calls

    def _consume(self) -> None:
        b, copy = self.inflight.popleft()
        cfg, times, n = self.cfg, self.times, b.n
        with timed(times, "device_detect"):
            res = redo_if_overflow(self.dindex, unpack_results(copy.numpy()),
                                   b.arr, b.lens, cfg, self.prefilter,
                                   self.redo)
        # The slow-path stages keep their own timers; "aggregate" must
        # not enclose them or the report double-counts.
        with timed(times, "aggregate"):
            status, multi = res["status"][:n], res["multi"][:n]
            # §2 2-mm anchor rescue [FROZEN v4] takes precedence over
            # §2b routing; gated on the rescuable bit (exactly one
            # anchor unaligned — the host mate gate).
            if self.slowpath is not None and cfg.rescue_anchor_mm >= 2:
                rescue = (np.isin(status, (ST_UNALIGNED_A, ST_UNALIGNED_B))
                          & ((multi & 2) != 0))
                # The reads handed to the rescue, in the worker or inline.
                count("rescue_reads", int(np.count_nonzero(rescue)))
            else:
                rescue = np.zeros(n, bool)
            if self.slowpath is not None or self.explorer is not None:
                route = ((multi & 1) != 0) & (status != ST_PREFILTERED) \
                    & ~rescue
            else:
                route = np.zeros(n, bool)
        # The rescue is submitted first, so the worker starts on it while
        # the device explores.
        recalls = [self._host_recall(b, np.flatnonzero(rescue),
                                     "slowpath_rescue")]
        xhandle = None
        if self.explorer is None:
            # §2b on the host twin.
            recalls.append(self._host_recall(b, np.flatnonzero(route),
                                             "slowpath_multihit"))
            route = np.zeros(n, bool)
        elif route.any():
            ridx = np.flatnonzero(route)
            with timed(times, "explore_dispatch"):
                count("reads", int(ridx.size))
                xhandle = self.explorer.dispatch_arrays(b.arr[ridx],
                                                        b.lens[ridx])
        self.finishing.append((b, res, route, xhandle, recalls))
        # Keep host re-calls and explore programs in flight so they
        # overlap later batches.
        while len(self.finishing) > PIPELINE_DEPTH:
            self._finalize()

    def _finalize(self) -> None:
        b, res, routed, xhandle, recalls = self.finishing.popleft()
        rows, calls = [], []
        for stage, idx, handle, got in recalls:
            if handle is not None:
                with timed(self.times, stage):
                    got, us = self.rpool.fetch(handle)
                    count("worker_us", us)
            rows.append(idx)
            calls += got
        if xhandle is not None:
            with timed(self.times, "explore_multihit"):
                resx = self.explorer.fetch_arrays(xhandle)
                ridx = np.flatnonzero(routed)
                for k, col in resx.items():
                    res[k][ridx] = col
        self.finish(b, res, routed, np.concatenate(rows), calls)


def run_fastq(dindex: DeviceIndex | None, path, agg: Aggregator,
              cfg: Config = Config(), prefilter: bool = True,
              batch_size: int | None = None, times=None, slowpath=None,
              journal=None, revcomp: bool = False,
              explore: bool | None = None, dispatch=None,
              shard: tuple[int, int] | None = None, redo=None) -> None:
    """Stream a FASTQ(.gz) file through the device pipeline into `agg`.

    Aggregation is order-insensitive, so the order batches finish in
    does not affect the output. `slowpath`, `explore`, `dispatch` and
    `redo` as in `_Loop`. `journal` (utils.journal.RunJournal): each
    finished batch is recorded as a compact FastBatch (the plain reads'
    status counts, and the calls of every other read), and completed
    batches replay from it on rerun. `revcomp=True` reverse-complements
    every read after encoding (the --pe mate-2 transform, SPEC.md §7).

    `shard=(proc_id, nproc)` is the multi-process mode (`find_circ
    --nproc`): every process scans the file but encodes and detects only
    the batches with batch_id % nproc == proc_id, and rank 0 alone counts
    the reads that are out of batch (too short, too long). Each process's
    stats cover its own batches; the caller sums them over the processes.
    The ranks together process each read once, and the junction merge is
    order-free, so the merged output equals a one-process run."""
    if not native.available():
        raise RuntimeError("native loader unavailable; use run_reads")
    bs = batch_size or cfg.batch_size
    Lp = cfg.max_read_len
    a2 = 2 * cfg.anchor_len
    done = journal.completed_batches() if journal is not None else {}
    next_batch_id = 0

    def aggregate(b: _Batch, res: dict, routed, host_rows,
                  host_calls: list) -> None:
        """One add_batch over every junction row (from detect or from
        explore), the other device rows' statuses in bulk, and `add` for
        the host calls."""
        with timed(times, "aggregate"):
            status = res["status"][:b.n]
            dev = np.ones(b.n, bool)
            dev[host_rows] = False
            junction = dev & (status == ST_JUNCTION)
            jidx = np.flatnonzero(junction)
            agg.add_batch(res, jidx, seq_hash_batch(b.arr[jidx]))
            _add_counts(agg.stats, _status_counts(status[dev & ~junction]))
            for call in host_calls:
                agg.add(call)
        if journal is not None:
            plain = dev & ~junction & ~routed
            journal.record_fast(b.batch_id, FastBatch(
                n_reads=b.n, counts=_status_counts(status[plain]),
                calls=[call_from_row(res, i, *b.read(i))
                       for i in np.flatnonzero(dev & ~plain)] + host_calls))
        if times is not None:
            times.add_reads(b.n)

    def replay(fast, expect_reads: int) -> None:
        if not isinstance(fast, FastBatch):
            raise ValueError("journal was written by the per-read path; "
                             "use run_reads")
        if fast.n_reads != expect_reads:
            raise ValueError(
                f"journal batch has {fast.n_reads} reads, input has "
                f"{expect_reads}: input changed since journal")
        agg.stats.add("reads_total", fast.n_reads - len(fast.calls))
        for st, n in fast.counts.items():
            agg.stats.add_status(int(st), n)
        for call in fast.calls:
            agg.add(call)

    def reader(buf: bytes, spans: np.ndarray, sel: np.ndarray):
        def read(i: int) -> tuple[str, str]:
            k = sel[i]
            seq = buf[spans[k, 2]:spans[k, 3]].decode("ascii")
            return (buf[spans[k, 0]:spans[k, 1]].decode("ascii"),
                    revcomp_seq(seq) if revcomp else seq)
        return read

    def process(loop: _Loop, buf: bytes, spans: np.ndarray) -> None:
        nonlocal next_batch_id
        with timed(times, "encode"):
            lens_all = (spans[:, 3] - spans[:, 2]).astype(np.int64)
            short = lens_all < a2
            long_ = lens_all > Lp
            ok_idx = np.nonzero(~short & ~long_)[0]
        if shard is None or shard[0] == 0:
            # Out-of-batch reads are counted once, by rank 0.
            _add_counts(agg.stats, {st: int(mask.sum()) for st, mask in
                                    ((ST_TOO_SHORT, short),
                                     (ST_TOO_LONG, long_)) if mask.any()})
        for lo in range(0, ok_idx.size, bs):
            batch_id = next_batch_id
            next_batch_id += 1
            if shard is not None and batch_id % shard[1] != shard[0]:
                continue
            if batch_id in done:
                replay(done[batch_id], min(bs, ok_idx.size - lo))
                continue
            sel = ok_idx[lo:lo + bs]
            with timed(times, "encode"):
                arr = np.full((bs, Lp), RPAD_CODE, np.uint8)
                lens = np.zeros(bs, np.int32)
                native.encode_reads(buf, spans[sel, 2], spans[sel, 3],
                                    arr[:sel.size], lens[:sel.size],
                                    _CODE_LUT)
                if revcomp:
                    with span("revcomp"):
                        arr = revcomp_batch(arr, lens)
            loop.put(_Batch(batch_id, int(sel.size), arr, lens,
                            reader(buf, spans, sel)))

    with _Loop(dindex, cfg, prefilter, times, slowpath, explore, dispatch,
               redo, journal, aggregate) as loop:
        # The chunk iterator (file read + gzip + native FASTQ scan) is
        # timed as its own stage so I/O cost can't hide in the wall
        # residual.
        it = _iter_records(path)
        while True:
            with timed(times, "read_parse"):
                item = next(it, None)
            if item is None:
                break
            process(loop, *item)
        loop.drain()


def run_reads(dindex: DeviceIndex | None, reads, cfg: Config = Config(),
              prefilter: bool = True, batch_size: int | None = None,
              journal=None, times=None, slowpath=None, dispatch=None,
              explore: bool | None = None, redo=None) -> list[ReadCall]:
    """Batch (name, seq) reads through the streaming loop and return
    their ReadCalls in input order, equal to the oracle's read for read.
    Reads too short or too long for a batch take their status in place.
    `slowpath`, `explore`, `dispatch` and `redo` as in `_Loop`. With a
    `journal` (utils.journal.RunJournal) each finished batch records its
    calls, and completed batches replay from disk; `times`
    (utils.profiling.StageTimes) collects per-stage wall time."""
    bs = batch_size or cfg.batch_size
    Lp = cfg.max_read_len
    out: list[ReadCall | None] = []
    done = journal.completed_batches() if journal is not None else {}
    items: list[tuple[str, str]] = []
    slots: list[int] = []         # the output positions of `items`
    batch_id = 0

    def collect(b: _Batch, res: dict, routed, host_rows,
                host_calls: list) -> None:
        host = dict(zip(host_rows.tolist(), host_calls))
        calls = [host[i] if i in host else call_from_row(res, i, *b.read(i))
                 for i in range(b.n)]
        for slot, call in zip(b.slots, calls):
            out[slot] = call
        if journal is not None:
            journal.record(b.batch_id, calls)
        if times is not None:
            times.add_reads(b.n)

    def flush(loop: _Loop) -> None:
        nonlocal batch_id
        if not items:
            return
        this_id = batch_id
        batch_id += 1
        batch, at = list(items), list(slots)
        items.clear()
        slots.clear()
        if this_id in done:
            replay = done[this_id]
            if len(replay) != len(batch):
                raise ValueError(
                    f"journal batch {this_id} has {len(replay)} calls, "
                    f"input has {len(batch)}: input changed since journal")
            for slot, call in zip(at, replay):
                out[slot] = call
            return
        with timed(times, "encode"):
            arr, lens = encode_batch([seq for _, seq in batch], bs, Lp)
        loop.put(_Batch(this_id, len(batch), arr, lens, batch.__getitem__,
                        at))

    with _Loop(dindex, cfg, prefilter, times, slowpath, explore, dispatch,
               redo, journal, collect) as loop:
        for name, seq in reads:
            if len(seq) < 2 * cfg.anchor_len:
                out.append(ReadCall(name, seq, ST_TOO_SHORT))
            elif len(seq) > Lp:
                out.append(ReadCall(name, seq, ST_TOO_LONG))
            else:
                slots.append(len(out))
                out.append(None)
                items.append((name, seq))
                if len(items) == bs:
                    flush(loop)
        flush(loop)
        loop.drain()
    return out
