"""Production streaming path (reference: find_circ2_tpu/models/stream.py):
FASTQ file -> device batches with the native C loader, no per-read
Python objects except for junction-supporting and host-rescued reads.

`run_fastq` gives results identical to pipeline.run_reads (the tests
compare BED bytes). Each batch's packed rows come back through a
non-blocking copy into pinned memory with a CUDA event, waited on only
when the batch is consumed `pipeline_depth` batches later. Routed §2b
reads go to the device explore program (pipeline.DeviceExplorer) from
the batch's encoded rows, and their results are aggregated as arrays
`pipeline_depth` batches later again.
"""

from __future__ import annotations

import gzip
import os
import time

import numpy as np

from find_circ2_tpu_torch import native
from find_circ2_tpu_torch.config import (RPAD_CODE, Config, ST_JUNCTION,
                                         ST_PREFILTERED, ST_TOO_LONG,
                                         ST_TOO_SHORT, ST_UNALIGNED_A,
                                         ST_UNALIGNED_B)
from find_circ2_tpu_torch.io.twobit import (_CODE_LUT, codes_to_seq,
                                           revcomp_seq)
from find_circ2_tpu_torch.models.aggregate import Aggregator, seq_hash_batch
from find_circ2_tpu_torch.models.multihit import call_reads_multi_batch
from find_circ2_tpu_torch.models.oracle import ReadCall
from find_circ2_tpu_torch.models.pipeline import (
    DeviceExplorer, DeviceIndex, HostCopy, dispatch_packed, redo_if_overflow,
    revcomp_batch, unpack_results)
from find_circ2_tpu_torch.utils.journal import FastBatch
from find_circ2_tpu_torch.utils.profiling import count, timed

CHUNK = 16 << 20  # bytes per read(2) chunk


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


def run_fastq(dindex: DeviceIndex | None, path, agg: Aggregator,
              cfg: Config = Config(), prefilter: bool = True,
              batch_size: int | None = None, times=None,
              pipeline_depth: int = 4, slowpath=None,
              journal=None, revcomp: bool = False,
              explore: bool | None = None, dispatch=None,
              shard: tuple[int, int] | None = None, redo=None) -> None:
    """Stream a FASTQ(.gz) file through the device pipeline into `agg`.

    Dispatch runs `pipeline_depth` batches ahead of the readback.
    Aggregation is order-insensitive, so consumption order does not
    affect output. `slowpath` = (genome, index) enables §2b multi-hit
    pairing and the §2 2-mm rescue; the rescue runs on the host
    (models/multihit), in a forked worker when one can start. `explore`
    picks where §2b runs, as in pipeline.run_reads: None uses the device
    program when the index has §2b extras, True forces it (ValueError
    without extras), False sends routed reads to the host twin. Without a
    journal the device program takes the batch's encoded rows and its
    results are aggregated as arrays; with one it re-calls per read, so
    the replay records stay complete. `journal` (utils.journal
    .RunJournal): completed batches replay from compact FastBatch
    records on rerun. `revcomp=True` reverse-complements every read
    after encoding (the --pe mate-2 transform, SPEC.md §7).

    `dispatch` and `redo` replace the single-device step and its
    overflow redo, as in pipeline.run_reads: the sharded engine's
    (`dindex` None; routed reads then go to the host twin).
    `shard=(proc_id, nproc)` is the multi-process mode (`find_circ
    --nproc`): every process scans the file but encodes and detects only
    the batches with batch_id % nproc == proc_id, and rank 0 alone counts
    the reads that are out of batch (too short, too long). Each process's
    stats cover its own batches; the caller sums them over the processes.
    The ranks together process each read once, and the junction merge is
    order-free, so the merged output equals a one-process run."""
    from collections import deque

    if not native.available():
        raise RuntimeError("native loader unavailable; use run_reads")
    bs = batch_size or cfg.batch_size
    Lp = cfg.max_read_len
    a2 = 2 * cfg.anchor_len
    inflight: deque = deque()   # (batch_id, buf, spans, sel, copy, arr, lens)
    done = journal.completed_batches() if journal is not None else {}
    next_batch_id = 0
    if explore is None:
        explore = (slowpath is not None and dindex is not None
                   and dindex.ext is not None)
    with timed(times, "stream_start"):
        explorer = (DeviceExplorer(dindex, cfg, prefilter) if explore
                    else None)
        rpool = None
        if (slowpath is not None and cfg.rescue_anchor_mm >= 2
                and journal is None):
            rpool = _RescuePool(slowpath[0], slowpath[1], cfg, prefilter)
            if rpool.pool is None:
                rpool = None
    # Batches whose host re-calls or explore programs are still running:
    # (batch_id, n_reads, counts, batch_calls, rescue_handle,
    #  multihit_handle, explore_handle, routed_hashes)
    finishing: deque = deque()

    def fetched(handle) -> list[ReadCall]:
        """A host re-call handle's calls; the microseconds the worker
        (or the inline fallback) spent on them go to the counter
        `worker_us` of the stage around."""
        calls, us = rpool.fetch(handle)
        count("worker_us", us)
        return calls

    def finalize() -> None:
        batch_id, n_reads, counts, batch_calls, rhandle, mhandle, \
            xhandle, rhashes = finishing.popleft()
        if rhandle is not None:
            with timed(times, "slowpath_rescue"):
                batch_calls = batch_calls + fetched(rhandle)
        if mhandle is not None:
            with timed(times, "slowpath_multihit"):
                batch_calls = batch_calls + fetched(mhandle)
        if xhandle is not None and rhashes is not None:
            # Array-mode explore: the rows aggregate through add_batch
            # with the hashes of the batch's encoded rows; the other
            # statuses are counted in bulk.
            with timed(times, "explore_multihit"):
                resx = explorer.fetch_arrays(xhandle)
            with timed(times, "aggregate"):
                st_x = resx["status"]
                jm = st_x == ST_JUNCTION
                agg.add_batch(resx, np.flatnonzero(jm), rhashes[jm])
                rest = st_x[~jm]
                if rest.size:
                    agg.stats.add("reads_total", int(rest.size))
                for st in np.unique(rest):
                    agg.stats.add_status(int(st), int((rest == st).sum()))
        elif xhandle is not None:
            with timed(times, "explore_multihit"):
                batch_calls = batch_calls + explorer.fetch(xhandle)
        with timed(times, "aggregate"):
            for call in batch_calls:
                agg.add(call)
        if journal is not None:
            journal.record_fast(batch_id, FastBatch(
                n_reads=n_reads, counts=counts, calls=batch_calls))
        if times is not None:
            times.add_reads(n_reads)

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

    def host_recall(items, stage: str):
        """Batched host re-call of (name, seq) items: a handle for
        finalize when the worker runs, else the calls now."""
        if rpool is not None:
            with timed(times, "rescue_dispatch"):
                return rpool.submit(items), []
        with timed(times, stage):
            calls, us = _recall(*slowpath, cfg, prefilter, items)
            count("worker_us", us)
            return None, calls

    def consume() -> None:
        batch_id, buf, spans, sel, copy, arr, blens = inflight.popleft()
        with timed(times, "device_detect"):
            res = redo_if_overflow(dindex, unpack_results(copy.numpy()),
                                   arr, blens, cfg, prefilter, redo)
        # The slow-path stages keep their own timers; "aggregate" must
        # not enclose them or the report double-counts.
        with timed(times, "aggregate"):
            status = res["status"][:sel.size]
            multi = res["multi"][:sel.size]
            # §2 2-mm anchor rescue [FROZEN v4] takes precedence over
            # §2b routing; gated on the rescuable bit (exactly one
            # anchor unaligned — the host mate gate).
            if slowpath is not None and cfg.rescue_anchor_mm >= 2:
                rescue = (np.isin(status, (ST_UNALIGNED_A, ST_UNALIGNED_B))
                          & ((multi & 2) != 0))
            else:
                rescue = np.zeros(sel.size, bool)
            if slowpath is not None or explorer is not None:
                route = ((multi & 1) != 0) & (status != ST_PREFILTERED) \
                    & ~rescue
            else:
                route = np.zeros(sel.size, bool)
            plain_skip = (status != ST_JUNCTION) & ~route & ~rescue
            counts: dict[int, int] = {}
            if plain_skip.any():
                agg.stats.add("reads_total", int(plain_skip.sum()))
            for st in np.unique(status[plain_skip]):
                n = int((status[plain_skip] == st).sum())
                counts[int(st)] = n
                agg.stats.add_status(int(st), n)

            def read_seq(i: int) -> str:
                k = sel[i]
                seq = buf[spans[k, 2]:spans[k, 3]].decode("ascii")
                if revcomp:
                    seq = revcomp_seq(seq)
                return seq

            def read_name(i: int) -> str:
                k = sel[i]
                return buf[spans[k, 0]:spans[k, 1]].decode("ascii")

            batch_calls: list[ReadCall] = []
            ridx_route = np.nonzero(route)[0]
            jidx = np.nonzero((status == ST_JUNCTION) & ~route)[0]
            array_explore = (explorer is not None and journal is None
                             and ridx_route.size > 0)
            rhashes = None
            if journal is None:
                # Vectorized junction aggregation: one update per
                # distinct junction; journal runs keep per-read calls
                # so replay records stay complete. Routed rows are
                # hashed here too, for array-mode explore.
                need = (np.concatenate([jidx, ridx_route]) if array_explore
                        else jidx)
                hh = (seq_hash_batch(arr[need]) if need.size
                      else np.empty(0, np.uint64))
                agg.add_batch(res, jidx, hh[:jidx.size])
                if array_explore:
                    rhashes = hh[jidx.size:]
                jidx = jidx[:0]
            for i in jidx:
                batch_calls.append(ReadCall(
                    name=read_name(i), seq=read_seq(i),
                    status=ST_JUNCTION,
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
                ))
        # The 2-mm rescue runs on the host (models/multihit), one batched
        # call per batch; it is submitted first, so the worker starts on
        # it while the device explores.
        mhandle = rhandle = xhandle = None
        ridx = np.nonzero(rescue)[0]
        if ridx.size:
            rhandle, calls = host_recall(
                [(read_name(i), read_seq(i)) for i in ridx],
                "slowpath_rescue")
            batch_calls.extend(calls)
        if array_explore:
            with timed(times, "explore_dispatch"):
                count("reads", int(ridx_route.size))
                xhandle = explorer.dispatch_arrays(arr[ridx_route],
                                                   blens[ridx_route])
        elif explorer is not None and ridx_route.size:
            with timed(times, "explore_dispatch"):
                count("reads", int(ridx_route.size))
                xhandle = explorer.dispatch(
                    [(read_name(i), read_seq(i)) for i in ridx_route])
        elif ridx_route.size:
            # explore=False: §2b on the host twin.
            mhandle, calls = host_recall(
                [(read_name(i), read_seq(i)) for i in ridx_route],
                "slowpath_multihit")
            batch_calls.extend(calls)
        finishing.append((batch_id, int(sel.size), counts, batch_calls,
                          rhandle, mhandle, xhandle, rhashes))
        # Keep host re-calls and explore programs in flight so they
        # overlap later batches — the same depth as the detect pipeline.
        while len(finishing) > pipeline_depth:
            finalize()

    def process(buf: bytes, spans: np.ndarray) -> None:
        nonlocal next_batch_id
        with timed(times, "encode"):
            lens_all = (spans[:, 3] - spans[:, 2]).astype(np.int64)
            short = lens_all < a2
            long_ = lens_all > Lp
            ok_idx = np.nonzero(~short & ~long_)[0]
        if shard is None or shard[0] == 0:
            # Out-of-batch reads are counted once, by rank 0.
            for st, mask in ((ST_TOO_SHORT, short), (ST_TOO_LONG, long_)):
                cnt = int(mask.sum())
                if cnt:
                    agg.stats.add("reads_total", cnt)
                    agg.stats.add_status(st, cnt)
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
                    arr = revcomp_batch(arr, lens)
            with timed(times, "device_dispatch"):
                copy = HostCopy(
                    dispatch(arr, lens) if dispatch is not None
                    else dispatch_packed(dindex, arr, lens, cfg, prefilter))
            inflight.append((batch_id, buf, spans, sel, copy, arr, lens))
            if len(inflight) > pipeline_depth:
                consume()

    # The chunk iterator (file read + gzip + native FASTQ scan) is timed
    # as its own stage so I/O cost can't hide in the wall residual.
    try:
        it = _iter_records(path)
        while True:
            with timed(times, "read_parse"):
                item = next(it, None)
            if item is None:
                break
            process(*item)
        while inflight:
            consume()
        while finishing:
            finalize()
    finally:
        with timed(times, "stream_stop"):
            if rpool is not None:
                rpool.close()
