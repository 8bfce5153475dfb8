#!/usr/bin/env python3
"""On-card check of the PyTorch port (find_circ2_tpu_torch) on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (name and power limit from nvidia-smi), torch and CUDA;
  2. build the CUDA kernels from find_circ2_tpu_torch/csrc/;
  3. every kernel against its plain PyTorch version on the card, exactly:
     the row gather at every vector path and at the shapes it had on the
     main path (detect's 32-byte rows, §2b explore's 8- and 120-byte
     rows, on tables larger than the L2), timed as called (CUDA events)
     and on the device alone (CUDA-graph replay) beside its bytes bound;
     detect's core (`detect_core_packed`) and exact-first probe
     (`exact_anchor_stats`), K1's enumeration (`classic_anchor_stats`:
     hits, statistics, §2b extras) and fallback slice (`fallback_slice`,
     `refill_slice`, one slice that overflows and two that cannot) on a
     `detect_cases` batch and its pinned anchors, and detect's two
     kernels on each of `detect_cases.EDGE_CASES` (reads up to 301 bases
     in rows off 4 bytes, 40 chromosomes, anchors of 18 and 16 bases);
     the sharded K1's kernels (the partials modes of the probe and the
     enumeration, `exact_records` and `classic_records`, each shard
     looking up only the keys it owns; their combining modes,
     `exact_combine` and `classic_combine`, one shard folding the
     others' records into its own and finishing, also with synthetic
     others whose exact counts sum past max_bucket and past 1023) and the
     sharded forms
     over 1, 2, 4 and 8 index shards of that batch's genome and of keys
     at every cut between the shards' key ranges, the records also of
     every key and of each shard's keys on the whole table; K-h's
     kernels
     (`merge_junctions`, `merge_tables`) on every `merge_cases` case at
     MERGE_SIZES rows, one tile, its edges and many tiles;
  4. the port's `find_circ` CLI on test_data/ must reproduce the golden
     BED and stats byte for byte;
  5. the main path at real size: `run --filter` on the 16 Mbp RNase-R
     filter-stack library (~95k reads), with the kernels' launch counts
     (the explore kernel once per explore chunk, detect's core once per
     detect program, its probe and the fallback slice's compaction once
     per exact-first one, K1's enumeration once per exact-first or
     classic program and per explore chunk, the row gather never: K1's
     kernels fetch their own rows), precision and recall against the
     planted circles, and a stage table that shows §2b explore on the
     device and no host multi-hit stage;
  6. §2b explore on the card, on the index the CLI built in phase 5: the
     explore kernel (`explore_pairs`) equals its plain version on the
     card row for row on every read phase 5 routed to the explorer and on
     an `explore_cases` batch of edge cases, prefilter on and off, and is
     timed beside it and its bound on the first 1024 routed reads, and
     alone on the first 32 and 256 (the other chunk buckets), with its
     registers, shared bytes and resident blocks and, from its stamped
     build, each stage's SM clock cycles a block; `explore_batch_packed`
     on the first 1024 routed reads equals the port on the CPU;
     torch.profiler counts one chunk's device activities and host enqueue
     with the kernels (K1's and the pairs') and with the plain versions;
     `run_fastq` with device
     explore and with the host twin (`explore=False`) give equal BEDs,
     timed in the same run, and a profiled device-explore stream gives the
     device's busy share;
     500 reads through `run_reads`, routed ones among them, equal the CPU
     oracle read for read;
     detect's kernels (check_detect) equal their plain versions on every
     batch of phase 5's stream (the probe, the core, the fallback slice
     and the redo's enumeration) and on a batch forced through the
     classic redo, and are timed beside them and their bounds (the
     probe also beside its random-row floor, the rate gather_rows
     measured in phase 3), with each one's SM cycles by stage from its
     measurement build (detect_stages); K1's two
     kernels (time_classic) at the fallback slice, the compaction (beside
     its library call, one stable torch.argsort), the 8192-anchor redo
     and the explore chunk, with each one's SM cycles by stage from its
     measurement build (classic_stages); one batch's device
     activities and host enqueue are split by the profiler labels with
     the kernels and with the plain versions; `run_fastq` runs with the
     kernels and with the plain versions in turn (equal BED,
     `device_dispatch` and reads/s); explore's K1 equals its plain
     version on every chunk of routed reads;
  7. the sharded engine on the card: a 2x2 mesh (two data rows, four
     index shards, all four slots on cuda:0) over phase 5's index streams
     phase 5's FASTQ through `run_fastq` and must give phase 6's BED and
     stats byte for byte, the filter stack's precision and recall, §2b on
     the host twin, and exactly the launches its batches imply (per data
     row and batch the probe's records on shard 1 and shard 0's
     combining probe, the compaction, the slice's records on shard 1 and
     shard 0's combining slice, and the core; the row gather, explore
     and K1's single-table kernels never); the stream
     again with the plain versions and with the kernels (equal BED, wall
     and device_dispatch); on every batch the engine's packed rows and
     `detect_merged` (all rows) with the kernels equal the plain
     versions, `detect_merged` equals the single device's detect and
     merge, and the merge makes one C call a data row and one for their
     tables, each launching the kernels its rows imply; the first batch
     forced through the redo; one batch's device activities by label,
     kernels against plain; each new kernel timed at the engine's shapes
     (as called, device alone, the plain version's busy time, bound),
     each phase of a data row (probe, slice, redo) device alone as the
     engine runs it (records and a combining launch), and the combining
     kernels alone with their stage clocks; the record kernels
     on each index shard and summed over a data row,
     beside their bounds at the rows each shard owns and at every key's
     and the random-row floor at the rate gather_rows reaches on the
     shard's table, with their stage clocks looking up every key and the
     shard's own, and again on 4 shards carved from the same index,
     K-h at B / 2, B and 4 B rows with the SM cycles of its stages at B
     / 2 and one stable torch.argsort of B / 2 and 4 B int64 beside it;
     `find_circ --mesh 2x2` and `--nproc 2` (two processes over gloo on
     the one card) reproduce the golden bytes.

A torch.profiler profile that holds no device activity is taken again,
up to PROFILE_TRIES times; after that its figures come from CUDA events
and its log line says so.

Prints the kernel table as one JSON line, the card line, and as its last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "test_data")

# Phase 5: BASELINE configs[2], the filter-stack library of bench.py.
LIBRARY = dict(seed=7, chrom_lengths={"chrR": 16_000_000}, n_circ=6000,
               n_linear=800, depth_mean=12.0)
ORACLE_READS = 500
# Phase 6: routed reads held against the CPU port (one explore chunk),
# the rows of the explore_cases batch and its seed.
EXPLORE_READS = 1024
EXPLORE_CASE_SEED = 5
# Precision and recall of the reference package's `--filter` calls on
# this library, to 4 places (BENCH_r05.json pipeline_precision and
# pipeline_recall). They are outputs of the frozen algorithm, which the
# port reproduces bit for bit, so any difference is a fault.
EXPECT_PRECISION, EXPECT_RECALL = 0.9998, 0.9152
# Phase 3: the H100 SXM's HBM rate (NVIDIA's data sheet), its L2 size,
# and the replays of each timed CUDA graph.
HBM_BYTES_PER_S = 3.35e12
# The SMs' 32-bit rate outside the tensor cores (the data sheet's 67
# TFLOP/s float32; int32 runs at no more), and the int32 operations of one
# split in csrc/explore.cu's pair loop.
INT32_OPS_PER_S = 67e12
EXPLORE_OPS_PER_SPLIT = 12
# csrc/explore.cu's kRankMax: the survivors of one strand's list (K from
# each of its two warps) ranked pairwise; the lists longer than that are
# the merge's longest.
EXPLORE_RANK_MAX = 32
# The smaller chunk sizes of DeviceExplorer.BUCKETS, timed beside 1024.
EXPLORE_BUCKETS = (32, 256)
# The int32 operations of one valid split in csrc/detect.cu, and of one
# anchor in csrc/exact_stats.cu (its key's digits, two hashes, four slot
# compares and the finish), counted from the sources.
DETECT_OPS_PER_SPLIT = 12
EXACT_OPS_PER_ANCHOR = 220
# The int32 operations of one canonical variant in csrc/classic_k1.cu (its
# key, the swap, two hashes and bucket remainders, four slot compares and
# the folds), and of one anchor of the compaction, counted from the
# source.
CLASSIC_OPS_PER_VARIANT = 150
COMPACT_OPS_PER_ANCHOR = 30
# The int32 operations of the combining modes' fold, a record of one
# shard, and of their finish, an anchor; and of csrc/merge.cu, one key
# comparison (a 16-byte shared load, two 128-bit compares, the select and
# the count; a comparison sort needs N log2 N of them) and one row's
# load, key, record, scatter and combine (its head, scan, five shuffle
# levels of eight fields and atomics), counted from the source.
FINISH_OPS_PER_RECORD = 12
FINISH_OPS_PER_ANCHOR = 60
MERGE_OPS_PER_COMPARE = 10
MERGE_OPS_PER_ROW = 240
# K-h's row counts held against the plain merge in phase 3: one row, a
# ragged few, one tile of csrc/merge.cu (ops/merge.TILE_ROWS, 128) and its
# neighbours, a 2x2 engine's data row (B / 2) and two rows' tables (B),
# many tiles (6,000 and 20,000, not powers of two), and the sizes PR 11's
# one-block limit split (8,192, 8,193).
MERGE_SIZES = (1, 97, 127, 128, 129, 2048, 4096, 6000, 8192, 8193, 20000)
# The detect_cases batch (seed, rows) and each edge case's rows
# (detect_cases.EDGE_CASES), the fallback slice of the forced
# classic redo, and the anchor sets drawn from the genome for the probe's
# device-alone time (their rows exceed the L2 four times).
DETECT_CASE_SEED, DETECT_CASE_ROWS = 4, 1024
EDGE_CASE_ROWS = 256
# Detect's kernels are also timed on this many reads (the probe on twice
# as many anchors): one warp or less a scheduler, so the time is the
# launch and one warp's chain.
LATENCY_READS = 32
REDO_SLOTS = 16
EXACT_TIMING_SETS = 200
# The profiler labels of a detect batch (models/pipeline,
# ops/anchor_align), in program order, and of an explore chunk
# (ops/explore).
DETECT_LABELS = ("read_anchors", "k1_exact", "k1_fallback", "k1_classic",
                 "detect_core")
EXPLORE_LABELS = ("explore_k1", "explore_pairs")
L2_BYTES = 50 << 20
GRAPH_REPLAYS = 5
# torch.profiler's device tracing (CUPTI) now and then hands back a profile
# with no device activity in it: each profile is taken up to this many
# times before its figures fall back to CUDA events.
PROFILE_TRIES = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of fn over `iters` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, idxs) -> float:
    """Device milliseconds per call with the host out of the way: one
    call of fn per index set, all captured in one CUDA graph (outputs kept
    alive, so each call writes its own memory) and the graph replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(idxs[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    keep = []
    with torch.cuda.graph(graph):
        for idx in idxs:
            keep.append(fn(idx))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (GRAPH_REPLAYS * len(idxs))
    del graph, keep
    torch.cuda.empty_cache()
    return ms


def called_ms(fn, idxs) -> float:
    """Milliseconds per call as a caller sees them: CUDA events around
    back-to-back calls from Python over the index sets, host cost
    included; the least of three runs, since the host clock is noisy."""
    return min(cuda_ms(lambda: [fn(i) for i in idxs], 2)
               for _ in range(3)) / len(idxs)


def check_vector_paths(device) -> None:
    """Every vector path of the kernel, exactly against index_select:
    16-, 8- and 4-byte rows with the vectors per row fixed and at run
    time, views whose base is not aligned for the wider vector, int32 and
    int64 indices, n = 1 and ragged n."""
    import torch
    from find_circ2_tpu_torch.ops import gather_rows as gr
    g = torch.Generator(device=device).manual_seed(1)
    for width in (1, 2, 3, 6, 8, 12, 30):
        for offset in (0, 1, 2):
            flat = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                 ((1 << 16) * width + offset,),
                                 dtype=torch.int32, device=device,
                                 generator=g)
            tab = flat[offset:].view(1 << 16, width)
            for n, dtype in ((1, torch.int32), (4097, torch.int64),
                             ((1 << 20) + 37, torch.int32)):
                idx = torch.randint(0, 1 << 16, (n,), device=device,
                                    generator=g).to(dtype)
                got = gr.gather_rows(tab, idx)
                torch.cuda.synchronize()
                if not torch.equal(got, gr.gather_rows_ref(tab, idx)):
                    fail(f"gather_rows differs from index_select at "
                         f"W={width}, base +{4 * offset} bytes, n={n}, "
                         f"{dtype}")
    log("gather_rows equals index_select at W = 1, 2, 3, 6, 8, 12, 30, "
        "aligned and misaligned views, int32 and int64 idx, n = 1, 4097 "
        "and 2^20 + 37")


def check_gather_rows(device, card: str) -> dict:
    """gather_rows and gather_rows_multi against their plain versions,
    exactly, at every call shape they had on the main path, on tables
    larger than the 50 MB L2: [2^24, 8] (two of them: table and neighbour
    table), [2^24, 2] (ext_id) and [2^21, 30] (ext). K1's kernels fetch
    their own rows, on one table and on the sharded engine's shards, so
    the row gather runs only under K1's plain versions, which gather, per
    detect batch and shard, both tables' rows at 2 probes x 2B anchors
    (multi, W = 8 and 8: the exact statistics) and the table's rows at 2
    probes x min(slots, 2B) anchors x V variants (one table, gather_rows:
    the fallback slice). Also
    timed, outside the sums: the old explore chunk's calls (table and
    ext_id rows at 2 x 1024 x V, multi, W = 8 and 2; ext rows at 1024 x
    V), the single-table W = 8 and W = 2 calls at the old design's
    shapes, and W = 8 at 2^20 rows (where the launch floor no longer
    counts). Each shape is timed as called and on the device alone
    (graph_ms), the kernel and its plain version in turn, over enough
    distinct index sets that their rows exceed the L2 four times; the
    bound is its bytes (each index read once, each row read once and
    written once) over HBM_BYTES_PER_S."""
    import torch
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.ops import gather_rows as gr
    check_vector_paths(device)
    cfg = Config()
    B, V = cfg.batch_size, 1 + 3 * cfg.anchor_len
    exact_n = 2 * 2 * B
    fallback_n = 2 * min(cfg.exact_fallback_slots, 2 * B) * V
    side_n = 2 * EXPLORE_READS * V
    ext_n = EXPLORE_READS * V
    g = torch.Generator(device=device).manual_seed(0)

    def table(rows, width):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, width),
                             dtype=torch.int32, device=device, generator=g)

    tables = {"table": table(1 << 24, 8), "ntable": table(1 << 24, 8),
              "ext_id": table(1 << 24, 2), "ext": table(1 << 21, 30)}
    # (wrapper, tables, n, calls per sharded detect batch on one shard)
    shapes = [("gather_rows_multi", ("table", "ntable"), exact_n, 1),
              ("gather_rows", ("table",), fallback_n, 1),
              ("gather_rows_multi", ("table", "ext_id"), side_n, 0),
              ("gather_rows", ("ext",), ext_n, 0),
              ("gather_rows", ("table",), exact_n, 0),
              ("gather_rows", ("ext_id",), side_n, 0),
              ("gather_rows", ("table",), 1 << 20, 0)]
    out = {"max_abs_err": 0, "shapes": []}
    for name, names, n, calls in shapes:
        tabs = [tables[t] for t in names]
        rows = tabs[0].shape[0] if len(tabs) == 1 else min(
            t.shape[0] for t in tabs)
        sectors = sum(32 * -(-t.shape[1] * 4 // 32) for t in tabs)
        n_sets = max(50, -(-4 * L2_BYTES // (n * sectors)))
        idxs = [torch.randint(0, rows, (n,), device=device, generator=g)
                for _ in range(n_sets)]
        if name == "gather_rows":
            kernel = lambda i, t=tabs[0]: gr.gather_rows(t, i)
            plain = lambda i, t=tabs[0]: gr.gather_rows_ref(t, i)
        else:
            kernel = lambda i: gr.gather_rows_multi(tabs, i)
            plain = lambda i: gr.gather_rows_multi_ref(tabs, i)
        got, want = kernel(idxs[0]), plain(idxs[0])
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            if err or not torch.equal(a, b):
                fail(f"{name} differs from index_select at {names} n={n}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
        # Plain, kernel, kernel, plain: both see the same card state.
        p1, k1 = called_ms(plain, idxs), called_ms(kernel, idxs)
        k2, p2 = called_ms(kernel, idxs), called_ms(plain, idxs)
        gp1, gk1 = graph_ms(plain, idxs), graph_ms(kernel, idxs)
        gk2, gp2 = graph_ms(kernel, idxs), graph_ms(plain, idxs)
        nbytes = n * (idxs[0].element_size()
                      + sum(2 * 4 * t.shape[1] for t in tabs))
        rec = dict(name=name, tables=list(names),
                   widths=[t.shape[1] for t in tabs], n=n, calls=calls,
                   index_sets=n_sets, bytes=nbytes,
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                   called_ms=min(k1, k2), plain_called_ms=min(p1, p2),
                   device_ms=min(gk1, gk2), plain_device_ms=min(gp1, gp2))
        rec["share"] = rec["bound_ms"] / rec["device_ms"]
        out["shapes"].append(rec)
        log(f"{name} {'+'.join(names)} W={rec['widths']} n={n}: as called "
            f"{rec['called_ms']:.5f} ms vs plain {rec['plain_called_ms']:.5f}"
            f" ms; device alone {rec['device_ms']:.5f} ms vs plain "
            f"{rec['plain_device_ms']:.5f} ms; bound {rec['bound_ms']:.5f} "
            f"ms ({nbytes:,} bytes), {100 * rec['share']:.1f}% of it "
            f"({n_sets} index sets; exact match) on {card}")
    del tables
    torch.cuda.empty_cache()
    for name in ("gather_rows", "gather_rows_multi"):
        mine = [r for r in out["shapes"] if r["name"] == name]
        out[name] = {k: sum(r["calls"] * r[k] for r in mine)
                     for k in ("called_ms", "plain_called_ms", "device_ms",
                               "plain_device_ms", "bound_ms")}
        s = out[name]
        log(f"{name}, one sharded detect batch's calls on a shard: "
            f"device alone {s['device_ms']:.5f} ms vs plain "
            f"{s['plain_device_ms']:.5f} ms, bound {s['bound_ms']:.5f} ms; "
            f"as called {s['called_ms']:.5f} ms vs plain "
            f"{s['plain_called_ms']:.5f} ms on {card}")
    return out


def row_rate(gather: dict) -> float:
    """Random 32-byte rows a second, device alone, as check_gather_rows
    moved them at its largest single-table shape (W = 8, 2^20 rows of a
    2^24-row table, beyond the L2)."""
    rec = next(r for r in gather["shapes"] if r["name"] == "gather_rows"
               and r["widths"] == [8] and r["n"] == 1 << 20)
    return rec["n"] / (rec["device_ms"] / 1e3)


def check_detect_cases(device, card: str) -> dict:
    """Detect's two kernels against their plain versions on a
    detect_cases batch, before the main path: the core with the
    prefilter on and off and each overflow flag, the probe with
    positions past 2^31 too. Returns the largest differences (0)."""
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.utils import detect_cases
    cfg = Config()
    case = detect_cases.detect_case(DETECT_CASE_SEED, DETECT_CASE_ROWS, cfg)
    out = {}
    for prefilter in (True, False):
        for overflow in (None, False, True):
            hold_core(detect_cases.core_args(case, device, overflow), cfg,
                      prefilter, f"the detect_cases batch (overflow "
                      f"{overflow})", out)
    for shift in (0, 3_000_000_000):
        hold_exact(detect_cases.exact_args(case, device, shift), cfg,
                   f"the detect_cases anchors (positions + {shift})", out)
    for name, (what, _, _) in detect_cases.EDGE_CASES.items():
        edge, ecfg = detect_cases.edge_case(name, DETECT_CASE_SEED,
                                            EDGE_CASE_ROWS)
        for prefilter in (True, False):
            hold_core(detect_cases.core_args(edge, device, True), ecfg,
                      prefilter, f"the {name} edge case ({what})", out)
        hold_exact(detect_cases.exact_args(edge, device), ecfg,
                   f"the {name} edge case's anchors ({what})", out)
    log(f"detect_core_packed and exact_anchor_stats equal their plain "
        f"versions on {DETECT_CASE_ROWS} detect_cases rows (seed "
        f"{DETECT_CASE_SEED}; {case.anchors.shape[0]} anchors, "
        f"{case.coincident} of keys whose two buckets coincide, an N at "
        f"either end of an anchor and either side of its prefix's end), "
        f"prefilter on and off, and on {EDGE_CASE_ROWS} rows of each edge "
        f"case ({', '.join(detect_cases.EDGE_CASES)}), exactly, on {card}")
    return out


@contextlib.contextmanager
def plain_classic():
    """While the block runs, CUDA tensors take the plain versions of K1's
    enumeration and fallback slice: the wrappers' launches
    (ops/anchor_align._launch_classic, _launch_compact) are swapped for
    their plain versions, so the same program runs without those kernels
    and their counts stay. For the comparisons and the plain timings of
    this script only."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    launch, compact = ta._launch_classic, ta._launch_compact

    def classic(table, meta, anchors, cfg, ext=None, ext_id=None,
                stats=False, slots=None, hits=None, lib=None):
        if slots is not None:
            return ta.refill_slice_ref(table, meta, anchors, slots, hits,
                                       cfg), None
        return ta.classic_anchor_stats_ref(table, meta, anchors, cfg, ext,
                                           ext_id, stats)

    ta._launch_classic = classic
    ta._launch_compact = (lambda resolved, k, lib=None:
                          ta.fallback_slice_ref(resolved, k))
    try:
        yield
    finally:
        ta._launch_classic, ta._launch_compact = launch, compact


def _equal_all(got, want) -> bool:
    """Every tensor of two (nested) tuples equal, dtype and shape too."""
    import torch
    if isinstance(got, tuple) or isinstance(want, tuple):
        return (isinstance(got, tuple) and isinstance(want, tuple)
                and len(got) == len(want)
                and all(_equal_all(a, b) for a, b in zip(got, want)))
    if got is None or want is None:
        return got is None and want is None
    return got.dtype == want.dtype and torch.equal(got, want)


def _flat(x) -> list:
    """The tensors of a (nested) tuple."""
    if x is None:
        return []
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    return [x]


def hold_plain(fn, plain, what: str, out: dict, key: str,
               name: str = "a kernel") -> None:
    """fn() against fn() inside the `plain` context manager, on the same
    CUDA tensors: every element of every output (out[key] the largest
    difference)."""
    import torch
    got = fn()
    with plain():
        want = fn()
    torch.cuda.synchronize()
    out[key] = max(out.get(key, 0), _max_err(zip(_flat(got), _flat(want))))
    if not _equal_all(got, want):
        fail(f"{name} differs from its plain version on {what}")


def hold_classic(fn, what: str, out: dict) -> None:
    """fn() with the enumeration and compaction kernels against fn()
    under plain_classic, on the same CUDA tensors: every element of every
    output."""
    hold_plain(fn, plain_classic, what, out, "classic_err",
               "K1's enumeration or fallback slice")


def check_classic_cases(device, card: str) -> dict:
    """K1's enumeration kernel (classic_anchor_stats) and fallback slice
    (fallback_slice, refill_slice) against their plain versions on a
    detect_cases batch's anchors (PINNED_ANCHORS among them), exactly: the
    hits only, the statistics, the §2b extras; the slice of the exact
    probe's unresolved anchors at REDO_SLOTS (it overflows), at
    exact_fallback_slots and at every anchor (it cannot). Returns the
    largest difference (0)."""
    import torch
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.utils import detect_cases
    cfg = Config()
    case = detect_cases.detect_case(DETECT_CASE_SEED, DETECT_CASE_ROWS, cfg)
    table, meta, anchors, ext, ext_id = detect_cases.classic_args(case,
                                                                  device)
    ntable = torch.from_numpy(case.ntable).to(device)
    out = {}
    for x, stats, mode in (((), False, "hits"), ((), True, "statistics"),
                           ((ext, ext_id), True, "extras")):
        hold_classic(lambda: ta.classic_anchor_stats(
            table, meta, anchors, cfg, *x, stats=stats),
            f"the detect_cases anchors ({mode})", out)
    n = anchors.shape[0]
    flags = {}
    for k in (REDO_SLOTS, cfg.exact_fallback_slots, n):
        def fast(k=k):
            hits, resolved = ta.exact_anchor_stats(table, ntable, meta,
                                                   anchors, cfg)
            idx, over = ta.fallback_slice(resolved, k)
            return (ta.refill_slice(table, meta, anchors, idx, hits, cfg),
                    idx, over)
        hold_classic(fast, f"the detect_cases anchors' fallback slice of "
                     f"{k}", out)
        flags[k] = bool(fast()[2])
    if not flags[REDO_SLOTS] or flags[n]:
        fail(f"the fallback slice's overflow flags {flags}: want True at "
             f"{REDO_SLOTS} slots, False at {n}")
    log(f"classic_anchor_stats (hits, statistics, extras) and the fallback "
        f"slice (fallback_slice + refill_slice at {REDO_SLOTS}, "
        f"{cfg.exact_fallback_slots} and {n} slots; overflow {flags}) equal "
        f"their plain versions on the {n} detect_cases anchors (pinned: "
        f"more than K hits, a guarded slot, {case.coincident} keys whose "
        f"buckets coincide, ext row ids doubled past and inside the rows), "
        f"exactly, on {card}")
    return out


def check_shard_cases(device, card: str) -> dict:
    """The sharded K1's kernels against their plain versions, exactly,
    over 1, 2, 4 and 8 index shards of the case's genome on the card, on
    a detect_cases batch's anchors (PINNED_ANCHORS and DIRTY_AT among
    them) and on detect_cases.range_edge_case's anchors (keys at every
    cut between the shards' key ranges and one below it): each shard's
    records (exact_records; classic_records, full and in slot mode) of
    the keys it owns, of every key, and of its keys on the whole table
    (which holds every key, so a key outside the range that was looked
    up would show); the combining
    modes with the first and the last shard folding in the others'
    records (exact_combine; classic_combine, full and at slots in place),
    and shard 0's exact_combine with synthetic others whose exact counts
    sum past max_bucket and past 1023 (detect_cases.found_records); and
    the sharded
    forms (the exact-first pair at REDO_SLOTS slots, where it overflows
    on the detect_cases batch, and at exact_fallback_slots; the classic
    pair). Returns the largest difference (0)."""
    import dataclasses
    import torch
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.utils import detect_cases
    cfg = Config()
    cases = {"detect_cases": detect_cases.detect_case(
                 DETECT_CASE_SEED, DETECT_CASE_ROWS, cfg),
             "range-edge": detect_cases.range_edge_case(DETECT_CASE_SEED,
                                                        cfg)}
    out = {}
    for name, case in cases.items():
        anchors = torch.from_numpy(case.anchors).to(device)
        n = anchors.shape[0]
        half = n // 2
        slot = torch.arange(n - 1, -1, -3, device=device)
        carved = detect_cases.shard_tables(case, detect_cases.SHARD_COUNTS,
                                           cfg)
        whole = detect_cases.shard_args(*carved[1], [device], cfg)[0]
        for S, tables in carved.items():
            sh = detect_cases.shard_args(*tables, [device] * S, cfg)
            what = f"the {name} anchors over {S} index shards"
            owns = [s.owns for s in sh]

            def records(shards=sh, owns=owns):
                return tuple(torch.stack(x) for x in zip(*(
                    (ta.exact_records(*s[:3], anchors, cfg, owns=o),
                     ta.classic_records(s.table, s.meta, anchors, cfg,
                                        owns=o),
                     ta.classic_records(s.table, s.meta, anchors, cfg, slot,
                                        owns=o))
                    for s, o in zip(shards, owns))))

            for where, args in (("own keys", (sh, owns)),
                                ("every key", (sh, [None] * S)),
                                ("own keys on the whole table",
                                 ([whole] * S, owns))):
                hold_plain(lambda: records(*args), plain_shard,
                           f"{what} (records of {where})", out, "shard_err")
            exact, full, sliced = records()
            hits = ta.shard_finish_ref(exact, anchors, cfg)[0]

            def combines(shards=sh, S=S, hits=hits):
                got = []
                for k in sorted({0, S - 1}):
                    rest = [j for j in range(S) if j != k]
                    t, nt, m, o = shards[k]
                    fresh = ta.AnchorHits(*(x.clone() for x in hits))
                    got += [ta.exact_combine(t, nt, m, anchors, cfg,
                                             exact[rest], o),
                            ta.classic_combine(t, m, anchors, cfg,
                                               full[rest], owns=o),
                            ta.classic_combine(t, m, anchors, cfg,
                                               sliced[rest], slot, fresh, o)]
                t, nt, m, o = shards[0]
                for cf, cr, others in ((cfg.max_bucket, 0, 1),
                                       (1023, 1023, 3)):
                    got.append(ta.exact_combine(
                        t, nt, m, anchors, cfg, detect_cases.found_records(
                            n, cf, cr, others, device), o))
                return tuple(got)

            hold_plain(combines, plain_shard, f"{what} (combining modes)",
                       out, "shard_err")
            flags = []
            for k in (REDO_SLOTS, cfg.exact_fallback_slots):
                c = dataclasses.replace(cfg, exact_fallback_slots=k)
                hold_plain(lambda: ta.align_anchor_pair_fast_sharded(
                    sh, anchors[:half], anchors[half:2 * half], c),
                    _plain_k1, f"{what} (the exact-first pair, {k} slots)",
                    out, "shard_err")
                flags.append(bool(ta.align_anchor_pair_fast_sharded(
                    sh, anchors[:half], anchors[half:2 * half], c)[2]))
            hold_plain(lambda: ta.align_anchor_pair_sharded(
                sh, anchors[:half], anchors[half:2 * half], cfg),
                _plain_k1, f"{what} (the classic pair)", out, "shard_err")
            if name == "detect_cases" and flags != [True, False]:
                fail(f"the sharded fallback slice's overflow flags {flags} "
                     f"at {REDO_SLOTS} and {cfg.exact_fallback_slots} slots")
        log(f"the sharded K1's kernels (exact_records, classic_records full "
            f"and in slot mode, of each shard's own keys, of every key and "
            f"of each shard's keys on the whole table; exact_combine and "
            f"classic_combine full and at slots, the first and the last "
            f"shard combining, and exact_combine on synthetic others past "
            f"max_bucket and 1023) and the sharded forms (the exact-first "
            f"pair at {REDO_SLOTS} and {cfg.exact_fallback_slots} slots; the "
            f"classic pair) equal their plain versions on the {n} {name} "
            f"anchors over {', '.join(map(str, detect_cases.SHARD_COUNTS))} "
            f"index shards, exactly, on {card}")
    return out


@contextlib.contextmanager
def _plain_k1():
    """The sharded K1's kernels and K1's enumeration and compaction,
    plain (plain_shard and plain_classic)."""
    with plain_shard(), plain_classic():
        yield


def check_merge_cases(device, card: str) -> dict:
    """K-h's kernels (csrc/merge.cu) against the plain merge on every
    utils/merge_cases case at each of MERGE_SIZES rows: merge_junctions,
    and merge_tables of two and of three copies of its table, all N rows,
    fill rows included. Returns the largest difference (0)."""
    import torch
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.ops import merge as tm
    from find_circ2_tpu_torch.utils.merge_cases import CASES, merge_case
    cfg = Config()
    out = {}
    if MERGE_SIZES[2:5] != tuple(tm.TILE_ROWS + d for d in (-1, 0, 1)):
        fail(f"MERGE_SIZES {MERGE_SIZES} miss the tile's edges "
             f"({tm.TILE_ROWS} rows)")
    for n in MERGE_SIZES:
        for i, name in enumerate(CASES):
            res, lens = merge_case(name, n, i + n)
            res = {k: torch.from_numpy(v.astype("int64")
                                       if v.dtype.kind == "u" else v
                                       ).to(device) for k, v in res.items()}
            lens = torch.from_numpy(lens).to(device)

            def merges():
                one = tm.merge_junctions(res, lens, cfg)
                return tuple(one[k] for k in tm.ALL_FIELDS) + tuple(
                    tm.merge_tables({k: torch.stack([v] * K)
                                     for k, v in one.items()})[f]
                    for K in (2, 3) for f in tm.ALL_FIELDS)

            hold_plain(merges, plain_merge, f"the {name} merge case at {n} "
                       "rows", out, "merge_err")
    log(f"K-h's kernels (merge_junctions, merge_tables of 2 and 3 tables) "
        f"equals the plain merge on all rows of every merge case "
        f"({', '.join(CASES)}) at {', '.join(map(str, MERGE_SIZES))} rows, "
        f"exactly, on {card}")
    return out


def _golden_args(device: str, bed: str, stats: str) -> list[str]:
    return ["find_circ", os.path.join(DATA, "reads.fastq"),
            "-G", os.path.join(DATA, "genome.fa"), "--reads-format", "fastq",
            "--batch-size", "64", "--device", device, "-n", "golden",
            "-o", bed, "-s", stats]


def _check_golden_files(bed: str, stats: str, what: str) -> None:
    for got, want in ((bed, "splice_sites.bed"), (stats, "stats.txt")):
        with open(got, "rb") as a, open(os.path.join(DATA, want), "rb") as b:
            if a.read() != b.read():
                fail(f"{what}: output differs from test_data/{want}")
    log(f"{what}: golden BED and stats reproduced byte for byte")


def check_golden(device: str, extra: tuple = ()) -> None:
    """The port's find_circ CLI on test_data/ vs the committed goldens."""
    from find_circ2_tpu_torch.cli import main as cli
    with tempfile.TemporaryDirectory() as tmp:
        bed = os.path.join(tmp, "out.bed")
        stats = os.path.join(tmp, "out.stats")
        rc = cli.main(_golden_args(device, bed, stats) + list(extra))
        if rc != 0:
            fail(f"find_circ {' '.join(extra)} exited {rc} on test_data/")
        _check_golden_files(bed, stats, " ".join(["find_circ", *extra]))


def check_golden_nproc(device: str, nproc: int = 2) -> None:
    """find_circ --nproc on test_data/: `nproc` processes of the CLI on
    the one card, joined over gloo on localhost; process 0 writes the
    merged output, which must be the golden bytes."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        bed = os.path.join(tmp, "out.bed")
        stats = os.path.join(tmp, "out.stats")
        logs = [os.path.join(tmp, f"rank{rank}.log") for rank in range(nproc)]
        procs = []
        for rank, path in enumerate(logs):
            with open(path, "wb") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "find_circ2_tpu_torch.cli.main"]
                    + _golden_args(device, bed, stats)
                    + ["--nproc", str(nproc), "--proc-id", str(rank),
                       "--coordinator", f"localhost:{port}"],
                    cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT))
        # Once one process fails, or at the deadline, the others are
        # killed rather than left waiting in a collective.
        deadline = time.monotonic() + 300
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            outs = []
            for path in logs:
                with open(path, "rb") as fh:
                    outs.append(fh.read().decode(errors="replace")[-2000:])
            fail(f"find_circ --nproc {nproc} exited "
                 f"{[p.returncode for p in procs]}:\n" + "\n====\n".join(outs))
        _check_golden_files(bed, stats, f"find_circ --nproc {nproc} "
                            f"--device {device}")


def _stage(report: str, key: str):
    """(seconds, count) of one line of the --profile stage table, or
    None when the stage never ran."""
    for line in report.splitlines():
        parts = line.split("\t")
        if parts[0] == key:
            count = parts[2].rstrip("x") if len(parts) > 2 else "1"
            return (float(parts[1].rstrip("s").replace(",", "")),
                    int(count) if count.isdigit() else 1)
    return None


def _profile_value(report: str, key: str) -> float:
    got = _stage(report, key)
    if got is None:
        fail(f"no {key!r} line in the --profile report")
    return got[0]


@contextlib.contextmanager
def watch_explorer():
    """While the block runs, count what DeviceExplorer.dispatch_arrays
    (every §2b explore chunk of the streaming loop goes through it)
    does: its calls, chunks, routed reads, the launches of K1's
    enumeration kernel (classic_anchor_stats) made inside it, and every
    routed row (uint8 codes, int32 lengths). Also keep the DeviceIndex
    and slowpath=(genome, index) that run_fastq was given. Yields the
    dict it fills."""
    import numpy as np
    from find_circ2_tpu_torch.models import pipeline as tpipe
    from find_circ2_tpu_torch.models import stream as tstream
    from find_circ2_tpu_torch.ops import anchor_align as ta
    seen = dict(calls=0, chunks=0, reads=0, launches=0, arr=[], lens=[])
    dispatch_arrays, run_fastq = (tpipe.DeviceExplorer.dispatch_arrays,
                                  tstream.run_fastq)

    def counted(self, arr, lens):
        before = ta.classic_launches
        handle = dispatch_arrays(self, arr, lens)
        seen["launches"] += ta.classic_launches - before
        seen["calls"] += 1
        seen["chunks"] += len(handle)
        seen["arr"].append(np.array(arr))
        seen["lens"].append(np.array(lens))
        seen["reads"] += arr.shape[0]
        return handle

    def kept(dindex, *args, **kw):
        seen.update(dindex=dindex, slowpath=kw.get("slowpath"))
        return run_fastq(dindex, *args, **kw)

    tpipe.DeviceExplorer.dispatch_arrays, tstream.run_fastq = counted, kept
    try:
        yield seen
    finally:
        tpipe.DeviceExplorer.dispatch_arrays = dispatch_arrays
        tstream.run_fastq = run_fastq


def _device_events(prof) -> list:
    """A profile's device activities (kernels, copies, fills), without the
    device-side spans the profiler draws for record_function labels."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in DETECT_LABELS + EXPLORE_LABELS]


def _profile(fn):
    """Run fn under torch.profiler, again while the profile holds no
    device activity, at most PROFILE_TRIES times. The profile (None when
    every try came back empty; each empty try is said on stderr) and the
    number of tries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if _device_events(prof):
            return prof, attempt
        print(f"chip_smoke: torch.profiler recorded no device activity "
              f"(try {attempt} of {PROFILE_TRIES})", file=sys.stderr,
              flush=True)
    return None, PROFILE_TRIES


def device_profile(fn) -> dict:
    """Run fn once under torch.profiler. Its device activities (kernels,
    copies, fills): how many, the milliseconds the device was busy (the
    union of their intervals) and the first-to-last span; `source` names
    the instrument and `tries` counts the runs of fn under it. When no
    profile holds device activity (_profile), one call of fn timed by
    CUDA events gives busy and span alike, and the activities and busy
    share are None (not measured)."""
    prof, tries = _profile(fn)
    if prof is None:
        ms = cuda_ms(fn, 1)
        return dict(ops=None, busy_ms=ms, span_ms=ms, busy_share=None,
                    source="CUDA events", tries=tries)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(prof))
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    span = hi - spans[0][0]
    return dict(ops=len(spans), busy_ms=busy / 1e3, span_ms=span / 1e3,
                busy_share=busy / max(span, 1), source="torch.profiler",
                tries=tries)


def busy_ms(fn) -> tuple[float, str]:
    """device_profile(fn)'s busy milliseconds and the instrument that
    measured them."""
    prof = device_profile(fn)
    return prof["busy_ms"], prof["source"]


def explore_k1(d, reads, lens, cfg) -> tuple:
    """ops/explore.explore_k1 on a DeviceIndex: explore_pairs' arguments
    for one chunk of routed reads."""
    from find_circ2_tpu_torch.ops.explore import explore_k1 as k1
    return k1(d.words, d.nbases, d.table, d.meta, d.ext, d.ext_id,
              d.chrom_offsets, reads, lens, cfg)


def explore_bound(args, cfg) -> dict:
    """The least time the card could take for explore_pairs on `args`:
    the larger of its operations over the SMs' 32-bit rate and its bytes
    over the HBM rate. Operations: EXPLORE_OPS_PER_SPLIT for every split
    of every pair that can pair (valid, one strand and chromosome,
    linear or circular), the pairs whose split loop the kernel runs.
    Bytes, each read once: the reads and lengths, both anchors' count
    rows and hit fields, the first_pos/extras lanes at the best mismatch
    level, each valid candidate's window words, the chromosome offsets
    and the [B, 14] rows. Also the reads with a per-strand list of more
    than EXPLORE_RANK_MAX lanes, the kernel's longest merges."""
    import torch
    from find_circ2_tpu_torch.index.hashtable import M32
    from find_circ2_tpu_torch.ops import explore as tx
    (words, nbases, offsets, reads, lens, sa, sb, ha, hb, mm_v) = args
    B, Lp = reads.shape
    a, K = cfg.anchor_len, cfg.max_pair_hits
    V = mm_v.shape[0] // 2
    cands, lanes, longest = [], 0, torch.zeros_like(lens)
    for (count, first, extras), hits in ((sa, ha), (sb, hb)):
        cands.append(tx.merged_candidates(count, first, extras, mm_v,
                                          hits.mm, cfg))
        at_best = (mm_v[None, :] == hits.mm[:, None]) & (count > 0)
        per = torch.where(at_best, torch.clamp(count, max=K), 0)
        lanes += int(per.sum())
        longest = torch.maximum(longest, torch.maximum(
            per[:, :V].sum(1), per[:, V:].sum(1)).to(longest.dtype))
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
    hit_bytes = sum(getattr(ha, f).element_size() for f in (
        "pos", "strand", "aligned", "mm", "n_best", "qual"))
    nbytes = (B * Lp + 4 * B + 2 * 4 * sa[0].numel() + 4 * mm_v.numel()
              + 2 * B * hit_bytes + 8 * lanes
              + window * int(va.sum() + vb.sum()) + 8 * offsets.numel()
              + 4 * 14 * B)
    ops_ms, bytes_ms = 1e3 * ops / INT32_OPS_PER_S, 1e3 * nbytes / \
        HBM_BYTES_PER_S
    return dict(ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                long_lists=int((longest > EXPLORE_RANK_MAX).sum()))


def _quantiles(cyc, names, total: str = "total") -> dict:
    """Per stage, and for their sum (`total`), the median, 90th percentile
    and maximum over the rows of int64 [rows, len(names)] cycles."""
    import torch
    cyc = torch.cat([cyc, cyc.sum(1, keepdim=True)], 1).double().cpu()
    q = torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64)
    return {name: [float(v) for v in torch.quantile(cyc[:, k], q)]
            for k, name in enumerate((*names, total))}


def explore_stages(args, cfg, what: str, card: str) -> dict:
    """Where one block's time goes: the kernel's measurement build
    (ops/explore.stage_cycles) on `args`, its rows held against the plain
    version, and per stage the median, 90th percentile and maximum over
    the blocks of the SM clock cycles, and of their sum."""
    import torch
    from find_circ2_tpu_torch.ops import explore as tx
    rows, cyc = tx.stage_cycles(args, cfg, True)
    if not torch.equal(rows, tx.explore_pairs_ref(*args, cfg, True)):
        fail(f"the stamped explore kernel differs from its plain version "
             f"on {what}")
    out = _quantiles(cyc, tx.STAGES, "block")
    log(f"explore kernel stages on {what}, SM clock cycles a block "
        f"(median / p90 / max): " + "; ".join(
            f"{name} {m:.0f} / {p:.0f} / {x:.0f}"
            for name, (m, p, x) in out.items()) + f"; on {card}")
    return out


def time_pairs(args, cfg, card, buckets=()) -> dict:
    """explore_pairs (the kernel) and explore_pairs_ref (the plain
    version) on one chunk's K1 outputs, prefilter on, in the order plain,
    kernel, kernel, plain: as called (CUDA events) and on the device
    alone, the kernel by CUDA-graph replay, the plain version by
    torch.profiler's busy time (its window gather copies a host tensor,
    which a graph capture refuses), the kernel by that too; beside the
    bound of explore_bound. `buckets` maps the smaller chunk sizes of
    DeviceExplorer.BUCKETS to their K1 outputs: the kernel alone on
    each, as called and by graph replay, beside its bound. One block
    runs per read, so when 32 reads take nearly the time of 1024, one
    block's critical path sets the time, not the card's rates."""
    from find_circ2_tpu_torch.ops import explore as tx

    def kernel(_):
        return tx.explore_pairs(*args, cfg, True)

    def plain(_):
        return tx.explore_pairs_ref(*args, cfg, True)

    def busy(fn):
        return busy_ms(lambda: fn(0))
    p1, k1 = called_ms(plain, range(5)), called_ms(kernel, range(20))
    k2, p2 = called_ms(kernel, range(20)), called_ms(plain, range(5))
    gp1, gk1, bk1 = busy(plain), graph_ms(kernel, range(20)), busy(kernel)
    bk2, gk2, gp2 = busy(kernel), graph_ms(kernel, range(20)), busy(plain)
    (bk, k_src), (gp, p_src) = min(bk1, bk2), min(gp1, gp2)
    out = dict(called_ms=min(k1, k2), plain_called_ms=min(p1, p2),
               ms=min(gk1, gk2), profiler_ms=bk, plain_ms=gp,
               **explore_bound(args, cfg))
    log(f"explore_pairs on {args[3].shape[0]} routed reads: device alone "
        f"{out['ms']:.5f} ms (graph; {out['profiler_ms']:.5f} ms "
        f"{k_src}) vs plain {out['plain_ms']:.5f} ms "
        f"({p_src}); as called {out['called_ms']:.5f} ms vs plain "
        f"{out['plain_called_ms']:.5f} ms; bound {out['bound_ms']:.5f} ms "
        f"by {out['bound_by']} ({out['ops']:,} int32 operations, "
        f"{out['bytes']:,} bytes), {100 * out['bound_ms'] / out['ms']:.1f}% "
        f"of it; {out['long_lists']} of the reads have a per-strand "
        f"candidate list longer than {EXPLORE_RANK_MAX}; on {card}")
    out["buckets"] = {args[3].shape[0]: dict(
        ms=out["ms"], called_ms=out["called_ms"], bound_ms=out["bound_ms"])}
    for n, bargs in buckets.items():
        def bucket(_, bargs=bargs):
            return tx.explore_pairs(*bargs, cfg, True)
        rec = dict(ms=min(graph_ms(bucket, range(20)),
                          graph_ms(bucket, range(20))),
                   called_ms=min(called_ms(bucket, range(20)),
                                 called_ms(bucket, range(20))),
                   bound_ms=explore_bound(bargs, cfg)["bound_ms"])
        out["buckets"][n] = rec
        log(f"explore_pairs on the first {n} routed reads: device alone "
            f"{rec['ms']:.5f} ms (graph), as called {rec['called_ms']:.5f} "
            f"ms, bound {rec['bound_ms']:.5f} ms; {rec['ms'] / out['ms']:.3f}"
            f" of the {args[3].shape[0]}-read time; on {card}")
    out["stages"] = {n: explore_stages(bargs, cfg, f"the first {n} routed "
                                       "reads", card)
                     for n, bargs in ((args[3].shape[0], args),
                                      *buckets.items())}
    res = tx.resources(cfg, int(args[2].shape[0]), args[3].device)
    out["resources"] = res
    log(f"explore kernel: {res['registers']} registers and "
        f"{res['local_bytes']} spilled bytes a thread, {res['threads']} "
        f"threads and {res['shared_bytes']:,} shared bytes a block, "
        f"{res['blocks_per_sm']} resident blocks an SM (CUDA occupancy "
        f"API) on {card}")
    return out


def check_explore(dindex, arr, lens, cfg, card) -> dict:
    """§2b explore on the card, on the main path's index and the reads it
    routed to the explorer (phase 6):
    - the kernel (explore_pairs) against the plain version on the card
      (explore_pairs_ref), on the same K1 outputs, row for row, on every
      routed read in chunks of 1024 and on an explore_cases batch of 1024
      edge cases, prefilter on and off;
    - explore_batch_packed on the card against the port on the CPU on the
      first 1024 routed reads, prefilter on and off;
    - the kernel's times beside the plain version's and its bound
      (time_pairs), on the first chunk;
    - explore's K1 (the enumeration kernel with the extras) against its
      plain version on every chunk of routed reads;
    - one chunk of explore_batch_packed (K1 and the pairs, kernels) and
      of the plain K1 and pairs, each: ms by CUDA events, host enqueue
      ms, device activities and busy ms (torch.profiler), peak bytes
      above the index.
    Returns those numbers."""
    import dataclasses
    import numpy as np
    import torch
    from find_circ2_tpu_torch.ops import explore as tx
    from find_circ2_tpu_torch.utils.explore_cases import (explore_case,
                                                          pair_args)
    if arr.shape[0] < EXPLORE_READS:
        fail(f"the main path routed only {arr.shape[0]} reads, need "
             f"{EXPLORE_READS}")
    dev = dindex.device
    out = dict(max_abs_err=0)

    def hold(args, what):
        for prefilter in (True, False):
            got = tx.explore_pairs(*args, cfg, prefilter)
            want = tx.explore_pairs_ref(*args, cfg, prefilter)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max()) if got.numel() else 0
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if err or not torch.equal(got, want):
                bad = (got != want).any(1).nonzero()[:5, 0].tolist()
                fail(f"explore_pairs differs from its plain version on "
                     f"{what}, prefilter {prefilter} (rows {bad})")

    n = arr.shape[0]
    for lo in range(0, n, EXPLORE_READS):
        chunk = (torch.from_numpy(arr[lo:lo + EXPLORE_READS]).to(dev),
                 torch.from_numpy(lens[lo:lo + EXPLORE_READS]).to(dev))
        hold_classic(lambda: explore_k1(dindex, *chunk, cfg)[5:],
                     f"explore's K1 on routed reads {lo}..", out)
        hold(explore_k1(dindex, *chunk, cfg), f"routed reads {lo}..")
    case = explore_case(EXPLORE_CASE_SEED, EXPLORE_READS, cfg)
    hold(pair_args(case, cfg, dev), "the explore_cases batch")
    log(f"explore's K1 (classic_anchor_stats with the extras) and "
        f"explore_pairs equal their plain versions on the card on all {n} "
        f"routed reads ({-(-n // EXPLORE_READS)} chunks); explore_pairs "
        f"also on "
        f"{EXPLORE_READS} explore_cases rows (seed {EXPLORE_CASE_SEED}), "
        "prefilter on and off, exactly")

    reads = torch.from_numpy(arr[:EXPLORE_READS])
    rlens = torch.from_numpy(lens[:EXPLORE_READS])
    cpu = dataclasses.replace(dindex, **{
        f.name: getattr(dindex, f.name).cpu()
        for f in dataclasses.fields(dindex)
        if isinstance(getattr(dindex, f.name), torch.Tensor)})

    def run(d, prefilter):
        return tx.explore_batch_packed(
            d.words, d.nbases, d.table, d.meta, d.ext, d.ext_id,
            d.chrom_offsets, reads.to(d.device), rlens.to(d.device), cfg,
            prefilter)

    def run_plain(d, prefilter):
        with plain_classic():
            return tx.explore_pairs_ref(*explore_k1(
                d, reads.to(d.device), rlens.to(d.device), cfg), cfg,
                prefilter)

    for prefilter in (True, False):
        got = run(dindex, prefilter).cpu().numpy()
        t0 = time.perf_counter()
        want = run(cpu, prefilter).numpy()
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        bad = np.flatnonzero((got != want).any(axis=1))
        if bad.size:
            fail(f"explore on the card differs from the CPU port on "
                 f"{bad.size} of {EXPLORE_READS} routed reads, prefilter "
                 f"{prefilter} (rows {bad[:5].tolist()})")
        status, count = np.unique(got[:, 0], return_counts=True)
        log(f"explore_batch_packed on {EXPLORE_READS} routed reads, "
            f"prefilter {prefilter}, equals the CPU port row for row; rows "
            f"per status {dict(zip(status.tolist(), count.tolist()))}; CPU "
            f"{cpu_ms:.1f} ms")
        if prefilter:
            out["cpu_ms"] = cpu_ms

    out["pairs"] = time_pairs(
        explore_k1(dindex, reads.to(dev), rlens.to(dev), cfg), cfg, card,
        {n: explore_k1(dindex, reads[:n].to(dev), rlens[:n].to(dev), cfg)
         for n in EXPLORE_BUCKETS})
    # One chunk, K1 included: the plain versions (K1's and the pairs') and
    # the kernels, each in turn.
    for name, fn in (("plain", run_plain), ("kernel", run),
                     ("kernel", run), ("plain", run_plain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(dindex, True)
        enqueue = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        card_ms = cuda_ms(lambda: fn(dindex, True), 5)
        prof = device_profile(lambda: fn(dindex, True))
        rec = dict(card_ms=card_ms, enqueue_ms=enqueue, peak_bytes=peak)
        old = out.get(name)
        if old is not None:
            rec = {k: min(old[k], rec[k]) for k in rec}
            prof = min(old["device"], prof, key=lambda p: p["busy_ms"])
        out[name] = dict(rec, device=prof)
    for name in ("plain", "kernel"):
        r, prof = out[name], out[name]["device"]
        ops = ("device activities not measured;" if prof["ops"] is None
               else f"{prof['ops']} device activities")
        log(f"one explore chunk, K1 and pairs {name} (prefilter on): "
            f"{r['card_ms']:.3f} ms as called (CUDA events), host enqueue "
            f"{r['enqueue_ms']:.3f} ms, {ops} busy {prof['busy_ms']:.3f} ms "
            f"({prof['source']}), peak {r['peak_bytes']:,} bytes above the "
            f"index, on {card}")
    return out


@contextlib.contextmanager
def plain_detect():
    """While the block runs, CUDA tensors take the plain versions of all
    of detect's kernels: each wrapper's launch (ops/detect._launch,
    ops/anchor_align._launch_exact, K1's enumeration and fallback slice,
    plain_classic, which explore's K1 takes too, and the sharded K1's,
    plain_shard) is swapped for its plain version, so the same program
    runs without those kernels and their counts stay. For the
    comparisons and the plain timings of this script only."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.ops import detect as td
    launch, launch_exact = td._launch, ta._launch_exact
    td._launch = (lambda args, cfg, prefilter, lib=None:
                  td.detect_core_packed_ref(*args, cfg, prefilter))
    ta._launch_exact = (lambda args, cfg, lib=None:
                        ta.exact_anchor_stats_ref(*args, cfg))
    try:
        with plain_classic(), plain_shard():
            yield
    finally:
        td._launch, ta._launch_exact = launch, launch_exact


@contextlib.contextmanager
def plain_shard():
    """While the block runs, CUDA tensors take the plain versions of the
    sharded K1's kernels: the partials modes' launches
    (ops/anchor_align._launch_exact_records, _launch_classic_records),
    and the combining modes' (_launch_exact_combine,
    _launch_classic_combine) are swapped for exact_records_ref,
    classic_records_ref, exact_combine_ref and classic_combine_ref, so
    the sharded forms run
    without those kernels and their counts stay. For the comparisons and
    the plain timings of this script only."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    saved = (ta._launch_exact_records, ta._launch_classic_records,
             ta._launch_exact_combine, ta._launch_classic_combine)
    ta._launch_exact_records = (
        lambda args, cfg, out=None, lib=None, owns=None:
        ta._into(out, ta.exact_records_ref(*args, cfg, owns)))
    ta._launch_classic_records = (
        lambda table, meta, anchors, cfg, slots=None, out=None, lib=None,
        owns=None:
        ta._into(out, ta.classic_records_ref(table, meta, anchors, cfg,
                                             slots, owns)))
    ta._launch_exact_combine = (
        lambda args, cfg, others, lib=None, owns=None:
        ta.exact_combine_ref(*args, cfg, others, owns))
    ta._launch_classic_combine = (
        lambda table, meta, anchors, cfg, others, slots=None, hits=None,
        lib=None, owns=None:
        ta.classic_combine_ref(table, meta, anchors, cfg, others, slots,
                               hits, owns))
    try:
        yield
    finally:
        (ta._launch_exact_records, ta._launch_classic_records,
         ta._launch_exact_combine, ta._launch_classic_combine) = saved


@contextlib.contextmanager
def plain_merge():
    """While the block runs, CUDA tensors take K-h's plain version: the
    merge wrappers' launch (ops/merge._launch_merge) is swapped for
    merge_junctions_ref and _sort_combine, and its count stays. For the
    comparisons and the plain timings of this script only."""
    from find_circ2_tpu_torch.ops import merge as tm
    launch = tm._launch_merge

    def merge(src, cfg=None, lib=None):
        if "valid" in src:
            return tm._sort_combine(src)
        return tm.merge_junctions_ref(src, src["lens"], cfg)

    tm._launch_merge = merge
    try:
        yield
    finally:
        tm._launch_merge = launch


@contextlib.contextmanager
def watch_detect():
    """While the block runs, keep every batch the streaming loop sends to
    the single device's detect step (uint8 codes, int32 lengths and the
    prefilter flag) and count the exact-first and classic detect programs
    run. Yields the dict it fills."""
    import numpy as np
    from find_circ2_tpu_torch.models import pipeline as tpipe
    from find_circ2_tpu_torch.models import stream as tstream
    seen = dict(batches=[], fast=0, classic=0)
    saved = (tstream.dispatch_packed, tpipe.detect_batch_packed_fast,
             tpipe.detect_batch_packed)
    dispatch, fast, classic = saved

    def kept(dindex, arr, lens, cfg, prefilter=True):
        seen["batches"].append((np.array(arr), np.array(lens), prefilter))
        return dispatch(dindex, arr, lens, cfg, prefilter)

    def counted(name, fn):
        def call(*args, **kw):
            seen[name] += 1
            return fn(*args, **kw)
        return call

    tstream.dispatch_packed = kept
    tpipe.detect_batch_packed_fast = counted("fast", fast)
    tpipe.detect_batch_packed = counted("classic", classic)
    try:
        yield seen
    finally:
        (tstream.dispatch_packed, tpipe.detect_batch_packed_fast,
         tpipe.detect_batch_packed) = saved


def detect_inputs(d, arr, lens, cfg) -> tuple:
    """One batch's inputs of both detect kernels on the device, as
    detect_batch_packed_fast makes them: exact_anchor_stats' (table,
    ntable, meta, stacked anchors) and detect_core_packed's arguments
    before `cfg`, with K1 v4's hits and overflow flag."""
    import torch
    from find_circ2_tpu_torch.ops.anchor_align import (
        align_anchor_pair_fast, read_anchors)
    dev = d.device
    reads = torch.from_numpy(arr).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    anchors_a, anchors_b = read_anchors(reads, lens_t, cfg)
    hits_a, hits_b, overflow = align_anchor_pair_fast(
        d.table, d.ntable, d.meta, anchors_a, anchors_b, cfg)
    return ((d.table, d.ntable, d.meta, torch.cat([anchors_a, anchors_b])),
            (d.words, d.nbases, d.chrom_offsets, reads, lens_t, hits_a,
             hits_b, overflow))


def _first_rows(core_args, m: int) -> tuple:
    """detect_core_packed's arguments cut to their first m reads."""
    from find_circ2_tpu_torch.ops.anchor_align import AnchorHits
    words, nbases, offsets, reads, lens, ha, hb, overflow = core_args

    def cut(t):
        return t[:m].contiguous()
    return (words, nbases, offsets, cut(reads), cut(lens),
            AnchorHits(*map(cut, ha)), AnchorHits(*map(cut, hb)), overflow)


def _max_err(pairs) -> int:
    import torch
    return max((int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in pairs if a.numel()), default=0)


def hold_core(args, cfg, prefilter: bool, what: str, out: dict) -> None:
    """detect_core_packed (the kernel) against its plain version on the
    same CUDA tensors, every column of every row."""
    import torch
    from find_circ2_tpu_torch.ops import detect as td
    got = td.detect_core_packed(*args, cfg, prefilter)
    want = td.detect_core_packed_ref(*args, cfg, prefilter)
    torch.cuda.synchronize()
    out["core_err"] = max(out.get("core_err", 0), _max_err([(got, want)]))
    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:5, 0].tolist()
        fail(f"detect_core_packed differs from its plain version on {what},"
             f" prefilter {prefilter} (rows {bad})")


def hold_exact(args, cfg, what: str, out: dict) -> None:
    """exact_anchor_stats (the kernel) against its plain version on the
    same CUDA tensors: every AnchorHits field and `resolved`."""
    import torch
    from find_circ2_tpu_torch.ops import anchor_align as ta
    hits, resolved = ta.exact_anchor_stats(*args, cfg)
    whits, wres = ta.exact_anchor_stats_ref(*args, cfg)
    torch.cuda.synchronize()
    pairs = list(zip((*hits, resolved), (*whits, wres)))
    out["exact_err"] = max(out.get("exact_err", 0), _max_err(pairs))
    for name, (a, b) in zip((*hits._fields, "resolved"), pairs):
        if a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).nonzero()[:5, 0].tolist()
            fail(f"exact_anchor_stats differs from its plain version on "
                 f"{what}: {name} (anchors {bad})")


def detect_bounds(exact_args, core_args, cfg, prefilter: bool,
                  row_rate: float | None = None) -> dict:
    """The least time the card could take for each detect kernel on one
    batch's inputs: the larger of its bytes over the HBM rate (each input
    read once, each output written once) and its int32 operations over
    the SMs' 32-bit rate. Probe: the anchors, four 32-byte rows an anchor,
    meta, 30 output bytes an anchor; EXACT_OPS_PER_ANCHOR an anchor. Core:
    the bases [0, len) of each read twice, as the read and as its reverse
    complement (the kernel builds the second from the read's row; the
    count stays as portbench/yardstick/bounds.py froze it), the lengths,
    both anchors' five hit fields, each read's two K2 windows of len + 2
    bases and (prefilter on) two prefilter windows of len bases,
    half a byte a base (rows of length 0 need none), the chromosome
    offsets, the overflow flag, the [B, 14] rows; DETECT_OPS_PER_SPLIT for
    every valid split. With `row_rate` (random 32-byte rows a second, as
    gather_rows moved them in this run) also the probe's random-row
    floor: its 4 n rows at that rate, which says how far its bytes bound
    is reachable (the bytes bound stays the bound). `core_args` are
    detect_core_packed's arguments; portbench/tests pass them with a
    reverse complement after `lens`, which is not read."""
    import torch
    table, ntable, meta, anchors = exact_args
    n, a = anchors.shape
    offsets, reads, lens = core_args[2:5]
    ha = core_args[-3]
    B, Lp = reads.shape
    row = 4 * table.shape[1]
    out = {}
    ebytes = n * (a + 4 * row + 30) + 4 * meta.numel()
    out["exact"] = dict(bytes=ebytes, ops=EXACT_OPS_PER_ANCHOR * n)
    hit_bytes = sum(getattr(ha, f).element_size()
                    for f in ("pos", "strand", "aligned", "n_best", "qual"))
    bases = torch.clamp(lens.to(torch.int64), 0, Lp)
    k2_windows = 2 * ((bases + 3) // 2)[bases > 0]
    windows = int(k2_windows.sum()) + (
        2 * int(((bases + 1) // 2).sum()) if prefilter else 0)
    cbytes = (2 * int(bases.sum()) + 4 * B + 2 * B * hit_bytes + windows
              + 8 * offsets.numel() + 1 + 4 * 14 * B)
    splits = torch.clamp(bases - 2 * cfg.anchor_len + 1, min=0)
    out["core"] = dict(bytes=cbytes,
                       ops=DETECT_OPS_PER_SPLIT * int(splits.sum()))
    for rec in out.values():
        ops_ms = 1e3 * rec["ops"] / INT32_OPS_PER_S
        bytes_ms = 1e3 * rec["bytes"] / HBM_BYTES_PER_S
        rec.update(bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    if row_rate:
        out["exact"]["row_floor_ms"] = 1e3 * 4 * n / row_rate
        log(f"probe's random-row floor: {4 * n:,} random 32-byte rows at "
            f"{row_rate:,.0f} rows/s (gather_rows, W = 8, 2^20 random rows "
            f"of a 2^24-row table, this run) = "
            f"{out['exact']['row_floor_ms']:.5f} ms, beside its bound "
            f"{out['exact']['bound_ms']:.5f} ms by "
            f"{out['exact']['bound_by']}")
    return out


def label_split(fn, labels) -> dict:
    """Run fn once under torch.profiler. Its device activities (kernels,
    copies, fills), with their device milliseconds, by the innermost of
    the record_function `labels` around the host call that enqueued each
    (matched by correlation id); each label's host milliseconds. An
    activity whose host call lies in no label, or was not matched, counts
    under "other"; "total" counts all. Only {"total": None} when no
    profile held device activity (_profile): the split is not measured."""
    import torch
    prof, _ = _profile(fn)
    if prof is None:
        return {"total": None}
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == cpu and e.name in labels)
    enqueued = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    out = {name: dict(activities=0, device_ms=0.0, host_ms=0.0)
           for name in (*labels, "other", "total")}
    for lo, hi, name in spans:
        out[name]["host_ms"] += (hi - lo) / 1e3
    for e in _device_events(prof):
        t = enqueued.get(e.id)
        inner = [sp for sp in spans if t is not None and sp[0] <= t <= sp[1]]
        name = max(inner)[2] if inner else "other"
        for key in (name, "total"):
            out[key]["activities"] += 1
            out[key]["device_ms"] += (e.time_range.end
                                      - e.time_range.start) / 1e3
    return {k: v for k, v in out.items()
            if v["activities"] or v["host_ms"] or k == "total"}


def check_detect(dindex, batches, genome, cfg, card,
                 row_rate: float | None = None) -> dict:
    """Detect's two kernels on the card (phase 6), on the main path's
    index and the batches phase 5's stream sent to the single device:
    - exact_anchor_stats and detect_core_packed against their plain
      versions on the same CUDA tensors, every field, column and row, on
      every batch of the stream (the detect_cases batch is phase 3's);
    - the first batch forced through the classic redo (a fallback slice
      of REDO_SLOTS): detect_batch_packed_fast and detect_batch_packed
      with the kernels against the plain versions, every row flagged
      (multi bit 3), and the classic rows equal to the unforced ones but
      for that bit;
    - each kernel's times in the order plain, kernel, kernel, plain: as
      called (CUDA events) over the stream's batches, on the device alone
      (CUDA-graph replay; the probe on EXACT_TIMING_SETS anchor sets drawn
      from the genome, whose rows exceed the L2), the plain version's
      torch.profiler busy time, beside the bound of detect_bounds (and
      the probe's random-row floor); and each kernel alone on
      LATENCY_READS reads (the probe on twice as many anchors), where no
      warp shares its scheduler;
    - each kernel's SM cycles by stage on the first batch, and at
      LATENCY_READS reads, from its measurement build (detect_stages);
    - one batch of detect_batch_packed_fast with the kernels and with the
      plain versions: device activities, device ms and host enqueue ms
      split by the profiler labels (label_split).
    Returns those numbers."""
    import dataclasses
    import numpy as np
    import torch
    from find_circ2_tpu_torch.models import pipeline as tpipe
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.ops import detect as td
    dev = dindex.device
    d = dindex
    out = {}
    inputs = []
    for i, (arr, lens, prefilter) in enumerate(batches):
        ex, core = detect_inputs(d, arr, lens, cfg)
        hold_exact(ex, cfg, f"stream batch {i}", out)
        hold_core(core, cfg, prefilter, f"stream batch {i}", out)
        both = ex[3]
        B = both.shape[0] // 2
        hold_classic(lambda: ta.align_anchor_pair_fast(
            d.table, d.ntable, d.meta, both[:B], both[B:], cfg),
            f"stream batch {i}'s fallback slice", out)
        hold_classic(lambda: ta.align_anchors(d.table, d.meta, both, cfg),
                     f"stream batch {i}'s anchors (the redo's "
                     "enumeration)", out)
        inputs.append((ex, core))
    log(f"exact_anchor_stats, detect_core_packed, the fallback slice "
        f"(fallback_slice + refill_slice) and the redo's enumeration "
        f"(classic_anchor_stats) equal their plain versions on the card "
        f"on all {len(batches)} stream batches, exactly")

    # The classic redo, forced.
    arr, lens, prefilter = batches[0]
    small = dataclasses.replace(cfg, exact_fallback_slots=REDO_SLOTS)
    reads, lens_t = (torch.from_numpy(x).to(dev) for x in (arr, lens))

    def fast(c):
        return tpipe.detect_batch_packed_fast(
            d.words, d.nbases, d.table, d.ntable, d.meta, d.chrom_offsets,
            reads, lens_t, c, prefilter)

    def classic():
        return tpipe.detect_batch_packed(
            d.words, d.nbases, d.table, d.meta, d.chrom_offsets, reads,
            lens_t, cfg, prefilter)

    before = td.launches
    rows = {"forced": fast(small), "classic": classic(), "fast": fast(cfg)}
    with plain_detect():
        plain = {"forced": fast(small), "classic": classic()}
    torch.cuda.synchronize()
    if dev.type == "cuda" and td.launches - before != 3:
        fail(f"the redo check launched detect_core_packed "
             f"{td.launches - before} times, not 3")
    for name in plain:
        if not torch.equal(rows[name], plain[name]):
            fail(f"detect ({name}) differs from the plain versions on the "
                 f"forced classic redo")
    forced, cl, fa = (rows[k].cpu().numpy() for k in ("forced", "classic",
                                                      "fast"))
    if not (forced[:, 12] & 8).all() or (fa[:, 12] & 8).any() or \
            not np.array_equal(cl, fa):
        fail("the forced redo: multi bit 3 not on every row, or the "
             "classic rows differ from the exact-first ones")
    log(f"forced classic redo (exact_fallback_slots {REDO_SLOTS}) of a "
        f"{arr.shape[0]}-read batch: every row flagged; exact-first and "
        "classic rows equal the plain versions' and each other")

    # Times, beside the bounds.
    n = len(inputs)
    ex0, core0 = inputs[0]
    bounds = detect_bounds(ex0, core0, cfg, prefilter, row_rate)
    rng = np.random.default_rng(0)
    a = cfg.anchor_len
    codes = torch.from_numpy(genome.codes).to(dev)
    pos = torch.from_numpy(rng.integers(
        0, len(genome) - a, (EXACT_TIMING_SETS, ex0[3].shape[0]))).to(dev)
    sets = codes[pos[..., None] + torch.arange(a, device=dev)]
    flip = torch.from_numpy(rng.random(pos.shape) < 0.5).to(dev)[..., None]
    sets = torch.where(flip, torch.where(sets < 4, 3 - sets, sets).flip(-1),
                       sets).contiguous()

    def kernels(name):
        if name == "core":
            return (lambda i: td.detect_core_packed(*inputs[i][1], cfg,
                                                    prefilter),
                    lambda i: td.detect_core_packed_ref(*inputs[i][1], cfg,
                                                        prefilter),
                    lambda i: td.detect_core_packed(*inputs[i][1], cfg,
                                                    prefilter), n)
        return (lambda i: ta.exact_anchor_stats(*inputs[i][0], cfg),
                lambda i: ta.exact_anchor_stats_ref(*inputs[i][0], cfg),
                lambda i: ta.exact_anchor_stats(*ex0[:3], sets[i], cfg),
                EXACT_TIMING_SETS)

    # The same at a size that keeps every warp alone on its scheduler:
    # the launch and one warp's chain of round trips and arithmetic.
    few = [_first_rows(core, LATENCY_READS) for _, core in inputs]
    latency = {"core": (lambda i: td.detect_core_packed(*few[i], cfg,
                                                        prefilter), n,
                        LATENCY_READS),
               "exact": (lambda i: ta.exact_anchor_stats(
                   *ex0[:3], sets[i][:2 * LATENCY_READS], cfg),
                   EXACT_TIMING_SETS, 2 * LATENCY_READS)}

    for name in ("exact", "core"):
        kernel, plainf, alone, n_alone = kernels(name)
        p1, k1 = called_ms(plainf, range(n)), called_ms(kernel, range(n))
        k2, p2 = called_ms(kernel, range(n)), called_ms(plainf, range(n))
        gp1 = busy_ms(lambda: plainf(0))
        gk1 = graph_ms(alone, range(n_alone))
        gk2 = graph_ms(alone, range(n_alone))
        gp2 = busy_ms(lambda: plainf(0))
        gp, p_src = min(gp1, gp2)
        small, n_small, rows = latency[name]
        rec = dict(called_ms=min(k1, k2), plain_called_ms=min(p1, p2),
                   ms=min(gk1, gk2), plain_ms=gp,
                   latency_ms=min(graph_ms(small, range(n_small))
                                  for _ in range(2)), **bounds[name])
        out[name] = rec
        log(f"{name} kernel alone on {rows} "
            f"{'reads' if name == 'core' else 'anchors'} (each warp alone "
            f"on its scheduler): {rec['latency_ms']:.5f} ms device alone "
            f"(graph, {n_small} input sets), the launch and one warp's "
            f"chain; on {card}")
        log(f"{name} kernel on a {ex0[3].shape[0] // 2}-read batch: device "
            f"alone {rec['ms']:.5f} ms (graph, {n_alone} input sets) vs "
            f"plain {rec['plain_ms']:.5f} ms ({p_src} busy); as "
            f"called {rec['called_ms']:.5f} ms vs plain "
            f"{rec['plain_called_ms']:.5f} ms; bound {rec['bound_ms']:.5f} "
            f"ms by {rec['bound_by']} ({rec['bytes']:,} bytes, "
            f"{rec['ops']:,} int32 operations), "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it; on {card}")

    out["stages"] = detect_stages(
        ex0, core0, cfg, prefilter,
        f"the stream's first batch ({core0[3].shape[0]} reads)", card)
    out["latency_stages"] = detect_stages(
        (*ex0[:3], sets[0][:2 * LATENCY_READS]), few[0], cfg, prefilter,
        f"{LATENCY_READS} reads and {2 * LATENCY_READS} anchors, each "
        "warp alone on its scheduler", card)

    # One batch's device activities and host enqueue by label, the plain
    # versions and the kernels in turn.
    labels = DETECT_LABELS + EXPLORE_LABELS
    split = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_detect() if name == "plain" else contextlib.nullcontext()
        with ctx:
            fast(cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fast(cfg)
            enqueue = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            got = label_split(lambda: fast(cfg), labels)
        got["enqueue_ms"] = enqueue
        split[name] = got
    out["split"] = split
    for name, got in split.items():
        if got["total"] is None:
            log(f"one {arr.shape[0]}-read detect batch with the {name} "
                f"versions: host enqueue {got['enqueue_ms']:.3f} ms; device "
                f"activities by label not measured (torch.profiler "
                f"recorded none in {PROFILE_TRIES} tries); on {card}")
            continue
        log(f"one {arr.shape[0]}-read detect batch with the {name} "
            f"versions: {got['total']['activities']} device activities, "
            f"{got['total']['device_ms']:.3f} device ms, host enqueue "
            f"{got['enqueue_ms']:.3f} ms; by label (activities / device ms "
            f"/ host ms): " + "; ".join(
                f"{k} {v['activities']} / {v['device_ms']:.3f} / "
                f"{v['host_ms']:.3f}" for k, v in got.items()
                if isinstance(v, dict) and k != "total") + f"; on {card}")
    out["max_abs_err"] = max(out["core_err"], out["exact_err"])
    out["anchor_sets"] = [ex[3] for ex, _ in inputs]
    return out


def detect_stages(exact_args, core_args, cfg, prefilter: bool, what: str,
                  card: str) -> dict:
    """Where detect's two kernels spend their time on one batch: each
    one's measurement build (ops/anchor_align.exact_stage_cycles,
    ops/detect.detect_stage_cycles), its outputs held against the plain
    version's, and per stage the median, 90th percentile and maximum of
    the SM clock cycles over the warps."""
    import torch
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.ops import detect as td
    out = {}
    got, cyc = ta.exact_stage_cycles(*exact_args, cfg)
    if not _equal_all(got, ta.exact_anchor_stats_ref(*exact_args, cfg)):
        fail(f"the stamped probe differs from its plain version on {what}")
    out["exact"] = _quantiles(cyc, ta.EXACT_STAGES)
    rows, cyc = td.detect_stage_cycles(*core_args, cfg, prefilter)
    if not torch.equal(rows, td.detect_core_packed_ref(*core_args, cfg,
                                                       prefilter)):
        fail(f"the stamped detect core differs from its plain version on "
             f"{what}")
    out["core"] = _quantiles(cyc, td.STAGES)
    for name, per in (("exact", ta.EXACT_ANCHORS_PER_WARP),
                      ("core", td.READS_PER_WARP)):
        log(f"{name} stages on {what}, SM clock cycles a warp "
            f"({per} {'anchors' if name == 'exact' else 'reads'} a warp; "
            f"median / p90 / max): " + "; ".join(
                f"{k} {m:.0f} / {p:.0f} / {x:.0f}"
                for k, (m, p, x) in out[name].items()) + f"; on {card}")
    return out


def classic_bound(table, n: int, cfg, slots: bool = False,
                  stats=None) -> dict:
    """The least time the card could take for K1's enumeration of n
    anchors (or fallback slots): the larger of its bytes over the HBM
    rate and its int32 operations over the SMs' 32-bit rate. Bytes, each
    read once: the anchors, two 32-byte table rows a canonical variant,
    meta, the slots (slot mode) and the hit fields written; with `stats`
    (the call's outputs) the count and first_pos rows written, and with
    extras the 4-byte ext_id word of each variant whose key the table
    holds (a first position on either strand slot), the ext row of each
    variant that has a real one (some lane of its slots is not
    LARGE_POS; row 0 is the dummy) and the extras written. Operations:
    CLASSIC_OPS_PER_VARIANT a variant."""
    a = cfg.anchor_len
    V = 1 + 3 * a
    hit_bytes = 1 + 8 + 5 * 4
    nbytes = (n * (a + 2 * V * 4 * table.shape[1] + hit_bytes) + 4 * 3
              + (8 * n if slots else 0))
    if stats is not None:
        count, first_pos, *extras = stats
        nbytes += 4 * count.numel() + 8 * first_pos.numel()
        if extras:
            x = extras[0]
            real = (x.view(n, 2, V, -1) != 0xFFFFFFFF).any(-1).any(1)
            held = (first_pos.view(n, 2, V) != 0xFFFFFFFF).any(1)
            nbytes += (4 * int(held.sum())
                       + int(real.sum()) * 4 * 2 * x.shape[-1]
                       + 8 * x.numel())
    ops = CLASSIC_OPS_PER_VARIANT * V * n
    return _bound(nbytes, ops)


def _bound(nbytes: int, ops: int) -> dict:
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def classic_stages(calls, card: str) -> dict:
    """Where K1's two kernels spend their time: each of `calls` (name ->
    (stamped, plain, what)) runs the measurement build of
    csrc/classic_k1.cu (ops/anchor_align.classic_stage_cycles,
    compact_stage_cycles), its outputs held against the plain version's,
    and per stage the median, 90th percentile and maximum of the SM clock
    cycles over the warps (the enumeration) or of the one block (the
    compaction)."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    out = {}
    for name, (stamped, plain, what) in calls.items():
        got, cyc = stamped()
        if not _equal_all(got, plain()):
            fail(f"the stamped {name} kernel differs from its plain version "
                 f"on {what}")
        names = (ta.COMPACT_STAGES if name == "compact"
                 else ta.CLASSIC_STAGES)
        out[name] = _quantiles(cyc, names)
        log(f"{name} stages on {what}, SM clock cycles "
            f"{'of the block' if name == 'compact' else 'a warp'} (median / "
            f"p90 / max): " + "; ".join(
                f"{k} {m:.0f} / {p:.0f} / {x:.0f}"
                for k, (m, p, x) in out[name].items()) + f"; on {card}")
    return out


def time_classic(d, anchor_sets, arr, lens, cfg, card) -> dict:
    """K1's two new kernels at the main path's shapes, each beside its
    plain version, in the order plain, kernel, kernel, plain: as called
    (CUDA events, over all input sets), on the device alone (CUDA-graph
    replay over the sets, whose table rows exceed the L2), the plain
    version's torch.profiler busy time, and the bound (classic_bound;
    the compaction's bytes are `resolved` read, the slice written).
    Shapes: the stream's fallback slice (refill_slice, slot mode, on each
    batch's exact probe and compaction), the compaction itself
    (fallback_slice on each batch's `resolved`), the classic redo
    (classic_anchor_stats, hits only, on each batch's stacked anchors)
    and the explore chunk (with the extras, on the stacked anchors of
    each full chunk of EXPLORE_READS routed reads). The compaction's
    library call, one stable torch.argsort of each batch's `resolved`, is
    timed on the device alone beside it; the port never calls it. Then
    the stage table of each kernel on the first input set of the slice,
    the compaction and the explore chunk (classic_stages)."""
    import torch
    from find_circ2_tpu_torch.ops import anchor_align as ta
    dev = d.device
    n = anchor_sets[0].shape[0]
    k = min(cfg.exact_fallback_slots, n)
    slices = []
    for both in anchor_sets:
        hits, resolved = ta.exact_anchor_stats(d.table, d.ntable, d.meta,
                                               both, cfg)
        slices.append((both, hits, resolved,
                       ta.fallback_slice(resolved, k)[0]))
    chunks = [torch.cat(ta.read_anchors(
        torch.from_numpy(arr[lo:lo + EXPLORE_READS]).to(dev),
        torch.from_numpy(lens[lo:lo + EXPLORE_READS]).to(dev), cfg))
        for lo in range(0, arr.shape[0] - EXPLORE_READS + 1, EXPLORE_READS)]
    t, m = d.table, d.meta
    shapes = {
        "fallback": (
            lambda i: ta.refill_slice(t, m, slices[i][0], slices[i][3],
                                      slices[i][1], cfg),
            lambda i: ta.refill_slice_ref(t, m, slices[i][0], slices[i][3],
                                          slices[i][1], cfg),
            len(slices), lambda i: classic_bound(t, k, cfg, slots=True)),
        "compact": (
            lambda i: ta.fallback_slice(slices[i][2], k),
            lambda i: ta.fallback_slice_ref(slices[i][2], k),
            len(slices),
            lambda i: _bound(n + 8 * k + 1, COMPACT_OPS_PER_ANCHOR * n)),
        "redo": (
            lambda i: ta.classic_anchor_stats(t, m, anchor_sets[i], cfg),
            lambda i: ta.classic_anchor_stats_ref(t, m, anchor_sets[i],
                                                  cfg),
            len(anchor_sets), lambda i: classic_bound(t, n, cfg)),
        "explore": (
            lambda i: ta.classic_anchor_stats(t, m, chunks[i], cfg, d.ext,
                                              d.ext_id, stats=True),
            lambda i: ta.classic_anchor_stats_ref(t, m, chunks[i], cfg,
                                                  d.ext, d.ext_id,
                                                  stats=True),
            len(chunks),
            lambda i: classic_bound(t, chunks[i].shape[0], cfg, stats=(
                ta.classic_anchor_stats(t, m, chunks[i], cfg, d.ext,
                                        d.ext_id, stats=True)[1]))),
    }
    out = {}
    for name, (kernel, plain, sets, bound) in shapes.items():
        rec = out[name] = _time_shape(kernel, plain, sets, bound)
        extra = ""
        if name == "compact":
            rec["library_ms"] = argsort_ms([s[2] for s in slices])
            extra = (f"; library call (stable torch.argsort) "
                     f"{rec['library_ms']:.5f} ms device alone")
        kind = "compaction" if name == "compact" else "enumeration"
        _log_shape(f"{name} ({kind} kernel)", rec, card, extra)
    both, hits, resolved, idx = slices[0]
    out["stages"] = classic_stages({
        "fallback": (
            lambda: ta.classic_stage_cycles(t, m, both, cfg, slots=idx,
                                            hits=ta.AnchorHits(*(
                                                x.clone() for x in hits))),
            lambda: (ta.refill_slice_ref(t, m, both, idx, hits, cfg), None),
            f"the first batch's fallback slice ({k} slots)"),
        "compact": (
            lambda: ta.compact_stage_cycles(resolved, k),
            lambda: ta.fallback_slice_ref(resolved, k),
            f"the first batch's {n} resolved flags"),
        "explore": (
            lambda: ta.classic_stage_cycles(t, m, chunks[0], cfg, d.ext,
                                            d.ext_id, stats=True),
            lambda: ta.classic_anchor_stats_ref(t, m, chunks[0], cfg, d.ext,
                                                d.ext_id, stats=True),
            f"the first explore chunk ({chunks[0].shape[0]} anchors, with "
            "the extras)")}, card)
    return out


def argsort_ms(resolved) -> float:
    """The compaction's library call on the device alone: one stable
    torch.argsort of each `resolved` (as int8), by CUDA-graph replay."""
    import torch

    def call(i):
        return torch.argsort(resolved[i].to(torch.int8), stable=True)
    return min(graph_ms(call, range(len(resolved))),
               graph_ms(call, range(len(resolved))))


def compare_detect_streams(dindex, fq, genome, index, cfg, card,
                           bed) -> dict:
    """run_fastq with device explore, the detect kernels against their
    plain versions (plain_detect; K1's enumeration is explore's K1 too, so
    explore's K1 goes plain with it), in the order kernel, plain, plain,
    kernel: equal BED and stats (`bed`, phase 6's), and per version the
    least stream seconds, `device_dispatch` and `explore_dispatch`
    seconds."""
    from find_circ2_tpu_torch.models.aggregate import Aggregator
    from find_circ2_tpu_torch.models.stream import run_fastq
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    out = {}
    for name in ("kernel", "plain", "plain", "kernel"):
        agg = Aggregator(genome, cfg)
        times = StageTimes()
        ctx = plain_detect() if name == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            run_fastq(dindex, fq, agg, cfg, times=times,
                      slowpath=(genome, index))
            wall = time.perf_counter() - t0
        if _render(agg) != bed:
            fail(f"run_fastq with the {name} detect versions gives another "
                 "BED or stats")
        rec = dict(seconds=wall, reads=times.n_reads, **{
            k: times.totals.get(k, 0.0)
            for k in ("device_dispatch", "explore_dispatch")})
        old = out.get(name)
        out[name] = rec if old is None else {k: min(old[k], rec[k])
                                             for k in rec}
    for name, rec in out.items():
        log(f"run_fastq, detect with the {name} versions: "
            f"{rec['seconds']:.3f} s, {rec['reads'] / rec['seconds']:,.1f} "
            f"reads/s, device_dispatch {rec['device_dispatch']:.3f} s, "
            f"explore_dispatch {rec['explore_dispatch']:.3f} s (least of "
            f"two; equal BED and stats) on {card}")
    return out


def compare_streams(dindex, fq, genome, index, cfg, card) -> dict:
    """run_fastq with device explore (None: the index has extras) and
    with the host twin (explore=False) on the same FASTQ and index: equal
    BEDs and stats, both stream times, and the row-gather launches of
    each; then one device-explore stream under torch.profiler for the
    device's busy share. Returns the launches and seconds per mode and
    the profiled run's numbers."""
    from find_circ2_tpu_torch.models.aggregate import Aggregator
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    from find_circ2_tpu_torch.models.stream import run_fastq
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.ops import explore as tx
    from find_circ2_tpu_torch.ops import gather_rows as gr
    out, beds = {}, {}
    out["beds"] = beds
    for mode, explore in (("device", None), ("host", False)):
        agg = Aggregator(genome, cfg)
        times = StageTimes()
        gr.launches = gr.multi_launches = tx.launches = 0
        ta.classic_launches = 0
        t0 = time.perf_counter()
        run_fastq(dindex, fq, agg, cfg, times=times, slowpath=(genome, index),
                  explore=explore)
        wall = time.perf_counter() - t0
        launches = gr.launches + gr.multi_launches
        beds[mode] = _render(agg)
        out[mode] = dict(launches=launches, explore_launches=tx.launches,
                         classic_launches=ta.classic_launches,
                         seconds=wall, reads=times.n_reads)
        log(f"run_fastq explore={explore}: {wall:.3f} s, "
            f"{times.n_reads / wall:,.1f} reads/s, {launches} row-gather, "
            f"{ta.classic_launches} classic_anchor_stats and {tx.launches} "
            f"explore_pairs launches on {card}; stages:\n"
            + times.report(wall=wall))
        if (tx.launches > 0) != (explore is None):
            fail(f"run_fastq explore={explore} launched explore_pairs "
                 f"{tx.launches} times")
        ran = set(times.counts)
        want = ({"explore_dispatch"}, {"slowpath_multihit"})
        if explore is not None:
            want = want[::-1]
        if not want[0] <= ran or want[1] & ran:
            fail(f"run_fastq explore={explore} ran stages {sorted(ran)}")
    if beds["device"] != beds["host"]:
        fail("run_fastq BED or stats differ between device explore and "
             "the host twin")
    log(f"device explore and host twin give equal BED and stats "
        f"({beds['device'][0].count(chr(10))} junctions)")
    t0 = time.perf_counter()
    prof = device_profile(lambda: run_fastq(
        dindex, fq, Aggregator(genome, cfg), cfg, slowpath=(genome, index)))
    out["profiled"] = dict(prof, seconds=time.perf_counter() - t0)
    if prof["ops"] is None:
        log(f"run_fastq with device explore: device activities and busy "
            f"share not measured (torch.profiler recorded none in "
            f"{PROFILE_TRIES} tries); {prof['busy_ms']:.3f} ms as called "
            f"({prof['source']}) on {card}")
    else:
        log(f"run_fastq with device explore under torch.profiler: "
            f"{out['profiled']['seconds']:.3f} s ({prof['tries']} "
            f"run(s)), {prof['ops']} device activities, device busy "
            f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms "
            f"first-to-last span ({100 * prof['busy_share']:.1f}%) on "
            f"{card}")
    return out


def _render(agg) -> tuple:
    """An Aggregator's BED text and sorted stats counters."""
    from find_circ2_tpu_torch.io.bed import write_bed
    buf = io.StringIO()
    write_bed(buf, agg.rows(sample_name="s"))
    return buf.getvalue(), sorted(agg.stats.counts.items())


def _precision_recall(rows, truth) -> tuple[float, float]:
    """Precision and recall of filter-stack calls against the planted
    circles, as bench.py measures them."""
    called = {(r.chrom, r.start, r.end) for r in rows}
    tp = len(truth & called)
    return tp / max(1, len(called)), tp / max(1, len(truth))


def _coincident_probes(qt, cfg, seq: str) -> bool:
    """Whether a <= 1-mismatch variant of one of the read's anchors is a
    key of the query table `qt` whose two cuckoo buckets are one bucket.
    Both probes then match its one slot, and the table lookups (K1,
    single table) count it twice; the oracle counts it once."""
    import numpy as np
    import torch
    from find_circ2_tpu_torch.index.hashtable import (LANES, S8_MASK, SLOTS,
                                                      mix_hash)
    from find_circ2_tpu_torch.models.pipeline import encode_batch
    from find_circ2_tpu_torch.ops.anchor_align import (_canonical,
                                                       enumerate_variants,
                                                       read_anchors)
    arr, lens = encode_batch([seq], 1, cfg.max_read_len)
    anchors = torch.cat(read_anchors(torch.from_numpy(arr),
                                     torch.from_numpy(lens), cfg))
    p12, s8, p12r, s8r, _ = enumerate_variants(anchors, cfg)
    _, cp, cs = _canonical((p12, s8), (p12r, s8r))
    cp = cp.numpy().ravel().astype(np.uint32)
    cs = cs.numpy().ravel().astype(np.uint32)
    n_buckets = int(qt.meta[2])
    h1, h2 = (mix_hash(cp, cs, salt).astype(np.int64) % n_buckets
              for salt in np.asarray(qt.meta[:2], np.int32).view(np.uint32))
    rows = qt.table.reshape(-1, SLOTS, LANES)[h1]
    present = ((rows[..., 0] == cp[:, None].astype(np.int32))
               & ((rows[..., 1] & S8_MASK) == cs[:, None].astype(np.int32))
               ).any(axis=1)
    return bool((present & (h1 == h2)).any())


def _row_is_oracle_call(rows: dict, i: int, call) -> bool:
    """Row i of unpacked detect results against the oracle's ReadCall:
    a single-best row (multi bit 0 clear) with the oracle's status and,
    for a junction, all of its fields."""
    from find_circ2_tpu_torch.config import ST_JUNCTION
    from find_circ2_tpu_torch.io.twobit import codes_to_seq
    if rows["multi"][i] & 1 or int(rows["status"][i]) != call.status:
        return False
    if call.status != ST_JUNCTION:
        return True
    got = {k: int(rows[k][i]) for k in (
        "kind", "start", "end", "sense", "align_strand", "edits", "n_bp",
        "overlap", "qual_left", "qual_right")}
    got["chrom_idx"] = int(rows["chrom"][i])
    return (all(getattr(call, k) == v for k, v in got.items())
            and codes_to_seq(rows["signal"][i]) == call.signal)


def check_sharded(fq, sim, genome, index, dindex, cfg, streams, truth,
                  card) -> dict:
    """Phase 7: ShardedEngine on a 2x2 mesh whose four slots are all the
    single-device index's device (cuda:0 on the card), over phase 5's
    index (its neighbour table is relocated, not rebuilt). `run_fastq`
    with the engine's dispatch and redo must give phase 6's BED and
    stats byte for byte and the filter stack's precision and recall, run
    §2b on the host twin, and launch exactly what its batches imply: a
    data row's exact-first batch one probe a shard (exact_records on
    shard 1, then shard 0's exact_combine, which finishes), one
    compaction (fallback_slice), one slot-mode enumeration a shard
    (classic_records on shard 1, then shard 0's classic_combine), then
    detect's core; a classic redo one enumeration a shard (the last a
    classic_combine) and the core; the row gather, explore and the
    single-table K1 kernels never. The
    stream runs again with the plain
    versions (plain_detect) and once more with the kernels: equal BED,
    wall and device_dispatch seconds of each.

    Then, on every batch of the library, the engine's packed rows
    (exact-first and classic) with the kernels against the plain
    versions, and its classic rows against the single device's
    `detect_batch`, read for read: a read may differ only by the
    reference's double count (`_coincident_probes` on the full table, not
    on the shards), and then the engine's row must be the oracle's call.
    With those reads left out (length 0), `detect_merged` with the
    kernels equals it with the plain versions (plain_detect, plain_merge)
    on all N rows and the single device's `merge_junctions` on the valid
    rows, which equals the plain merge on all N rows. The first stream
    batch forced through the redo (a fallback slice of REDO_SLOTS), its
    device activities by label with the kernels and the plain versions,
    and the new kernels' times (time_shard, merge_times). Returns the
    launches and numbers."""
    import dataclasses
    import numpy as np
    import torch
    from find_circ2_tpu_torch.io.bed import passes_filter
    from find_circ2_tpu_torch.models.aggregate import Aggregator
    from find_circ2_tpu_torch.models.oracle import call_read
    from find_circ2_tpu_torch.models.pipeline import (detect_batch,
                                                      encode_batch,
                                                      unpack_results)
    from find_circ2_tpu_torch.models.stream import run_fastq
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.ops import detect as td
    from find_circ2_tpu_torch.ops import explore as tx
    from find_circ2_tpu_torch.ops import gather_rows as gr
    from find_circ2_tpu_torch.ops import merge as tm
    from find_circ2_tpu_torch.ops.merge import merge_junctions
    from find_circ2_tpu_torch.parallel.mesh import make_mesh
    from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ShardedEngine(genome, index,
                        make_mesh(4, (2, 2), [dindex.device] * 4), cfg)
    out["setup_s"] = dict(eng.setup_s, total=time.perf_counter() - t0)
    copies = {id(s.table) for row in eng.rows for s in row.shards}
    if not eng.fast or eng.n_data != 2 or len(copies) != 2:
        fail(f"2x2 engine: fast={eng.fast}, {eng.n_data} data rows, "
             f"{len(copies)} table copies (want True, 2, 2)")
    log(f"2x2 sharded engine on {dindex.device}: shards carved in "
        f"{eng.setup_s['carve']:.3f} s, neighbour table relocated in "
        f"{eng.setup_s['relocate']:.3f} s, {out['setup_s']['total']:.3f} s "
        f"in all on the host; {len(copies)} copies of the index shards for "
        f"four slots, on {card}")

    seen = dict(fast=0, classic=0, batches=[])

    def dispatch(arr, lens):
        seen["fast"] += 1
        seen["batches"].append((np.array(arr), np.array(lens)))
        return eng.dispatch_packed(arr, lens)

    def redo(arr, lens):
        seen["classic"] += 1
        return eng.redo_packed(arr, lens)

    def stream(watched: bool):
        agg, times = Aggregator(genome, cfg), StageTimes()
        t0 = time.perf_counter()
        run_fastq(None, fq, agg, cfg, times=times, slowpath=(genome, index),
                  dispatch=dispatch if watched else eng.dispatch_packed,
                  redo=redo if watched else eng.redo_packed)
        return agg, times, time.perf_counter() - t0

    counters = ((gr, "launches"), (gr, "multi_launches"), (tx, "launches"),
                (td, "launches"), (ta, "exact_launches"),
                (ta, "classic_launches"), (ta, "compact_launches"),
                (ta, "exact_record_launches"),
                (ta, "classic_record_launches"),
                (ta, "exact_combine_launches"),
                (ta, "classic_combine_launches"),
                (tm, "launches"), (tm, "calls"))
    for mod, name in counters:
        setattr(mod, name, 0)
    agg, times, wall = stream(True)
    out["launches"] = {"gather_rows": gr.launches,
                       "gather_rows_multi": gr.multi_launches,
                       "detect_core_packed": td.launches,
                       "exact_anchor_stats": ta.exact_launches,
                       "classic_anchor_stats": ta.classic_launches,
                       "fallback_slice": ta.compact_launches,
                       "exact_records": ta.exact_record_launches,
                       "classic_records": ta.classic_record_launches,
                       "exact_combine": ta.exact_combine_launches,
                       "classic_combine": ta.classic_combine_launches,
                       "merge": tm.launches}
    out["explore_launches"] = tx.launches
    out.update(seconds=wall, reads=times.n_reads,
               peak_bytes=torch.cuda.max_memory_allocated())
    host = streams["host"]
    log(f"sharded run_fastq (2x2 on {dindex.device}): {wall:.3f} s, "
        f"{times.n_reads / wall:,.1f} reads/s; run_fastq explore=False on "
        f"the single device, same index, this call: {host['seconds']:.3f} "
        f"s, {host['reads'] / host['seconds']:,.1f} reads/s; peak device "
        f"memory {out['peak_bytes']:,} bytes; on {card}; stages:\n"
        + times.report(wall=wall))
    rows, shards = eng.n_data, len(eng.rows[0].shards)
    fast, classic = seen["fast"], seen["classic"]
    want = {"gather_rows": 0, "gather_rows_multi": 0,
            "detect_core_packed": (fast + classic) * rows,
            "exact_anchor_stats": 0, "classic_anchor_stats": 0,
            "fallback_slice": fast * rows,
            "exact_records": fast * rows * (shards - 1),
            "classic_records": (fast + classic) * rows * (shards - 1),
            "exact_combine": fast * rows,
            "classic_combine": (fast + classic) * rows, "merge": 0}
    log(f"kernel launches on the sharded stream ({fast} exact-first "
        f"batches, {classic} classic redos, {rows} data rows of {shards} "
        f"index shards): " + ", ".join(
            f"{k} {v}" for k, v in out["launches"].items())
        + f"; explore_pairs {tx.launches} (§2b on the host twin)")
    if out["launches"] != want or tx.launches or not fast:
        fail(f"the sharded stream's launches {out['launches']} (explore "
             f"{tx.launches}) are not what its batches imply: {want}")
    ran = set(times.counts)
    if "slowpath_multihit" not in ran or "explore_dispatch" in ran:
        fail(f"the sharded stream ran stages {sorted(ran)}: §2b must run "
             "on the host twin")
    got = _render(agg)
    if got != streams["beds"]["device"]:
        fail("the sharded stream's BED or stats differ from the single "
             "device's")
    kept = [r for r in agg.rows(sample_name="s")
            if passes_filter(r, cfg.max_span, cfg.min_support,
                             cfg.filter_max_edits)]
    prec, rec = _precision_recall(kept, truth)
    if (round(prec, 4), round(rec, 4)) != (EXPECT_PRECISION, EXPECT_RECALL):
        fail(f"sharded precision {prec:.4f} / recall {rec:.4f}, the "
             f"reference gives {EXPECT_PRECISION} / {EXPECT_RECALL}")
    log(f"sharded stream: BED ({got[0].count(chr(10))} junctions) and stats "
        f"equal the single device's; filtered precision {prec:.4f}, recall "
        f"{rec:.4f}")

    # The stream with the plain versions, then with the kernels again.
    runs = {"kernel": dict(seconds=wall, reads=times.n_reads,
                           device_dispatch=times.totals.get(
                               "device_dispatch", 0.0))}
    for name in ("plain", "kernel"):
        with plain_detect() if name == "plain" else contextlib.nullcontext():
            agg_n, times_n, wall_n = stream(False)
        if _render(agg_n) != got:
            fail(f"the sharded stream with the {name} versions gives "
                 "another BED or stats")
        rec_n = dict(seconds=wall_n, reads=times_n.n_reads,
                     device_dispatch=times_n.totals.get("device_dispatch",
                                                        0.0))
        old = runs.get(name)
        runs[name] = rec_n if old is None else {k: min(old[k], rec_n[k])
                                                for k in rec_n}
    out["streams"] = runs
    for name, r in runs.items():
        log(f"sharded run_fastq with the {name} versions: "
            f"{r['seconds']:.3f} s, {r['reads'] / r['seconds']:,.1f} "
            f"reads/s, device_dispatch {r['device_dispatch']:.3f} s"
            f"{' (least of two)' if name == 'kernel' else ''}; equal BED "
            f"and stats; on {card}")

    # Every batch: packed rows, kernels against plain; classic rows read
    # for read; detect_merged and the merge, kernels against plain.
    reads = [(n, s) for n, s in sim.reads
             if 2 * cfg.anchor_len <= len(s) <= cfg.max_read_len]
    bs, n_rows, faults = cfg.batch_size, 0, []
    err, merge_calls, merge_kernels = 0, 0, 0
    for lo in range(0, len(reads), bs):
        part = reads[lo:lo + bs]
        arr, lens = encode_batch([s for _, s in part], bs, cfg.max_read_len)
        single = detect_batch(
            dindex.words, dindex.nbases, dindex.table, dindex.meta,
            dindex.chrom_offsets, torch.from_numpy(arr).to(dindex.device),
            torch.from_numpy(lens).to(dindex.device), cfg)
        one = {k: v.cpu().numpy() for k, v in single.items()}
        packed = [eng.dispatch_packed(arr, lens), eng.redo_packed(arr, lens)]
        with plain_detect():
            plain = [eng.dispatch_packed(arr, lens),
                     eng.redo_packed(arr, lens)]
        err = max(err, _max_err(zip(packed, plain)))
        if not all(torch.equal(a, b) for a, b in zip(packed, plain)):
            fail(f"the sharded engine's packed rows with the kernels "
                 f"differ from the plain versions' on the batch at read {lo}")
        many = unpack_results(packed[1].cpu().numpy())
        differ = np.flatnonzero((lens > 0) & np.any(
            [(one[k] != many[k]).reshape(bs, -1).any(axis=1) for k in one],
            axis=0))
        for i in differ:
            name, seq = part[i]
            if not (_coincident_probes(index.qtable, cfg, seq)
                    and _row_is_oracle_call(many, i, call_read(
                        genome, index, name, seq, cfg))):
                fail(f"the sharded engine's classic row of read {name} "
                     "differs from the single device's, and not by the "
                     "double count of a key whose two probe buckets "
                     "coincide")
            faults.append(name)
            log(f"read {name}: (single device, engine) "
                + str({k: (one[k][i].tolist(), many[k][i].tolist())
                       for k in one if np.any(one[k][i] != many[k][i])}))
        lens_kept = np.where(np.isin(np.arange(bs), differ), 0,
                             lens).astype(np.int32)
        before = (tm.calls, tm.launches)
        merged = eng.detect_merged(arr, lens_kept)
        merge_calls += tm.calls - before[0]
        merge_kernels += tm.launches - before[1]
        with plain_detect(), plain_merge():
            merged_plain = eng.detect_merged(arr, lens_kept)
        kept_t = torch.from_numpy(lens_kept).to(dindex.device)
        want = merge_junctions(single, kept_t, cfg)
        with plain_merge():
            want_plain = merge_junctions(single, kept_t, cfg)
        for a, b in ((merged, merged_plain), (want, want_plain)):
            for k in b:
                x, y = (np.asarray(t.cpu() if isinstance(t, torch.Tensor)
                                   else t).astype(np.int64)
                        for t in (a[k], b[k]))
                err = max(err, int(np.abs(x - y).max(initial=0)))
                if not np.array_equal(x, y):
                    fail(f"detect_merged or merge_junctions with the "
                         f"kernels differs from the plain versions in {k} "
                         f"on the batch at read {lo}")
        want = {k: v.cpu().numpy() for k, v in want.items()}
        n = int(want["valid"].sum())
        if int(merged["valid"].sum()) != n or not all(
                np.array_equal(merged[k][:n], want[k][:n]) for k in want):
            fail(f"detect_merged differs from detect_batch + "
                 f"merge_junctions on the batch at read {lo}")
        n_rows += n
    out["merged_batches"] = -(-len(reads) // bs)
    out["probe_faults"] = faults
    # One C call a data row (bs / rows rows) and one for their tables (bs
    # rows), each launching the kernels its rows imply.
    out["merge_calls"] = merge_calls
    out["merge_launches"] = merge_kernels
    want_kernels = out["merged_batches"] * (
        rows * tm.merge_kernels(bs // rows) + tm.merge_kernels(bs))
    if (merge_calls != out["merged_batches"] * (rows + 1)
            or merge_kernels != want_kernels):
        fail(f"detect_merged made {merge_calls} merge calls launching "
             f"{merge_kernels} kernels in {out['merged_batches']} batches: "
             f"want one call for each of {rows} data rows and one for "
             f"their tables, {want_kernels} kernels")
    log(f"detect_merged with the kernels equals it with the plain versions "
        f"(all rows) and detect_batch + merge_junctions (valid rows) on all "
        f"{out['merged_batches']} batches ({n_rows} junction rows; "
        f"{merge_calls} merge calls launched {merge_kernels} kernels), "
        f"merge_junctions with "
        f"the kernel equals the plain merge on all rows; the engine's "
        f"packed rows (exact-first and classic) with the kernels equal the "
        f"plain versions' on every batch; classic rows equal read for read "
        f"but for {len(faults)} reads {faults}, where the single table "
        f"counts a key whose two probe buckets coincide twice and the "
        f"engine gives the oracle's call")

    # The first stream batch forced through the redo.
    arr0, lens0 = seen["batches"][0]
    multi = td.PACK_FIELDS.index("multi")
    eng.cfg = dataclasses.replace(cfg, exact_fallback_slots=REDO_SLOTS)
    try:
        forced = [eng.dispatch_packed(arr0, lens0),
                  eng.redo_packed(arr0, lens0)]
        with plain_detect():
            forced_plain = [eng.dispatch_packed(arr0, lens0),
                            eng.redo_packed(arr0, lens0)]
    finally:
        eng.cfg = cfg
    err = max(err, _max_err(zip(forced, forced_plain)))
    if (not all(torch.equal(a, b) for a, b in zip(forced, forced_plain))
            or not bool((forced[0][:, multi] & 8).all())
            or not torch.equal(forced[1], eng.redo_packed(arr0, lens0))):
        fail(f"the sharded batch forced through the redo ({REDO_SLOTS} "
             "slots): the kernels differ from the plain versions, a row "
             "lacks the overflow flag, or the redo's rows changed")
    out["shard_err"] = err
    log(f"the sharded engine's first stream batch with a fallback slice "
        f"of {REDO_SLOTS}: every row flagged (multi bit 3), the packed rows "
        f"and the classic redo's with the kernels equal the plain "
        f"versions'; on {card}")

    # One sharded batch's device activities by label, then the times.
    split = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        with plain_detect() if name == "plain" else contextlib.nullcontext():
            eng.dispatch_packed(arr0, lens0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.dispatch_packed(arr0, lens0)
            enqueue = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            got_split = label_split(lambda: eng.dispatch_packed(arr0, lens0),
                                    DETECT_LABELS)
        got_split["enqueue_ms"] = enqueue
        split[name] = got_split
    out["split"] = split
    for name, g in split.items():
        head = (f"one {arr0.shape[0]}-read sharded batch (2x2) with the "
                f"{name} versions: host enqueue {g['enqueue_ms']:.3f} ms")
        if g["total"] is None:
            log(f"{head}; device activities by label not measured "
                f"(torch.profiler recorded none in {PROFILE_TRIES} tries); "
                f"on {card}")
            continue
        log(f"{head}, {g['total']['activities']} device activities, "
            f"{g['total']['device_ms']:.3f} device ms; by label "
            f"(activities / device ms / host ms): " + "; ".join(
                f"{k} {v['activities']} / {v['device_ms']:.3f} / "
                f"{v['host_ms']:.3f}" for k, v in g.items()
                if isinstance(v, dict) and k != "total") + f"; on {card}")
    out["times"] = time_shard(eng, seen["batches"], index, cfg, card)
    out["merge"] = merge_times(single, torch.from_numpy(lens_kept).to(
        dindex.device), cfg, card)
    return out


def _time_shape(kernel, plain, sets: int, bound) -> dict:
    """One kernel shape beside its plain version, in the order plain,
    kernel, kernel, plain: as called (CUDA events over the input sets),
    on the device alone (CUDA-graph replay over the sets), the plain
    version's busy time (torch.profiler, on set 0; `plain_source` names
    the instrument), and the mean bound of bound(i) over the sets."""
    idxs = range(sets)
    p1, k1 = called_ms(plain, idxs), called_ms(kernel, idxs)
    k2, p2 = called_ms(kernel, idxs), called_ms(plain, idxs)
    gp1 = busy_ms(lambda: plain(0))
    gk1, gk2 = graph_ms(kernel, idxs), graph_ms(kernel, idxs)
    gp2 = busy_ms(lambda: plain(0))
    gp, p_src = min(gp1, gp2)
    bounds = [bound(i) for i in idxs]
    return dict(sets=sets, called_ms=min(k1, k2),
                plain_called_ms=min(p1, p2), ms=min(gk1, gk2), plain_ms=gp,
                plain_source=p_src,
                bytes=sum(b["bytes"] for b in bounds) / sets,
                ops=sum(b["ops"] for b in bounds) / sets,
                bound_ms=sum(b["bound_ms"] for b in bounds) / sets,
                bound_by=bounds[0]["bound_by"])


def _log_shape(name: str, rec: dict, card: str, extra: str = "") -> None:
    log(f"{name} ({rec['sets']} input sets): device alone {rec['ms']:.5f} "
        f"ms (graph) vs plain {rec['plain_ms']:.5f} ms "
        f"({rec['plain_source']} busy); as called {rec['called_ms']:.5f} ms "
        f"vs plain {rec['plain_called_ms']:.5f} ms; bound "
        f"{rec['bound_ms']:.6f} ms by {rec['bound_by']} "
        f"({rec['bytes']:,.0f} bytes, {rec['ops']:,.0f} int32 operations), "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it{extra}; on {card}")


def records_bound(n: int, cfg, exact: bool, slots: bool = False,
                  rows: int | None = None) -> dict:
    """The least time the card could take for one shard's records of n
    anchors (or slots): bytes, each read once (the anchors' codes, the
    rows they look up, meta, the slots) and the records written; int32
    operations as the single-table kernels', a looked-up anchor or
    variant. The rows: `rows` 32-byte rows (owned_rows: those of the keys
    the shard owns), or by default every key's, four an anchor for the
    probe and two a canonical variant for the enumeration, as a shard
    that looks up every key fetches them."""
    from find_circ2_tpu_torch.ops.anchor_align import (CLASSIC_FIELDS,
                                                       EXACT_FIELDS)
    a = cfg.anchor_len
    V = 1 + 3 * a
    if rows is None:
        rows = n * (4 if exact else 2 * V)
    if exact:
        nbytes, ops = n * (a + 4 * EXACT_FIELDS), \
            EXACT_OPS_PER_ANCHOR * rows // 4
    else:
        nbytes, ops = n * (a + 4 * CLASSIC_FIELDS), \
            CLASSIC_OPS_PER_VARIANT * rows // 2
    return _bound(nbytes + 32 * rows + 4 * 3 + (8 * n if slots else 0), ops)


def owned_rows(anchors, cfg, owns, variants: bool) -> int:
    """The 32-byte rows a shard's records fetch for `anchors` when it
    looks up only the keys of `owns` (None: every key): four an anchor
    whose canonical exact key it owns (both probes of the table and of
    the neighbour table), or two a canonical variant it owns."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    if variants:
        p12, s8, p12r, s8r, _ = ta.enumerate_variants(anchors, cfg)
        cp = ta._canonical((p12, s8), (p12r, s8r))[1]
        return 2 * int(ta._owned(cp, owns).sum())
    return 4 * int(ta._owned(ta._exact_keys(anchors, cfg)[2], owns).sum())


def table_row_rate(table, what: str, card: str) -> float:
    """Random rows a second, device alone (graph_ms), that gather_rows
    moves from `table` at 2^20 rows a call, over enough index sets that
    their rows exceed the L2 four times: row_rate's measure, on a shard's
    own table instead of a 2^24-row random one."""
    import torch
    from find_circ2_tpu_torch.ops import gather_rows as gr
    n = 1 << 20
    sets = -(-4 * L2_BYTES // (n * 4 * table.shape[1]))
    g = torch.Generator(device=table.device).manual_seed(3)
    idxs = [torch.randint(0, table.shape[0], (n,), device=table.device,
                          generator=g) for _ in range(sets)]
    got = gr.gather_rows(table, idxs[0])
    torch.cuda.synchronize()
    if not torch.equal(got, gr.gather_rows_ref(table, idxs[0])):
        fail(f"gather_rows differs from index_select on {what}")
    ms = min(graph_ms(lambda i: gr.gather_rows(table, i), idxs)
             for _ in range(2))
    rate = n / (ms / 1e3)
    log(f"gather_rows on {what} ({table.shape[0]:,} rows of "
        f"{4 * table.shape[1]} bytes): {n:,} random rows in {ms:.5f} ms "
        f"device alone, {rate / 1e9:.3f} G rows/s ({sets} index sets; "
        f"exact match); on {card}")
    return rate


# The record kernels' shapes at the 2x2 engine's data row, each a shard:
# the probe's records, the fallback slice's (slot mode) and the redo's.
RECORD_SHAPES = ("exact_records", "slot_records", "redo_records")


def _record_inputs(sh, batches, eng, cfg) -> tuple:
    """Per stream batch, the first data row's anchors (both anchors of its
    B / 2 reads), the probe's records over the row's shards `sh`, their
    finish's hits and fallback slice (the compaction of `resolved`, both
    by the plain finish), and
    the slice's and the redo's classic records over `sh`."""
    import torch
    from find_circ2_tpu_torch.ops import anchor_align as ta
    sets, exact, hits, idx, slot, full = [], [], [], [], [], []
    for arr, lens in batches:
        _, reads, lens_t = eng._split(arr, lens)[0]
        both = torch.cat(ta.read_anchors(reads, lens_t, cfg))
        k = min(cfg.exact_fallback_slots, both.shape[0])
        e = torch.stack([ta.exact_records(*s[:3], both, cfg, owns=s.owns)
                         for s in sh])
        h, resolved = ta.shard_finish_ref(e, both, cfg)
        i = ta.fallback_slice(resolved, k)[0]
        sets.append(both)
        exact.append(e)
        hits.append(h)
        idx.append(i)
        slot.append(torch.stack([ta.classic_records(
            s.table, s.meta, both, cfg, i, owns=s.owns) for s in sh]))
        full.append(torch.stack([ta.classic_records(
            s.table, s.meta, both, cfg, owns=s.owns) for s in sh]))
    return sets, exact, hits, idx, slot, full


def _record_kernels(shard, sets, idx, cfg) -> dict:
    """RECORD_SHAPES on one shard, each (kernel(i), plain(i), the
    anchors of set i, slot mode) over the input sets."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    t, nt, m, o = shard
    return {
        "exact_records": (
            lambda i: ta.exact_records(t, nt, m, sets[i], cfg, owns=o),
            lambda i: ta.exact_records_ref(t, nt, m, sets[i], cfg, o),
            lambda i: sets[i], False),
        "slot_records": (
            lambda i: ta.classic_records(t, m, sets[i], cfg, idx[i],
                                         owns=o),
            lambda i: ta.classic_records_ref(t, m, sets[i], cfg, idx[i], o),
            lambda i: sets[i][idx[i]], True),
        "redo_records": (
            lambda i: ta.classic_records(t, m, sets[i], cfg, owns=o),
            lambda i: ta.classic_records_ref(t, m, sets[i], cfg, owns=o),
            lambda i: sets[i], False)}


def _owned_bounds(name: str, anchors, slots: bool, owns, cfg,
                  rate: float) -> dict:
    """A record shape's bound at the rows its shard owns, counted from
    the data (owned_rows), the bound at every key's rows, and the
    random-row floor: the owned rows at the shard table's rate."""
    exact = name == "exact_records"
    rows = owned_rows(anchors, cfg, owns, not exact)
    n = anchors.shape[0]
    rec = records_bound(n, cfg, exact, slots, rows)
    rec.update(rows=rows,
               all_rows_bound_ms=records_bound(n, cfg, exact,
                                               slots)["bound_ms"],
               row_floor_ms=1e3 * rows / rate)
    return rec


# The combining shapes on shard 0 of the 2x2 engine's data row, each
# with the record shape whose lookups it makes.
COMBINE_SHAPES = {"exact_combine": "exact_records",
                  "slot_combine": "slot_records",
                  "redo_combine": "redo_records"}


def _combine_bounds(name: str, anchors, slots: bool, owns, cfg,
                    rate: float, shards: int) -> dict:
    """A combining shape's bound: its record shape's at the rows the shard
    owns (_owned_bounds), with the other shards' records read once and
    the hits (and `resolved`) written in place of its own records, and
    the finish's int32 operations (FINISH_OPS_PER_RECORD a record folded,
    FINISH_OPS_PER_ANCHOR a row)."""
    from find_circ2_tpu_torch.ops.anchor_align import (CLASSIC_FIELDS,
                                                       EXACT_FIELDS)
    rec = _owned_bounds(COMBINE_SHAPES[name], anchors, slots, owns, cfg,
                        rate)
    exact = name == "exact_combine"
    F = EXACT_FIELDS if exact else CLASSIC_FIELDS
    n = anchors.shape[0]
    nbytes = (rec["bytes"] + 4 * F * (shards - 2) * n
              + n * (1 + 8 + 5 * 4 + (1 if exact else 0)))
    ops = (rec["ops"] + FINISH_OPS_PER_RECORD * (shards - 1) * n
           + FINISH_OPS_PER_ANCHOR * n)
    rec.update(_bound(nbytes, ops))
    return rec


def _combine_kernels(sh, sets, idx, hits, exact, slot, full, cfg) -> dict:
    """COMBINE_SHAPES on shard 0 of `sh`, the other shards' records of
    each input set folded in as the engine folds them: each (kernel(i),
    plain(i), the anchors of set i, slot mode)."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    t, nt, m, o = sh[0]
    return {
        "exact_combine": (
            lambda i: ta.exact_combine(t, nt, m, sets[i], cfg, exact[i][1:],
                                       o),
            lambda i: ta.exact_combine_ref(t, nt, m, sets[i], cfg,
                                           exact[i][1:], o),
            lambda i: sets[i], False),
        "slot_combine": (
            lambda i: ta.classic_combine(t, m, sets[i], cfg, slot[i][1:],
                                         idx[i], hits[i], o),
            lambda i: ta.classic_combine_ref(t, m, sets[i], cfg, slot[i][1:],
                                             idx[i], hits[i], o),
            lambda i: sets[i][idx[i]], True),
        "redo_combine": (
            lambda i: ta.classic_combine(t, m, sets[i], cfg, full[i][1:],
                                         owns=o),
            lambda i: ta.classic_combine_ref(t, m, sets[i], cfg, full[i][1:],
                                             owns=o),
            lambda i: sets[i], False)}


def _phases(sh, sets, idx, hits, cfg) -> dict:
    """Each phase of a data row as the engine runs it (ops/anchor_align
    `*_sharded`: the other shards' records and one combining launch): the
    probe, the fallback slice at the compaction's slots into the probe's
    hits, the redo."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    return {
        "probe": lambda i: ta.exact_anchor_stats_sharded(sh, sets[i], cfg),
        "slice": lambda i: ta.refill_slice_sharded(sh, sets[i], idx[i],
                                                   hits[i], cfg),
        "redo": lambda i: ta.align_anchors_sharded(sh, sets[i], cfg)}


def _log_records(name: str, rec: dict, card: str) -> None:
    _log_shape(name, rec, card, f"; every key {rec['every_key_ms']:.5f} "
               f"ms; {rec['rows']:,.0f} rows owned, "
               f"bound at every key's rows {rec['all_rows_bound_ms']:.6f} "
               f"ms, random-row floor {rec['row_floor_ms']:.6f} ms")


def shard_stages(sh, sets, idx, cfg, card: str, combined=None) -> dict:
    """Where the record kernels' warps spend their time on each shard of
    the data row, looking up every key and only the keys the
    shard owns: the measurement builds (ops/anchor_align
    exact_stage_cycles, classic_stage_cycles with `records`) on the first
    input set, each held against its plain version, and per stage the
    median, 90th percentile and maximum of the SM cycles over the warps.
    With `combined` (the probe's hits, the probe's, the slice's and the
    redo's records of each set over `sh`), also the combining modes on
    shard 0 (`others`: the other shards' records of the first set), whose
    row round trip ends when those records have arrived too."""
    from find_circ2_tpu_torch.ops import anchor_align as ta
    out = {}
    if combined is not None:
        hits, exact, slot, full = combined
        t, nt, m, o = sh[0]
        fresh = [ta.AnchorHits(*(x.clone() for x in hits[0]))
                 for _ in range(2)]
        runs = {
            "exact_combine": (
                lambda: ta.exact_stage_cycles(t, nt, m, sets[0], cfg,
                                              owns=o, others=exact[0][1:]),
                lambda: ta.exact_combine_ref(t, nt, m, sets[0], cfg,
                                             exact[0][1:], o),
                ta.EXACT_STAGES),
            "slot_combine": (
                lambda: ta.classic_stage_cycles(
                    t, m, sets[0], cfg, slots=idx[0], hits=fresh[0], owns=o,
                    others=slot[0][1:]),
                lambda: ta.classic_combine_ref(t, m, sets[0], cfg,
                                               slot[0][1:], idx[0], fresh[1],
                                               o),
                ta.CLASSIC_STAGES[:4]),
            "redo_combine": (
                lambda: ta.classic_stage_cycles(t, m, sets[0], cfg, owns=o,
                                                others=full[0][1:]),
                lambda: ta.classic_combine_ref(t, m, sets[0], cfg,
                                               full[0][1:], owns=o),
                ta.CLASSIC_STAGES[:4])}
        for name, (stamped, plain, stages) in runs.items():
            got, cyc = stamped()
            if not _equal_all(got, plain()):
                fail(f"the stamped {name} kernel differs from its plain "
                     f"version on index shard 0")
            q = _quantiles(cyc[:, :len(stages)], stages)
            out[f"{name}/0/own keys"] = q
            log(f"{name} stages on index shard 0 of {len(sh)}, own keys, "
                f"the other shards' records folded in, SM clock cycles a "
                f"warp (median / p90 / max): "
                + "; ".join(f"{k} {m_:.0f} / {p:.0f} / {x:.0f}"
                            for k, (m_, p, x) in q.items())
                + f"; on {card}")
    for i, s in enumerate(sh):
        for mode, owns in (("every key", None), ("own keys", s.owns)):
            runs = {
                "exact_records": (
                    lambda: ta.exact_stage_cycles(
                        *s[:3], sets[0], cfg, records=True, owns=owns),
                    lambda: ta.exact_records_ref(*s[:3], sets[0], cfg, owns),
                    ta.EXACT_STAGES),
                "slot_records": (
                    lambda: ta.classic_stage_cycles(
                        s.table, s.meta, sets[0], cfg, slots=idx[0],
                        records=True, owns=owns),
                    lambda: ta.classic_records_ref(s.table, s.meta, sets[0],
                                                   cfg, idx[0], owns),
                    ta.CLASSIC_STAGES[:4]),
                "redo_records": (
                    lambda: ta.classic_stage_cycles(
                        s.table, s.meta, sets[0], cfg, records=True,
                        owns=owns),
                    lambda: ta.classic_records_ref(s.table, s.meta, sets[0],
                                                   cfg, owns=owns),
                    ta.CLASSIC_STAGES[:4])}
            for name, (stamped, plain, stages) in runs.items():
                got, cyc = stamped()
                if not _equal_all(got, plain()):
                    fail(f"the stamped {name} kernel differs from its plain "
                         f"version on shard {i} ({mode})")
                q = _quantiles(cyc[:, :len(stages)], stages)
                out[f"{name}/{i}/{mode}"] = q
                log(f"{name} stages on index shard {i} of {len(sh)}, "
                    f"{mode}, SM clock cycles a warp (median / p90 / max): "
                    + "; ".join(f"{k} {m:.0f} / {p:.0f} / {x:.0f}"
                                for k, (m, p, x) in q.items())
                    + f"; on {card}")
    return out


def time_shard(eng, batches, index, cfg, card: str) -> dict:
    """The sharded K1's kernels at the 2x2 engine's shapes, on the first
    data row of each stream batch (both anchors of its B / 2 reads): each
    with _time_shape beside its plain version and bound. Shapes: on each
    of the row's index shards, the probe's records (exact_records), the
    fallback slice's records (classic_records in slot mode, on the
    compaction of the finish's `resolved`) and the redo's (classic,
    every anchor), each beside its bound at the rows the shard owns, the
    bound at every key's rows and the random-row floor at the rate
    gather_rows reaches on that shard's table, and timed also looking up
    every key (`every_key_ms`); each shape's sum over the row's shards
    (`*_row`); shard 0's combining launches (COMBINE_SHAPES: its lookups
    with shard 1's records folded in and the finish, as the engine runs
    them) beside their plain versions and bounds; and each phase of the
    row device alone as the engine runs it (records on shard 1, shard
    0's combining launch; `phases`), held against the plain versions.
    Shard 0's shapes keep their names. Then the stage clocks (shard_stages, the
    combining modes' too) and the records on 4 shards carved from the
    same index (time_four_shards)."""
    import torch
    from find_circ2_tpu_torch.ops import anchor_align as ta
    sh = eng.rows[0].shards
    sets, exact, hits, idx, slot, full = _record_inputs(sh, batches, eng,
                                                        cfg)
    n, S = sets[0].shape[0], len(sh)
    k = idx[0].shape[0]
    E, C = ta.EXACT_FIELDS, ta.CLASSIC_FIELDS
    rates = [table_row_rate(s.table, f"index shard {i} of the 2x2 engine",
                            card) for i, s in enumerate(sh)]
    out = {"rates": rates}
    keys = ("ms", "every_key_ms", "plain_ms", "called_ms", "plain_called_ms",
            "bound_ms", "all_rows_bound_ms", "row_floor_ms", "rows")
    for i, s in enumerate(sh):
        every = _record_kernels(s._replace(owns=None), sets, idx, cfg)
        for name, (kernel, plain, of, slots) in _record_kernels(
                s, sets, idx, cfg).items():
            got = f"{name}_{i}" if i else name
            bounds = [_owned_bounds(name, of(j), slots, s.owns, cfg,
                                    rates[i]) for j in range(len(sets))]
            # The same kernel looking up every key, before and after the
            # shard's own keys, on the same inputs.
            e1 = graph_ms(every[name][0], range(len(sets)))
            rec = _time_shape(kernel, plain, len(sets), bounds.__getitem__)
            rec["every_key_ms"] = min(e1, graph_ms(every[name][0],
                                                   range(len(sets))))
            for key in ("rows", "all_rows_bound_ms", "row_floor_ms"):
                rec[key] = sum(b[key] for b in bounds) / len(sets)
            out[got] = rec
            _log_records(f"sharded {name} on index shard {i} of {S} ({n} "
                         f"anchors of a data row, {k} slots)", rec, card)
    for name in RECORD_SHAPES:
        recs = [out[name]] + [out[f"{name}_{i}"] for i in range(1, S)]
        row = {key: sum(r[key] for r in recs) for key in keys}
        row.update(sets=len(sets), bound_by=recs[0]["bound_by"])
        out[f"{name}_row"] = row
        log(f"sharded {name}, the {S} shards of a data row summed: device "
            f"alone {row['ms']:.5f} ms (" + " + ".join(
                f"{r['ms']:.5f}" for r in recs) + f"; every key "
            f"{row['every_key_ms']:.5f} ms: " + " + ".join(
                f"{r['every_key_ms']:.5f}" for r in recs) + f") vs plain "
            f"{row['plain_ms']:.5f} ms; as called {row['called_ms']:.5f} "
            f"ms; bound at the owned rows {row['bound_ms']:.6f} ms, at "
            f"every key's {row['all_rows_bound_ms']:.6f} ms, random-row "
            f"floor {row['row_floor_ms']:.6f} ms ({row['rows']:,.0f} rows); "
            f"on {card}")
    for name, (kernel, plain, of, slots) in _combine_kernels(
            sh, sets, idx, hits, exact, slot, full, cfg).items():
        bounds = [_combine_bounds(name, of(j), slots, sh[0].owns, cfg,
                                  rates[0], S) for j in range(len(sets))]
        rec = _time_shape(kernel, plain, len(sets), bounds.__getitem__)
        for key in ("rows", "all_rows_bound_ms", "row_floor_ms"):
            rec[key] = sum(b[key] for b in bounds) / len(sets)
        out[name] = rec
        _log_shape(f"sharded {name} on index shard 0 of {S}, the other "
                   f"shards' records folded in ({n} anchors of a data row, "
                   f"{k} slots)", rec, card,
                   f"; {rec['rows']:,.0f} rows owned, random-row floor "
                   f"{rec['row_floor_ms']:.6f} ms")
    # Each phase on the first set, the slice into its own copy of the
    # probe's hits, against its plain parts, then timed over every set.
    phases = {}
    fresh = [[ta.AnchorHits(*(x.clone() for x in hits[0]))] for _ in "ab"]
    once = _phases(sh, sets[:1], idx[:1], fresh[0], cfg)
    with plain_shard():
        plain = _phases(sh, sets[:1], idx[:1], fresh[1], cfg)
        want = {phase: run(0) for phase, run in plain.items()}
    for (phase, run), (name, rec) in zip(
            _phases(sh, sets, idx, hits, cfg).items(),
            COMBINE_SHAPES.items()):
        if not _equal_all(once[phase](0), want[phase]):
            fail(f"the sharded {phase} as the engine runs it differs from "
                 f"its plain parts")
        idxs = range(len(sets))
        runs = [graph_ms(run, idxs) for _ in range(2)]
        others = [f"{rec}_{i}" for i in range(1, S)]
        got = dict(ms=min(runs), runs=runs,
                   bound_ms=out[name]["bound_ms"] + sum(
                       out[o]["bound_ms"] for o in others),
                   kernels_ms=out[name]["ms"] + sum(out[o]["ms"]
                                                    for o in others))
        phases[phase] = got
        log(f"sharded {phase} of a data row ({S} shards, {n} anchors, {k} "
            f"slots), device alone (graph, {len(sets)} input sets), as the "
            f"engine runs it (records on the other shards, shard 0's "
            f"combining launch): {got['ms']:.5f} ms (runs " + ", ".join(
                f"{x:.5f}" for x in runs) + f"); the kernels alone summed "
            f"{got['kernels_ms']:.5f} ms; bound {got['bound_ms']:.6f} ms; "
            f"on {card}")
    out["phases"] = phases
    out["stages"] = shard_stages(sh, sets, idx, cfg, card,
                                 (hits, exact, slot, full))
    out["four"] = time_four_shards(index, sets, idx, cfg, card)
    return out


def time_four_shards(index, sets, idx, cfg, card: str) -> dict:
    """The record kernels on 4 index shards carved from the 2x2 engine's
    index (shard_query_table, then shard_neighbor_tables relocating its
    neighbour table; seconds of each), on the same anchors and slices:
    each shard's RECORD_SHAPES held against the plain version on the
    first set and timed device alone (graph_ms) beside its bounds and its
    random-row floor (the rate on its table), and each shape's sum over
    the 4 shards."""
    import torch
    from find_circ2_tpu_torch.index.hashtable import (shard_neighbor_tables,
                                                      shard_query_table)
    from find_circ2_tpu_torch.utils import detect_cases
    t0 = time.perf_counter()
    tables, metas = shard_query_table(index, 4, cfg)
    carve = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntables = shard_neighbor_tables(index.qtable, tables)
    relocate = time.perf_counter() - t0
    dev = sets[0].device
    sh = detect_cases.shard_args(tables, ntables, metas, [dev] * 4, cfg)
    del tables, ntables
    log(f"4 index shards carved from the filter stack's table in "
        f"{carve:.3f} s, its neighbour table relocated in {relocate:.3f} s, "
        f"on the host; shard table rows {sh[0].table.shape[0]:,}; on {card}")
    out = {"carve_s": carve, "relocate_s": relocate, "shards": []}
    for i, s in enumerate(sh):
        rate = table_row_rate(s.table, f"index shard {i} of 4", card)
        got = {"rate": rate}
        every = _record_kernels(s._replace(owns=None), sets, idx, cfg)
        for name, (kernel, plain, of, slots) in _record_kernels(
                s, sets, idx, cfg).items():
            if not torch.equal(kernel(0), plain(0)):
                fail(f"{name} differs from its plain version on index shard "
                     f"{i} of 4")
            rec = dict(ms=graph_ms(kernel, range(len(sets))),
                       every_key_ms=graph_ms(every[name][0],
                                             range(len(sets))))
            bounds = [_owned_bounds(name, of(j), slots, s.owns, cfg, rate)
                      for j in range(len(sets))]
            for key in ("bound_ms", "rows", "all_rows_bound_ms",
                        "row_floor_ms"):
                rec[key] = sum(b[key] for b in bounds) / len(sets)
            got[name] = rec
            log(f"{name} on index shard {i} of 4 ({len(sets)} input sets): "
                f"device alone {rec['ms']:.5f} ms (graph), every key "
                f"{rec['every_key_ms']:.5f} ms; bound at the "
                f"owned rows {rec['bound_ms']:.6f} ms ({rec['rows']:,.0f} "
                f"rows), at every key's {rec['all_rows_bound_ms']:.6f} ms, "
                f"random-row floor {rec['row_floor_ms']:.6f} ms; exact "
                f"match; on {card}")
        out["shards"].append(got)
    for name in RECORD_SHAPES:
        recs = [g[name] for g in out["shards"]]
        out[f"{name}_row"] = {key: sum(r[key] for r in recs)
                              for key in recs[0]}
        r = out[f"{name}_row"]
        log(f"{name}, the 4 shards of a data row summed: device alone "
            f"{r['ms']:.5f} ms (" + " + ".join(f"{x['ms']:.5f}" for x in recs)
            + f"), every key {r['every_key_ms']:.5f} ms; bound at the owned "
            f"rows {r['bound_ms']:.6f} ms, random-"
            f"row floor {r['row_floor_ms']:.6f} ms; on {card}")
    del sh
    torch.cuda.empty_cache()
    return out


def merge_times(res, lens, cfg, card: str) -> dict:
    """K-h on one stream batch's single-device detect result: the kernels
    (csrc/merge.cu) beside the plain merge (plain_merge) with
    _time_shape, at the 2x2 engine's shapes, merge_junctions on a data
    row's B / 2 rows and merge_tables of two such tables (B rows); at the
    whole batch's B rows; and merge_tables of eight tables (4 B rows).
    The bound: each field read once and each written once over the HBM
    rate, or N log2 N key comparisons (MERGE_OPS_PER_COMPARE each, what
    a comparison sort needs) and MERGE_OPS_PER_ROW a row over the int32
    rate. Then the SM cycles of each stage at B / 2 rows (merge_stages)
    and, as a yardstick of one library sort pass of one key, one stable
    torch.argsort of B / 2 and of 4 B random int64 on the device alone
    (CUDA-graph replay); the port never calls it."""
    import math
    import torch
    from find_circ2_tpu_torch.ops.merge import merge_junctions, merge_tables

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    read = ("status", "multi", "qual_left", "qual_right", "kind", "chrom",
            "start", "end", "sense", "align_strand", "edits", "overlap",
            "n_bp")
    B = lens.shape[0]
    half = ({k: v[:B // 2].contiguous() for k, v in res.items()},
            lens[:B // 2].contiguous())
    row = merge_junctions(*half, cfg)

    def stack(K):
        return {k: torch.stack([v] * K) for k, v in row.items()}

    def bound(N, moved):
        return _bound(moved, N * math.ceil(math.log2(max(N, 2)))
                      * MERGE_OPS_PER_COMPARE + N * MERGE_OPS_PER_ROW)

    def junctions(r, ln):
        moved = nbytes([r[k] for k in read if k in r] + [ln]) + nbytes(
            merge_junctions(r, ln, cfg).values())
        return (lambda i: merge_junctions(r, ln, cfg),
                bound(ln.shape[0], moved))

    def tables(K):
        t = stack(K)
        moved = nbytes(t.values()) + nbytes(merge_tables(t).values())
        return lambda i: merge_tables(t), bound(K * B // 2, moved)

    shapes = {f"merge_junctions_{B // 2}": junctions(*half),
              f"merge_tables_{B}": tables(2),
              f"merge_junctions_{B}": junctions(res, lens),
              f"merge_tables_{4 * B}": tables(8)}
    out = {"main": {f"merge_junctions_{B // 2}": 2,
                    f"merge_tables_{B}": 1}}
    for name, (fn, b) in shapes.items():
        def plain(i, fn=fn):
            with plain_merge():
                return fn(i)
        out[name] = _time_shape(fn, plain, 3, lambda i, b=b: b)
        _log_shape(f"K-h {name}", out[name], card)
    out["stages"] = merge_stages(*half, cfg, f"a data row's {B // 2} rows",
                                 card)
    g = torch.Generator(device=lens.device).manual_seed(3)
    out["argsort_ms"] = {}
    for N in (B // 2, 4 * B):
        x = torch.randint(0, 2 ** 62, (N,), dtype=torch.int64,
                          device=lens.device, generator=g)

        def sort(i, x=x):
            return torch.argsort(x, stable=True)
        out["argsort_ms"][str(N)] = min(graph_ms(sort, range(3)),
                                        graph_ms(sort, range(3)))
    log("one stable torch.argsort of random int64 on the device alone "
        "(K-h's yardstick, not used by the port): " + "; ".join(
            f"{N} rows {ms:.5f} ms" for N, ms in out["argsort_ms"].items())
        + f"; on {card}")
    return out


def merge_stages(res, lens, cfg, what: str, card: str) -> dict:
    """Where K-h spends its time: the measurement build of csrc/merge.cu
    (ops/merge.merge_stage_cycles), its table held against the plain
    merge's, and per stage the median, 90th percentile and maximum of the
    SM clock cycles over the tiles."""
    import torch
    from find_circ2_tpu_torch.ops import merge as tm
    got, cyc = tm.merge_stage_cycles(res, lens, cfg)
    want = tm.merge_junctions_ref(res, lens, cfg)
    if not all(torch.equal(got[k], want[k]) for k in tm.ALL_FIELDS):
        fail(f"the stamped merge differs from the plain merge on {what}")
    out = _quantiles(cyc, tm.STAGES)
    log(f"merge stages on {what}, SM clock cycles a tile ({tm.TILE_ROWS} "
        f"rows a tile; median / p90 / max): " + "; ".join(
            f"{k} {m:.0f} / {p:.0f} / {x:.0f}"
            for k, (m, p, x) in out.items()) + f"; on {card}")
    return out


def main_path(device: str, library: dict, card: str,
              row_rate: float | None = None) -> dict:
    """`run --filter` on the simulated library (phase 5), then §2b
    explore on the card, the two explore modes of run_fastq, and
    run_reads vs the oracle on its first ORACLE_READS reads (phase 6).
    Returns the numbers of the kernel table."""
    import numpy as np
    import torch
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.io.bed import read_bed
    from find_circ2_tpu_torch.io.fasta import write_fasta
    from find_circ2_tpu_torch.io.twobit import codes_to_seq
    from find_circ2_tpu_torch.models.oracle import call_read
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    from find_circ2_tpu_torch.utils.simulate import rnase_r_library
    from find_circ2_tpu_torch.cli import main as cli
    from find_circ2_tpu_torch.models.stream import run_reads
    from find_circ2_tpu_torch.ops import anchor_align as ta
    from find_circ2_tpu_torch.ops import detect as td
    from find_circ2_tpu_torch.ops import explore as tx
    from find_circ2_tpu_torch.ops import gather_rows as gr

    cfg = Config()
    on_card = torch.device(device).type == "cuda"
    sim = rnase_r_library(cfg=cfg, **library)
    g = sim.genome
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "genome.fa")
        fq = os.path.join(tmp, "reads.fastq")
        write_fasta(fa, [(name, codes_to_seq(
            g.codes[g.chrom_offsets[i]:g.chrom_offsets[i]
                    + g.chrom_lengths[i]]))
            for i, name in enumerate(g.chrom_names)])
        with open(fq, "wt") as fh:
            for name, seq in sim.reads:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
        outdir = os.path.join(tmp, "out")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        err = io.StringIO()
        with contextlib.redirect_stderr(err), watch_explorer() as seen, \
                watch_detect() as batches:
            gr.launches = gr.multi_launches = tx.launches = 0
            td.launches = ta.exact_launches = 0
            ta.classic_launches = ta.compact_launches = 0
            rc = cli.main(["run", fq, "-G", fa, "-o", outdir, "--filter",
                           "--device", device, "--profile"])
            out["launches"] = {"gather_rows": gr.launches,
                               "gather_rows_multi": gr.multi_launches,
                               "explore_pairs": tx.launches,
                               "detect_core_packed": td.launches,
                               "exact_anchor_stats": ta.exact_launches,
                               "classic_anchor_stats": ta.classic_launches,
                               "fallback_slice": ta.compact_launches}
        out["explore_launches"] = seen["launches"]
        report = err.getvalue()
        print(report, end="")
        if rc != 0:
            fail(f"run exited {rc}")
        filt = list(read_bed(os.path.join(outdir, "circ_candidates.bed")))
        setup_s = _profile_value(report, "setup")
        stream_s = _profile_value(report, "wall")
        n_reads = len(sim.reads)
        log(f"main path: {n_reads} reads, setup {setup_s:.3f} s, stream "
            f"{stream_s:.3f} s -> {n_reads / stream_s:,.1f} reads/s on "
            f"{card}")
        if on_card:
            log(f"peak device memory {torch.cuda.max_memory_allocated():,} "
                "bytes (explore on)")
        launched = out["launches"]
        log(f"kernel launches on the main path: " + ", ".join(
            f"{k} {v}" for k, v in launched.items())
            + f" ({out['explore_launches']} classic_anchor_stats launches "
            f"inside §2b explore); {seen['reads']} routed reads in "
            f"{seen['calls']} explore dispatches, {seen['chunks']} chunks; "
            f"{len(batches['batches'])} detect batches, "
            f"{batches['fast']} exact-first and {batches['classic']} "
            f"classic (overflow redo)")
        # K1's kernels fetch their own rows: the row gather is off the
        # single device's main path (phase 7 launches it on every shard).
        off_path = ("gather_rows", "gather_rows_multi")
        for name, count in launched.items():
            if name in off_path and count and on_card:
                fail(f"kernel {name} was launched {count} times on the "
                     "single device's main path")
            if name not in off_path and count <= 0:
                fail(f"kernel {name} was not launched on the main path")
        if on_card and (
                launched["detect_core_packed"]
                != batches["fast"] + batches["classic"]
                or launched["exact_anchor_stats"] != batches["fast"]
                or launched["fallback_slice"] != batches["fast"]
                or launched["classic_anchor_stats"]
                != batches["fast"] + batches["classic"] + seen["chunks"]
                or batches["fast"] != len(batches["batches"])):
            fail("the detect kernels' launches do not match the detect "
                 "programs run: one core launch per program, one probe, "
                 "one compaction and one enumeration (the slice) per "
                 "exact-first program, one enumeration per classic "
                 "program and per explore chunk")
        if on_card and (launched["explore_pairs"] != seen["chunks"]
                        or out["explore_launches"] != seen["chunks"]):
            fail(f"explore_pairs launched {launched['explore_pairs']} and "
                 f"explore's K1 {out['explore_launches']} times for "
                 f"{seen['chunks']} explore chunks")
        if seen["reads"] <= 0 or out["explore_launches"] <= 0:
            fail("§2b explore routed no reads or launched no K1 "
                 "enumeration on the main path")
        dispatched = _stage(report, "explore_dispatch")
        if (dispatched is None or dispatched[1] != seen["calls"]
                or _stage(report, "slowpath_multihit")):
            fail("the main path did not run §2b explore on the device "
                 "(explore_dispatch missing or miscounted, or "
                 "slowpath_multihit present)")
        # Precision and recall as bench.py's filter-stack measure them.
        truth = {(t.chrom, t.start, t.end) for t in sim.truths
                 if t.kind == "circular" and len(t.reads) >= cfg.min_support}
        prec, rec = _precision_recall(filt, truth)
        log(f"filtered calls: {len(filt)}, precision {prec:.4f}, recall "
            f"{rec:.4f} vs {len(truth)} planted circles")
        if (round(prec, 4), round(rec, 4)) != (EXPECT_PRECISION,
                                               EXPECT_RECALL):
            fail(f"precision {prec:.4f} / recall {rec:.4f}, the reference "
                 f"gives {EXPECT_PRECISION} / {EXPECT_RECALL}")

        # Phase 6 on the main path's own index and routed reads.
        dindex = seen["dindex"]
        g, index = seen["slowpath"]
        out["explore"] = check_explore(
            dindex, np.concatenate(seen["arr"]), np.concatenate(seen["lens"]),
            cfg, card)
        out["detect"] = check_detect(dindex, batches["batches"], g, cfg,
                                     card, row_rate)
        out["classic"] = time_classic(
            dindex, out["detect"].pop("anchor_sets"),
            np.concatenate(seen["arr"]), np.concatenate(seen["lens"]), cfg,
            card)
        out["streams"] = compare_streams(dindex, fq, g, index, cfg, card)
        out["detect_streams"] = compare_detect_streams(
            dindex, fq, g, index, cfg, card, out["streams"]["beds"]["device"])
        out["sharded"] = check_sharded(fq, sim, g, index, dindex, cfg,
                                       out["streams"], truth, card)

    # Read-for-read equality with the CPU oracle on a slice.
    reads = sim.reads[:ORACLE_READS]
    times = StageTimes()
    with watch_explorer() as seen:
        calls = run_reads(dindex, reads, cfg, slowpath=(g, index),
                          times=times)
    n_routed = seen["reads"]
    bad = [name for (name, seq), c in zip(reads, calls)
           if c != call_read(g, index, name, seq, cfg)]
    if len(calls) != len(reads) or bad:
        fail(f"run_reads differs from the oracle on {len(bad)} of "
             f"{len(reads)} reads (first: {bad[:3]})")
    if not n_routed or "explore_dispatch" not in times.counts \
            or "slowpath_multihit" in times.counts:
        fail(f"the oracle slice's {n_routed} routed reads did not take "
             f"the device explorer (stages {sorted(times.counts)})")
    log(f"run_reads equals the oracle on {len(reads)} reads, {n_routed} "
        "of them routed to the device explorer")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "find_circ2_tpu_torch")):
        fail("find_circ2_tpu_torch/ not found next to chip_smoke.py; run "
             "from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    card = card_line()
    log(f"card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from find_circ2_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"({_build.library_path()})")

    gather = check_gather_rows("cuda", card)
    cases = check_detect_cases("cuda", card)
    cases.update(check_classic_cases("cuda", card))
    cases.update(check_shard_cases("cuda", card))
    cases.update(check_merge_cases("cuda", card))
    check_golden("cuda")
    path = main_path("cuda", LIBRARY, card, row_rate(gather))
    check_golden("cuda", ("--mesh", "2x2"))
    check_golden_nproc("cuda")

    # Per wrapper, summed over the calls the plain K1 makes for one
    # sharded detect batch on one index shard (K1's kernels fetch their
    # own rows, so no main path launches it any more): "ms"
    # and "plain_ms" on the device alone (CUDA graphs), "called_ms" and
    # "plain_called_ms" as called; "bound_ms" the bytes over the HBM rate.
    # index_select is gather_rows' library call; no one PyTorch call
    # gathers two tables.
    kernels = []
    for name in ("gather_rows", "gather_rows_multi"):
        s = gather[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "find_circ2_tpu_torch/csrc/gather_rows.cu",
            "replaces": "find_circ2_tpu/ops/pallas_k1.py:64",
            "launches": path["launches"][name],
            "max_abs_err": gather["max_abs_err"], "ms": s["device_ms"],
            "plain_ms": s["plain_device_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes",
            "library_ms": (s["plain_device_ms"] if name == "gather_rows"
                           else None),
            "called_ms": s["called_ms"],
            "plain_called_ms": s["plain_called_ms"],
            "sharded_launches": path["sharded"]["launches"][name]})
    # explore_pairs on one 1024-read chunk's K1 outputs; no one PyTorch
    # call computes it.
    x = path["explore"]
    pairs = x["pairs"]
    kernels.append({
        "name": "explore_pairs", "route": "cuda",
        "source": "find_circ2_tpu_torch/csrc/explore.cu",
        "replaces": "find_circ2_tpu/ops/explore.py:147",
        "launches": path["launches"]["explore_pairs"],
        "max_abs_err": x["max_abs_err"], "ms": pairs["ms"],
        "plain_ms": pairs["plain_ms"], "bound_ms": pairs["bound_ms"],
        "bound_by": pairs["bound_by"], "library_ms": None,
        "called_ms": pairs["called_ms"],
        "plain_called_ms": pairs["plain_called_ms"],
        "sharded_launches": path["sharded"]["explore_launches"],
        "bucket_ms": {str(n): b["ms"] for n, b in pairs["buckets"].items()},
        "bucket_called_ms": {str(n): b["called_ms"]
                             for n, b in pairs["buckets"].items()},
        "resources": pairs["resources"],
        "stage_cycles": {str(n): {k: v[0] for k, v in st.items()}
                         for n, st in pairs["stages"].items()}})
    # Detect's two kernels on the stream's 4096-read batches (the probe
    # alone on anchor sets drawn from the genome); no one PyTorch call
    # computes either.
    det = path["detect"]
    for name, key, source, replaces in (
            ("exact_anchor_stats", "exact", "exact_stats.cu",
             "find_circ2_tpu/ops/anchor_align.py:340"),
            ("detect_core_packed", "core", "detect.cu",
             "find_circ2_tpu/models/pipeline.py:427")):
        rec = det[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"find_circ2_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": path["launches"][name],
            "max_abs_err": max(det[f"{key}_err"], cases[f"{key}_err"]),
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "called_ms": rec["called_ms"],
            "plain_called_ms": rec["plain_called_ms"],
            "sharded_launches": path["sharded"]["launches"][name],
            "latency_ms": rec["latency_ms"],
            **({"row_floor_ms": rec["row_floor_ms"]}
               if "row_floor_ms" in rec else {}),
            "stage_cycles": {k: v[0] for k, v in
                             det["stages"][key].items()},
            "latency_stage_cycles": {k: v[0] for k, v in
                                     det["latency_stages"][key].items()}})
    # K1's enumeration, summed over the main path's calls (one detect
    # batch's fallback slice and one explore chunk's K1 with the extras),
    # each shape beside it; the compaction on one batch's `resolved`, its
    # library call one stable torch.argsort. No one PyTorch call computes
    # the enumeration. Each with the median cycles of its stages.
    cl = path["classic"]
    main_shapes = ("fallback", "explore")
    keys = ("ms", "plain_ms", "bound_ms", "called_ms", "plain_called_ms")
    kernels.append({
        "name": "classic_anchor_stats", "route": "cuda",
        "source": "find_circ2_tpu_torch/csrc/classic_k1.cu",
        "replaces": "find_circ2_tpu/ops/anchor_align.py:140",
        "launches": path["launches"]["classic_anchor_stats"],
        "max_abs_err": max(cases["classic_err"], det["classic_err"],
                           x["classic_err"]),
        **{k: sum(cl[s][k] for s in main_shapes) for k in keys},
        "bound_by": ("bytes" if all(cl[s]["bound_by"] == "bytes"
                                    for s in main_shapes) else "operations"),
        "library_ms": None, "explore_launches": path["explore_launches"],
        "sharded_launches":
            path["sharded"]["launches"]["classic_anchor_stats"],
        "shapes": {s: {k: cl[s][k] for k in keys + ("bound_by", "sets")}
                   for s in ("fallback", "redo", "explore")},
        "stage_cycles": {s: {k: v[0] for k, v in cl["stages"][s].items()}
                         for s in main_shapes}})
    kernels.append({
        "name": "fallback_slice", "route": "cuda",
        "source": "find_circ2_tpu_torch/csrc/classic_k1.cu",
        "replaces": "find_circ2_tpu/ops/anchor_align.py:496",
        "launches": path["launches"]["fallback_slice"],
        "max_abs_err": max(cases["classic_err"], det["classic_err"]),
        **{k: cl["compact"][k] for k in keys + ("bound_by", "library_ms")},
        "stage_cycles": {k: v[0] for k, v in cl["stages"]["compact"].items()},
        "sharded_launches": path["sharded"]["launches"]["fallback_slice"]})
    # The sharded engine's kernels (phase 7), each at one call of a 2x2
    # data row's exact-first batch (the probe's and the slice's records on
    # index shard 0; shard 0's combining probe and slice) or summed over
    # one detect_merged batch (a merge a data row, then one of their
    # tables), each shape beside it. No one PyTorch call computes any of
    # them.
    sd = path["sharded"]
    st, mt = sd["times"], sd["merge"]
    # A record kernel's own numbers are index shard 0's; its other shapes
    # add shard 1 (`_1`) and the row's two shards summed (`_row`), each
    # with the time looking up every key, the bound at every key's rows
    # and the random-row floor. A combining kernel's entry carries the
    # phases of a data row it ends, device alone as the engine runs them.
    extra = ("every_key_ms", "all_rows_bound_ms", "row_floor_ms", "rows")
    for name, source, replaces, main, other, err in (
            ("exact_records", "exact_stats.cu",
             "find_circ2_tpu/ops/anchor_align.py:340",
             {"exact_records": 1}, ("exact_records_1", "exact_records_row"),
             "shard_err"),
            ("classic_records", "classic_k1.cu",
             "find_circ2_tpu/ops/anchor_align.py:140",
             {"slot_records": 1}, ("slot_records_1", "slot_records_row",
                                   "redo_records", "redo_records_1",
                                   "redo_records_row"), "shard_err"),
            ("exact_combine", "exact_stats.cu",
             "find_circ2_tpu/ops/anchor_align.py:340",
             {"exact_combine": 1}, (), "shard_err"),
            ("classic_combine", "classic_k1.cu",
             "find_circ2_tpu/ops/anchor_align.py:286",
             {"slot_combine": 1}, ("redo_combine",), "shard_err"),
            ("merge", "merge.cu", "find_circ2_tpu/ops/merge.py:36",
             mt["main"], tuple(k for k in mt if k not in mt["main"]
                               and k.startswith("merge_")), "merge_err")):
        recs = st if name != "merge" else mt
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"find_circ2_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": (sd["merge_launches"] if name == "merge"
                         else sd["launches"][name]),
            "max_abs_err": max(cases[err], sd["shard_err"]),
            **{k: sum(c * recs[s][k] for s, c in main.items())
               for k in keys},
            "bound_by": ("bytes" if all(recs[s]["bound_by"] == "bytes"
                                        for s in main) else "operations"),
            "library_ms": None,
            "shapes": {s: {k: recs[s][k] for k in keys + ("bound_by",
                                                           "sets") + extra
                           if k in recs[s]}
                       for s in (*main, *other)},
            # K-h's `launches` count kernels (merge_kernels(n) a C call:
            # three above one tile); `calls` its C calls; its stage
            # cycles at a data row's rows and its argsort yardstick.
            **({"launches_are": "kernels", "calls": sd["merge_calls"],
                "stage_cycles": {k: v[0] for k, v in mt["stages"].items()},
                "argsort_ms": mt["argsort_ms"]} if name == "merge"
               else {}),
            **({"phases": {p: st["phases"][p] for p in (
                ("probe",) if name == "exact_combine" else ("slice",
                                                            "redo"))}}
               if name.endswith("_combine") else {})})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
