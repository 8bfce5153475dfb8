"""One run of one cell: set-up, the measured window, the traced passes,
the per-layer readers and the comparison with the plain reference.

Everything a cell needs is found by name under the benchmark's root (the
directory that holds BENCHMARK.json): the configuration's file, the
traffic file `portbench/traffic/<traffic>.json`, the cell's file
`portbench/workloads/<name>.json` and one reader per per-layer metric,
`portbench/metrics/<metric>.py`, which defines `read(run)` and returns
the number or None.

A pass is what `find_circ` does after its set-up (cli/find_circ.py):
an Aggregator, `run_fastq` over each of the library's FASTQ files in
turn with §2b on the device and the host re-calls in their forked
worker (a paired-end configuration, `"pe": true`, reverse-complements
every odd-indexed file, mate 2, as `--pe` does), the rows, the
`--filter` stack where the configuration has it, and the BED and stats
written. Passes run back to back until the window's seconds are up; the
one running at the deadline finishes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import inspect
import io
import json
import os
import sys
import tempfile
import time
import types

BENCH_DIR = "portbench"
PROFILE_TRIES = 3
# Passes under the profiler after the window: a steady stretch of two
# whole passes (about 2 s of a 16 Mbp library), long enough for every
# batch shape and short enough to keep the trace's events few.
PROFILE_PASSES = 2
# Worker processes of the plain reference (one a core of the card's host).
REFERENCE_WORKERS = 8
FORBIDDEN = ("jax", "jaxlib", "flax", "find_circ2_tpu")
# The numbers each pass is compared by (portbench/reference/compare.py),
# each with the limit 0: against the reference's bytes, and against the
# plain recount of the table and stats.
PASS_NUMBERS = ("bed_rows_differing", "stats_lines_differing",
                "table_rows_differing", "table_stats_differing")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


class Cell:
    """A cell's entries and files, found by name under `root`."""

    def __init__(self, root: str, name: str) -> None:
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.bench = json.load(fh)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        conf = next(c for c in self.bench["configs"]
                    if c["name"] == self.entry["config"])
        with open(os.path.join(root, conf["file"]), "rb") as fh:
            self.conf_bytes = fh.read()
        self.conf = json.loads(self.conf_bytes)
        self.traffic = self._json("traffic", self.entry["traffic"])
        self.params = self._json("workloads", name)
        for k in ("config", "traffic"):
            if self.params[k] != self.entry[k]:
                raise SystemExit(f"{name}: workload file says {k} "
                                 f"{self.params[k]!r}, BENCHMARK.json "
                                 f"{self.entry[k]!r}")
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.root, BENCH_DIR, kind,
                               f"{name}.json")) as fh:
            return json.load(fh)

    def reader(self, metric: str):
        path = os.path.join(self.root, BENCH_DIR, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def port_config(fc: dict):
    """The port's Config for a configuration's `find_circ` settings, as
    the command line makes it."""
    from find_circ2_tpu_torch.config import Config
    a = int(fc["anchor_len"])
    return Config(anchor_len=a, prefix_len=min(12, a - 8),
                  stranded=bool(fc["stranded"]),
                  batch_size=int(fc["batch_size"]))


class Program:
    """The system under test after its set-up: the device index, the
    host slow path's genome and index, and the pass."""

    def __init__(self, genome, index, dindex, cfg, fc: dict,
                 fastqs: list[str], outdir: str) -> None:
        # find_circ --pe refuses an odd number of files; a configuration
        # and a library that disagree on pairs would run as neither.
        if bool(fc.get("pe", False)) != (len(fastqs) == 2):
            raise SystemExit(f"portbench: a configuration with pe "
                             f"{bool(fc.get('pe', False))} cannot run a "
                             f"library of {len(fastqs)} file(s)")
        self.genome, self.index, self.dindex = genome, index, dindex
        self.cfg, self.fc, self.fastqs = cfg, fc, fastqs
        self.bed_path = os.path.join(outdir, "junctions.bed")
        self.stats_path = os.path.join(outdir, "junctions.stats")

    def one_pass(self, times) -> tuple[str, str]:
        """One library through the program; its BED and stats text."""
        from find_circ2_tpu_torch.io.bed import passes_filter, write_bed
        from find_circ2_tpu_torch.models.aggregate import Aggregator
        from find_circ2_tpu_torch.models.stream import run_fastq
        fc = self.fc
        agg = Aggregator(self.genome, self.cfg)
        for fi, path in enumerate(self.fastqs):
            run_fastq(self.dindex, path, agg, self.cfg, fc["prefilter"],
                      times=times, slowpath=(self.genome, self.index),
                      revcomp=bool(fc.get("pe", False) and fi % 2))
        with times.stage("pass.rows"):
            rows = agg.rows(sample_name=fc["name"], prefix=fc["prefix"])
            if fc["filter"]:
                rows = [r for r in rows
                        if passes_filter(r, fc["max_span"],
                                         fc["min_support"], fc["max_edits"])]
        with times.stage("pass.write"):
            buf = io.StringIO()
            write_bed(buf, rows)
            bed = buf.getvalue()
            stats = "\n".join(agg.stats.lines()) + "\n"
            with open(self.bed_path, "w") as fh:
                fh.write(bed)
            with open(self.stats_path, "w") as fh:
                fh.write(stats)
        return bed, stats


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """obj.name replaced by wrap(original) while the block runs."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def count_routed(counts: dict):
    """Count the reads handed to the §2b explore program
    (DeviceExplorer.dispatch_arrays) under counts["routed"], and its
    calls under counts["dispatches"]."""
    from find_circ2_tpu_torch.models.pipeline import DeviceExplorer

    def wrap(orig):
        sig = inspect.signature(orig)

        def counted(*args, **kw):
            arr = sig.bind(*args, **kw).arguments["arr"]
            counts["routed"] = counts.get("routed", 0) + int(arr.shape[0])
            counts["dispatches"] = counts.get("dispatches", 0) + 1
            return orig(*args, **kw)
        return counted
    with patched(DeviceExplorer, "dispatch_arrays", wrap):
        yield


# The arguments of each captured call that the byte tallies read, by
# parameter name: a call whose signature lacks one fails the traced run.
EXPLORE_ARGS = ("words", "nbases", "chrom_offsets", "reads", "lens",
                "stats_a", "stats_b", "hits_a", "hits_b", "mm_v")


@contextlib.contextmanager
def capture_work(work: dict):
    """Keep what the detect and explore programs are handed while the
    block runs, for the byte tallies: each detect batch's lengths, each
    fallback slice's `resolved` and size, each classic redo's lengths,
    each explore chunk's explore_pairs arguments. Arguments are bound to
    the function's parameter names; tensors are held, not read, so
    nothing waits for the device."""
    from find_circ2_tpu_torch.models import pipeline
    from find_circ2_tpu_torch.ops import anchor_align, explore

    def keep(key, pick):
        def wrap(orig):
            sig = inspect.signature(orig)

            def kept(*args, **kw):
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                work.setdefault(key, []).append(pick(bound.arguments))
                return orig(*args, **kw)
            return kept
        return wrap
    with contextlib.ExitStack() as st:
        st.enter_context(patched(pipeline, "detect_batch_packed_fast", keep(
            "detect", lambda a: (a["lens"], a["chrom_offsets"].numel(),
                                 a["prefilter"]))))
        st.enter_context(patched(pipeline, "detect_batch_packed", keep(
            "redo", lambda a: a["lens"])))
        st.enter_context(patched(anchor_align, "fallback_slice", keep(
            "slice", lambda a: (a["resolved"], a["k"]))))
        st.enter_context(patched(explore, "explore_pairs", keep(
            "explore", lambda a: tuple(a[n] for n in EXPLORE_ARGS))))
        yield


def check_capture(tallies: dict, counts: dict, stage_n: dict) -> None:
    """SystemExit unless the traced passes' captures agree with what the
    program timed (StageTimes' counts `stage_n`): one detect call and one
    fallback slice per `device_dispatch` stage, one routing count per
    `explore_dispatch` stage, and at least one explore chunk for each of
    them. A wrapper that never fired (a renamed function, one imported by
    name) would leave the rooflines reading less work than was done."""
    batches = stage_n.get("device_dispatch", 0)
    want = {"detect_batches": batches, "slices": batches,
            "dispatches": stage_n.get("explore_dispatch", 0)}
    got = {"detect_batches": tallies["detect_batches"],
           "slices": tallies["slices"],
           "dispatches": counts.get("dispatches", 0)}
    if got != want or tallies["explore_chunks"] < got["dispatches"]:
        raise SystemExit(f"portbench: the traced passes' captures {got} "
                         f"(explore chunks {tallies['explore_chunks']}) "
                         f"disagree with the program's {want}")


def check_routed(counts: dict, stage_n: dict) -> None:
    """SystemExit unless the routing wrapper (`count_routed`) saw one call
    a timed `explore_dispatch` stage and, where the program counts them
    (`explore_dispatch/reads`), the reads its loop routed."""
    want = (stage_n.get("explore_dispatch", 0),
            stage_n.get("explore_dispatch/reads", counts.get("routed", 0)))
    got = (counts.get("dispatches", 0), counts.get("routed", 0))
    if got != want:
        raise SystemExit(f"portbench: the routing wrapper counted "
                         f"(dispatches, reads) {got}, the program {want}")


def _real(lens) -> int:
    return int((lens > 0).sum())


def tally_bounds(work: dict, cfg) -> dict:
    """Least seconds of the detect and explore programs' work on the
    captured inputs (portbench/yardstick/bounds.py), and their counts."""
    import torch
    from portbench.yardstick import bounds as yb
    a, K = cfg.anchor_len, cfg.max_pair_hits
    det = 0.0
    for lens, n_off, prefilter in work.get("detect", []):
        ln = lens.cpu().numpy()
        det += (yb.probe(2 * _real(ln), a)["bound_ms"]
                + yb.core(ln, n_off, a, prefilter)["bound_ms"])
    for resolved, k in work.get("slice", []):
        u = min(int((~resolved).sum()), k)
        if u:
            det += yb.classic(u, a, slots=True)["bound_ms"]
    for lens in work.get("redo", []):
        det += yb.classic(2 * _real(lens.cpu()), a)["bound_ms"]
    exp = 0.0
    for args in work.get("explore", []):
        n = _real(args[4].cpu())
        if not n:
            continue
        cut = _cut(args, n)
        sa, sb = cut[5], cut[6]
        stats = tuple(torch.cat([x, y]) for x, y in zip(sa, sb))
        exp += (yb.classic(2 * n, a, stats=stats)["bound_ms"]
                + yb.explore_pairs(cut, a, K)["bound_ms"])
    return dict(detect_s=det / 1e3, explore_s=exp / 1e3,
                detect_batches=len(work.get("detect", [])),
                slices=len(work.get("slice", [])),
                explore_chunks=len(work.get("explore", [])))


def _cut(args, n: int) -> tuple:
    """explore_pairs' arguments cut to their first n (real) reads."""
    words, nbases, offsets, reads, lens, sa, sb, ha, hb, mm_v = args
    return (words, nbases, offsets, reads[:n], lens[:n],
            tuple(x[:n] for x in sa), tuple(x[:n] for x in sb),
            type(ha)(*(x[:n] for x in ha)), type(hb)(*(x[:n] for x in hb)),
            mm_v)


def take_profile(program: Program, passes: int, cfg,
                 keep=lambda out: None) -> tuple[dict, dict]:
    """Profile `passes` passes under torch.profiler, again while the
    profile holds no device activity, at most PROFILE_TRIES times, each
    pass's outputs handed to `keep`. The digest (portbench/profile.py)
    and the byte tallies of the same passes, whose captures are checked
    against the program's stage counts (`check_capture`); SystemExit
    when every try came back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import profile as pp
    for attempt in range(1, PROFILE_TRIES + 1):
        work: dict = {}
        counts: dict = {}
        times = pp.LabelledTimes()
        with capture_work(work), count_routed(counts), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(passes):
                keep(program.one_pass(times))
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        tallies = tally_bounds(work, cfg)
        check_capture(tallies, counts, times.counts)
        dg = pp.digest(prof, window_s)
        if dg["activities"]:
            dg["tries"] = attempt
            return dg, tallies
        log(f"torch.profiler recorded no device activity (try {attempt} "
            f"of {PROFILE_TRIES})")
    raise SystemExit("every profile came back without device activity")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
            else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def write_library(garr: dict, traffic: dict, seed: int, anchor_len: int,
                  outdir: str) -> tuple[list[str], int]:
    """The library for `seed` as FASTQ under `outdir`: the paths of its
    files (`library.fastq`; `library_1.fastq` and `library_2.fastq` for
    mate 1 and mate 2) and its reads, every mate counted."""
    from portbench import library
    files = library.make_library(garr, traffic, seed, anchor_len)
    names = (["library.fastq"] if len(files) == 1 else
             [f"library_{k + 1}.fastq" for k in range(len(files))])
    paths = [os.path.join(outdir, n) for n in names]
    for path, data in zip(paths, library.fastq_files(files)):
        with open(path, "wb") as fh:
            fh.write(data)
    return paths, sum(int(r.shape[0]) for r in files)


def setup(root: str, workload: str, device: str):
    """A cell's set-up up to its library: the cell, the port's Config,
    the genome arrays, the port's Genome and SeedIndex (from the index
    cache) and the DeviceIndex on `device`."""
    from find_circ2_tpu_torch.io.genome import Genome
    from find_circ2_tpu_torch.models.pipeline import DeviceIndex
    from portbench import index_cache
    cell = Cell(root, workload)
    cfg = port_config(cell.conf["find_circ"])
    cache_root = os.path.join(root, BENCH_DIR, ".cache")
    garr, index, info = index_cache.load_or_build(
        cache_root, cell.conf, cell.conf_bytes, cfg, log)
    if info["built"]:
        log(f"index cache built: {info['build_s']:.3f} s, "
            f"{info['bytes']:,} bytes in {info['dir']}")
    else:
        log(f"index cache loaded: {info['seconds']:.3f} s, "
            f"{info['bytes']:,} bytes (built in {info['build_s']:.3f} s)")
    genome = Genome(codes=garr["codes"], chrom_names=garr["chrom_names"],
                    chrom_offsets=garr["chrom_offsets"],
                    chrom_lengths=garr["chrom_lengths"])
    dindex = DeviceIndex.build(genome, index, cfg, device=device)
    return cell, cfg, garr, genome, index, dindex


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_process: float, device: str = "cuda") -> dict:
    """One run of a cell: the result object, its checks last."""
    import torch
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    from portbench.reference import compare

    cell, cfg, garr, genome, index, dindex = setup(root, workload, device)
    fc = cell.conf["find_circ"]
    on_card = device == "cuda"
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        fastqs, n_reads = write_library(garr, cell.traffic, seed,
                                        cfg.anchor_len, tmp)
        program = Program(genome, index, dindex, cfg, fc, fastqs, tmp)
        outputs = {}

        def keep(out):
            outputs[out] = outputs.get(out, 0) + 1
        keep(program.one_pass(StageTimes()))          # warm pass
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_process
        log(f"set-up {setup_s:.3f} s; library {n_reads:,} reads "
            f"(seed {seed}); window {seconds} s")

        times = StageTimes()
        counts: dict = {}
        passes = 0
        with count_routed(counts) if trace else contextlib.nullcontext():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                keep(program.one_pass(times))
                passes += 1
                if time.perf_counter() >= deadline:
                    break
            window_s = time.perf_counter() - t0
        if trace:
            check_routed(counts, times.counts)
        log(f"window: {passes} passes, {passes * n_reads:,} reads in "
            f"{window_s:.3f} s; stages:\n{times.report(wall=window_s)}")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        prof = tallies = None
        if trace:
            prof, tallies = take_profile(program, PROFILE_PASSES, cfg, keep)
        run = types.SimpleNamespace(
            reads=passes * n_reads, passes=passes, window_s=window_s,
            stage_s=dict(times.totals), stage_n=dict(times.counts),
            profile=prof, bounds=tallies)
        del program, dindex
        if on_card:
            torch.cuda.empty_cache()
        # The reference runs once the window has closed and the program's
        # device state is freed; every pass is held against it.
        t_ref = time.perf_counter()
        ref = compare.reference(garr, fastqs, fc, seed, REFERENCE_WORKERS)
        ref_s = time.perf_counter() - t_ref
    worst = dict.fromkeys(PASS_NUMBERS, 0)
    failed_passes = 0
    for (bed, stats), n in outputs.items():
        d = compare.differences(bed, stats, ref)
        for k in worst:
            worst[k] = max(worst[k], d[k])
        failed_passes += n * int(d["bytes_differ"] > 0
                                 or any(d[k] > 0 for k in PASS_NUMBERS))
    log(f"reference: {ref_s:.3f} s; {sum(outputs.values())} passes "
        f"compared, {len(outputs)} distinct outputs; "
        f"{ref.oracle_sampled} reads held to the per-read oracle")
    if on_card:
        log(f"card: {card_line()}; peak device memory {peak:,} bytes")
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"portbench: the run loaded {found}; no result")
    checks = {k: {"value": v, "limit": 0} for k, v in worst.items()}
    checks["passes_differing"] = {"value": failed_passes, "limit": 0}
    checks["oracle_calls_differing"] = {"value": ref.oracle_calls_differing,
                                        "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in
             cell.bench["end_to_end"] + cell.bench["per_layer"]}
    if trace:
        values = {m["name"]: cell.reader(m["name"])(run)
                  for m in cell.per_layer}
    else:
        e2e = {"reads_per_s": run.reads / window_s, "setup_s": setup_s}
        values = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]}
               for k, v in values.items() if v is not None}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct,
              "attempted": sum(outputs.values()) * n_reads,
              "failed": failed_passes * n_reads
              + ref.oracle_calls_differing, "metrics": metrics,
              "device": dev}
    if trace:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
        log(f"profile: {prof['activities']} activities, busy "
            f"{prof['busy_s']:.6f} of {prof['window_s']:.6f} s, device s "
            f"by program {prof['device_s']}, bounds {tallies}")
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    return result
