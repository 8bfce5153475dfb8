"""The port's span tree (find_circ2_tpu_torch/utils/profiling): spans
and counters that nest by context under a StageTimes stage, the report's
root-only residual, and the spans and counters that the streaming loop,
the detect dispatch, the final table and the CLI record, on the CPU."""

import io
import os
import subprocess
import sys

import pytest

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.index.build import build_index
from find_circ2_tpu_torch.io.bed import passes_filter, write_bed
from find_circ2_tpu_torch.io.fastq import FastqRecord, write_fastq
from find_circ2_tpu_torch.models import stream
from find_circ2_tpu_torch.models.aggregate import Aggregator
from find_circ2_tpu_torch.models.pipeline import DeviceExplorer, DeviceIndex
from find_circ2_tpu_torch.parallel.mesh import make_mesh
from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
from find_circ2_tpu_torch.utils import profiling
from find_circ2_tpu_torch.utils.profiling import StageTimes, count, span
from find_circ2_tpu_torch.utils.simulate import rnase_r_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "test_data")
CFG = Config(batch_size=128)
TWIST = dict(zip("ACGTN", "CGTAN"))
# Every key the benchmark's span and counter metrics read
# (portbench/metrics), for one single-end pass as the benchmark's harness
# runs it; a paired pass adds mate 2's `encode/revcomp`.
BENCH_KEYS = ("device_dispatch/upload", "device_dispatch/launch",
              "device_dispatch/readback",
              "pass.rows/drain", "pass.rows/build", "pass.rows/renumber",
              "stream_start", "stream_stop", "explore_dispatch/reads",
              "slowpath_rescue/worker_us", "aggregate/rescue_reads")


def helper():
    """One piece of work that opens a span wherever it is called."""
    with span("piece"):
        count("items", 3)


def test_span_and_count_outside_any_stage_record_nothing():
    t = StageTimes()
    with span("orphan"):
        count("orphans", 5)
    helper()
    assert (t.totals, t.counts) == ({}, {})
    assert span("orphan") is span("other")      # one shared no-op block
    with t.stage("root"):
        pass
    with span("after"):
        count("after", 1)
    assert set(t.totals) == set(t.counts) == {"root"}


def test_keys_nest_by_parent_and_one_helper_stays_apart():
    t = StageTimes()
    with t.stage("device_dispatch"):
        helper()
        with span("inner"):
            helper()
    with t.stage("device_detect"):
        helper()
    with t.stage("device_dispatch"):
        helper()
    assert t.counts == {
        "device_dispatch": 2, "device_dispatch/piece": 2,
        "device_dispatch/piece/items": 6, "device_dispatch/inner": 1,
        "device_dispatch/inner/piece": 1,
        "device_dispatch/inner/piece/items": 3,
        "device_detect": 1, "device_detect/piece": 1,
        "device_detect/piece/items": 3}
    for key in t.totals:
        parent = key.rpartition("/")[0]
        assert not parent or t.totals[key] <= t.totals[parent]
    # Two recorders, nested: a span belongs to the innermost stage's.
    outer, inner = StageTimes(), StageTimes()
    with outer.stage("a"):
        with inner.stage("b"):
            helper()
        helper()
    assert set(inner.totals) == {"b", "b/piece"}
    assert set(outer.totals) == {"a", "a/piece"}


def test_counters_leave_totals_alone():
    t = StageTimes()
    with t.stage("explore_dispatch"):
        count("reads", 40)
        count("reads", 2)
    assert t.totals.keys() == {"explore_dispatch"}
    assert t.counts == {"explore_dispatch": 1, "explore_dispatch/reads": 42}
    assert "  explore_dispatch/reads\t42" in t.report().splitlines()


def test_report_residual_counts_root_stages_only():
    t = StageTimes(
        totals={"device_dispatch": 1.0, "device_dispatch/revcomp": 0.6,
                "device_dispatch/upload": 0.3, "pass.rows": 2.0,
                "pass.rows/build": 1.5, "pass.rows/build/deep": 1.0},
        counts={"device_dispatch": 4, "device_dispatch/revcomp": 4,
                "device_dispatch/upload": 4, "pass.rows": 1,
                "pass.rows/build": 1, "pass.rows/build/deep": 2,
                "device_dispatch/reads": 7})
    t.add_reads(1000)
    assert t.report(wall=4.0).splitlines() == [
        "pass.rows\t2.000s\t1x",
        "  pass.rows/build\t1.500s\t1x",
        "    pass.rows/build/deep\t1.000s\t2x",
        "device_dispatch\t1.000s\t4x",
        "  device_dispatch/revcomp\t0.600s\t4x",
        "  device_dispatch/upload\t0.300s\t4x",
        "  device_dispatch/reads\t7",
        "wall\t4.000s\tuntimed residual 1.000s (25%)",
        "reads_per_s\t250"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """A 200 kbp RNase-R library with repeats and sequencing errors as a
    FASTQ, every fourth read with two more errors in its first anchor,
    its index and its CPU device index."""
    sim = rnase_r_library(seed=17, chrom_lengths={"chrT": 200_000},
                          n_circ=20, n_linear=5, depth_mean=3.0,
                          repeat_frac=0.3, cfg=CFG)
    index = build_index(sim.genome, CFG)
    fq = tmp_path_factory.mktemp("tracing") / "r.fastq"
    with open(fq, "wt") as fh:
        for i, (name, seq) in enumerate(sim.reads):
            if i % 4 == 0:
                # Two substitutions in the first anchor: a 2-mm rescue.
                seq = seq[:3] + TWIST[seq[3]] + seq[4:11] + TWIST[seq[11]] \
                    + seq[12:]
            write_fastq(fh, FastqRecord(name, seq, "I" * len(seq)))
    return sim, index, DeviceIndex.build(sim.genome, index, CFG,
                                         device="cpu"), fq


def one_pass(lib, times, **kw):
    """run_fastq and the final table as the benchmark's pass makes them
    (portbench/harness.Program.one_pass): the BED and stats text."""
    sim, index, dindex, fq = lib
    agg = Aggregator(sim.genome, CFG)
    stream.run_fastq(dindex, fq, agg, CFG, times=times,
                     slowpath=(sim.genome, index), **kw)
    with profiling.timed(times, "pass.rows"):
        rows = agg.rows(sample_name="s")
    buf = io.StringIO()
    write_bed(buf, rows)
    return buf.getvalue(), "\n".join(agg.stats.lines())


def test_one_pass_records_every_key_the_benchmark_reads(lib, monkeypatch):
    routed = []
    orig = DeviceExplorer.dispatch_arrays

    def watched(self, arr, lens):
        routed.append(int(arr.shape[0]))
        return orig(self, arr, lens)
    monkeypatch.setattr(DeviceExplorer, "dispatch_arrays", watched)
    t = StageTimes()
    one_pass(lib, t)
    missing = [k for k in BENCH_KEYS if k not in t.counts]
    assert not missing, sorted(t.counts)
    for key, s in t.totals.items():
        parent = key.rpartition("/")[0]
        assert not parent or s <= t.totals[parent], key
    for key in ("device_dispatch/upload", "device_dispatch/launch",
                "device_dispatch/readback"):
        assert t.counts[key] == t.counts["device_dispatch"], key
    assert "device_dispatch/revcomp" not in t.counts
    assert t.counts["explore_dispatch/reads"] == sum(routed) > 0
    assert len(routed) == t.counts["explore_dispatch"]
    assert t.counts["slowpath_rescue/worker_us"] > 0
    assert t.counts["stream_start"] == t.counts["stream_stop"] == 1


@pytest.mark.parametrize("revcomp", [False, True],
                         ids=["single_end", "mate_2"])
def test_mate_2s_reverse_complement_has_its_own_span(lib, revcomp):
    """`run_fastq(revcomp=True)`, a `--pe` mate 2, times its host reverse
    complement under `encode/revcomp`, once a batch; a single-end file
    has none to time."""
    t = StageTimes()
    one_pass(lib, t, revcomp=revcomp)
    if revcomp:
        assert t.counts["encode/revcomp"] == t.counts["device_dispatch"] > 0
        assert t.totals["encode/revcomp"] <= t.totals["encode"]
    else:
        assert "encode/revcomp" not in t.counts


def _recalled_rows(monkeypatch) -> list:
    """(stage, rows) of every later host re-call the loop makes."""
    seen = []
    orig = stream._Loop._host_recall

    def watched(self, b, rows, stage):
        seen.append((stage, rows.size))
        return orig(self, b, rows, stage)
    monkeypatch.setattr(stream._Loop, "_host_recall", watched)
    return seen


class _NoPool(stream._RescuePool):
    """A rescue pool whose fork failed: the re-calls run inline."""
    def __init__(self, *args):
        self.args, self.pool = args, None


@pytest.mark.parametrize("path", ["worker", "inline", "host_twin"])
def test_rescue_counter_counts_the_reads_handed_to_the_rescue(
        lib, monkeypatch, path):
    """`aggregate/rescue_reads` counts the reads the loop selects for the
    2-mm rescue (every fourth read of the library has two substitutions
    in an anchor), whether the forked worker or the inline path re-calls
    them, and never the §2b reads that the host twin re-calls
    (`explore=False`). Each re-call's items are built under
    `recall_items`, apart from the re-calls' own stages."""
    if path == "inline":
        monkeypatch.setattr(stream, "_RescuePool", _NoPool)
    seen = _recalled_rows(monkeypatch)
    t = StageTimes()
    one_pass(lib, t, **({"explore": False} if path == "host_twin" else {}))
    rescued = sum(n for stage, n in seen if stage == "slowpath_rescue")
    assert t.counts["aggregate/rescue_reads"] == rescued > 0
    if path == "host_twin":
        assert sum(n for stage, n in seen
                   if stage == "slowpath_multihit") > 0
    assert t.counts["recall_items"] == sum(1 for _, n in seen if n)


def test_final_table_counts_its_reads_and_junctions(lib):
    """The final table's spans, and the counters under `drain`: the
    junction reads it grouped and the junctions (BED rows) they gave."""
    t = StageTimes()
    bed, stats = one_pass(lib, t)
    for key in ("pass.rows/drain", "pass.rows/build", "pass.rows/renumber"):
        assert t.counts[key] == 1, key
    counts = dict(line.split("\t") for line in stats.splitlines())
    reads = int(counts.get("circular_reads", 0)) + int(
        counts.get("linear_reads", 0))
    junctions = int(counts["circular_junctions"]) + int(
        counts["linear_junctions"])
    assert t.counts["pass.rows/drain/reads"] == reads > junctions > 0
    assert t.counts["pass.rows/drain/junctions"] == junctions \
        == bed.count("\n") - 1
    assert "pass.rows/drain/reads" not in t.totals


def test_one_pass_output_equals_without_a_recorder(lib):
    assert one_pass(lib, StageTimes()) == one_pass(lib, None)


def test_the_writer_counts_its_lines_by_path(lib):
    """Under one stage, an unfiltered table's rows() and write_bed write
    every junction from the columns (`table_lines`) and build no row; a
    filter's iteration builds the rows under the stage's own `build` (a
    second entry, after the columns'), and the kept rows are written one
    row object at a time (`row_lines`)."""
    sim, index, dindex, fq = lib
    agg = Aggregator(sim.genome, CFG)
    stream.run_fastq(dindex, fq, agg, CFG, slowpath=(sim.genome, index))
    t = StageTimes()
    with t.stage("pass"):
        rows = agg.rows(sample_name="s")
        bed = io.StringIO()
        write_bed(bed, rows)
    assert t.counts["pass/table_lines"] == len(rows) \
        == bed.getvalue().count("\n") - 1 > 0
    assert t.counts["pass/build"] == 1 and rows.built is None
    assert "pass/row_lines" not in t.counts
    with t.stage("rows"):
        rows = agg.rows(sample_name="s")
        kept = [r for r in rows if passes_filter(r)]
    with t.stage("write"):
        write_bed(io.StringIO(), kept)
    assert t.counts["rows/build"] == 2
    assert t.totals["rows/build"] <= t.totals["rows"]
    assert t.counts["write/row_lines"] == len(kept) > 0
    assert "write/table_lines" not in t.counts


def test_inline_rescue_counts_its_own_worker_time(lib, monkeypatch):
    """With no worker (a fork that fails), the host re-calls run inline
    and still count their microseconds; the output is the same."""
    monkeypatch.setattr(stream, "_RescuePool", _NoPool)
    t = StageTimes()
    out = one_pass(lib, t)
    assert "rescue_dispatch" not in t.counts
    assert t.counts["slowpath_rescue/worker_us"] > 0
    monkeypatch.undo()
    assert out == one_pass(lib, None)


def test_sharded_dispatch_splits_alike(lib):
    """The sharded engine's dispatch (find_circ --mesh) records the same
    children of device_dispatch, the readback's included, and no host
    reverse complement."""
    sim, index, _, fq = lib
    eng = ShardedEngine(sim.genome, index, make_mesh(2, (1, 2), ["cpu"] * 2),
                        CFG)
    t = StageTimes()
    stream.run_fastq(None, fq, Aggregator(sim.genome, CFG), CFG, times=t,
                     slowpath=(sim.genome, index),
                     dispatch=eng.dispatch_packed, redo=eng.redo_packed)
    n = t.counts["device_dispatch"]
    assert n > 0
    for child in ("upload", "launch", "readback"):
        assert t.counts[f"device_dispatch/{child}"] == n, child
    assert "device_dispatch/revcomp" not in t.counts


def test_cli_profile_reports_the_whole_run(tmp_path):
    """find_circ --profile prints its stage table after the writers,
    with root stages rows, filter and write and the table's children."""
    bed, stats = tmp_path / "out.bed", tmp_path / "out.stats"
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "find_circ2_tpu_torch.cli.main", "find_circ",
         os.path.join(DATA, "reads.fastq"), "-G",
         os.path.join(DATA, "genome.fa"), "--reads-format", "fastq",
         "--batch-size", "64", "--device", "cpu", "-n", "golden", "-o",
         str(bed), "-s", str(stats), "--profile", "--filter"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    keys = {line.split("\t")[0].strip() for line in r.stderr.splitlines()}
    assert {"rows", "filter", "write", "rows/drain", "rows/build",
            "rows/renumber", "stream_start", "stream_stop",
            "device_dispatch/upload", "wall"} <= keys
    assert "device_dispatch/revcomp" not in keys
    assert r.stderr.splitlines()[-1].startswith("reads_per_s")
