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
from find_circ2_tpu_torch.io.bed import write_bed
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
# (portbench/metrics), for one pass as the benchmark's harness runs it,
# but device_dispatch/revcomp: the detect kernel builds each read's
# reverse complement, so the host has none to time.
BENCH_KEYS = ("device_dispatch/upload", "device_dispatch/launch",
              "device_dispatch/readback",
              "pass.rows/drain", "pass.rows/build", "pass.rows/renumber",
              "stream_start", "stream_stop", "explore_dispatch/reads",
              "slowpath_rescue/worker_us")


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


def test_one_pass_output_equals_without_a_recorder(lib):
    assert one_pass(lib, StageTimes()) == one_pass(lib, None)


def test_inline_rescue_counts_its_own_worker_time(lib, monkeypatch):
    """With no worker (a fork that fails), the host re-calls run inline
    and still count their microseconds; the output is the same."""
    class NoPool(stream._RescuePool):
        def __init__(self, *args):
            self.args, self.pool = args, None
    monkeypatch.setattr(stream, "_RescuePool", NoPool)
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
