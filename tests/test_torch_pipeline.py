"""The PyTorch port's detect path (find_circ2_tpu_torch/models, cli)
against the reference JAX package and the CPU oracle on the CPU: packed
detect rows, the fallback-overflow redo, the streaming loop's BED, the
CLI goldens, and the port's freedom from jax. Tolerance 0."""

import ast
import dataclasses
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from find_circ2_tpu.config import RPAD_CODE, Config
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.io.bed import write_bed
from find_circ2_tpu.io.fastq import FastqRecord, write_fastq
from find_circ2_tpu.io.twobit import seq_to_codes
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.models.aggregate import Aggregator
from find_circ2_tpu.models.oracle import call_read
from find_circ2_tpu.models.stream import run_fastq as jrun_fastq
from find_circ2_tpu.utils.simulate import rnase_r_library, simulate
from find_circ2_tpu_torch.cli import main as cli_main
from find_circ2_tpu_torch.io.bed import write_bed as twrite_bed
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.models.aggregate import Aggregator as TAggregator
from find_circ2_tpu_torch.models.stream import run_fastq, run_reads
from find_circ2_tpu_torch.utils.journal import RunJournal
from find_circ2_tpu_torch.utils.profiling import StageTimes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "test_data")
CFG = Config(batch_size=128)
astuple = dataclasses.astuple


@pytest.fixture(scope="module")
def lib():
    """A 200 kbp RNase-R library with repeats and sequencing errors,
    indexed once; the reference's and the port's device indexes."""
    sim = rnase_r_library(seed=17, chrom_lengths={"chrT": 200_000},
                          n_circ=20, n_linear=5, depth_mean=3.0,
                          repeat_frac=0.3, cfg=CFG)
    index = build_index(sim.genome, CFG)
    jd = jp.DeviceIndex.build(sim.genome, index, CFG)
    return sim, index, jd, tp.DeviceIndex.from_reference(jd, device="cpu")


def _batch(reads, B):
    Lp = CFG.max_read_len
    arr = np.full((B, Lp), RPAD_CODE, np.uint8)
    lens = np.zeros(B, np.int32)
    kept = [s for _, s in reads if 2 * CFG.anchor_len <= len(s) <= Lp]
    for i, seq in enumerate(kept[:B]):
        codes = seq_to_codes(seq)
        arr[i, :codes.size] = codes
        lens[i] = codes.size
    return arr, lens


def test_build_matches_from_reference(lib):
    sim, index, jd, td = lib
    built = tp.DeviceIndex.build(sim.genome, index, CFG, device="cpu")
    assert built.nbases == td.nbases
    n = built.words.shape[0]
    assert torch.equal(built.words, td.words[:n])
    assert built.ext is not None and built.ext_id is not None
    for f in ("table", "meta", "chrom_offsets", "ntable", "ext", "ext_id"):
        assert torch.equal(getattr(built, f), getattr(td, f)), f
    # ext rows keep the reference's uint32 bit patterns.
    assert np.array_equal(td.ext.numpy().view(np.uint32), np.asarray(jd.ext))


@pytest.mark.parametrize("prefilter", [True, False])
def test_detect_rows_match_jax(lib, prefilter):
    sim, _, jd, td = lib
    arr, lens = _batch(sim.reads, CFG.batch_size)
    want = np.asarray(jp.dispatch_packed(jd, arr, lens, CFG, prefilter))
    got = tp.dispatch_packed(td, arr, lens, CFG, prefilter).numpy()
    assert got.dtype == np.int32 and got.shape == (CFG.batch_size, 14)
    assert np.array_equal(got, want)
    res = tp.unpack_results(got)
    assert (res["status"][:lens.astype(bool).sum()] == 0).any()


def test_classic_rows_match_jax(lib):
    sim, _, jd, td = lib
    arr, lens = _batch(sim.reads[::3], 64)
    rc = jp.revcomp_batch(arr, lens)
    want = np.asarray(jp.detect_batch_packed(
        jd.gpacked, jd.nbases, jd.table, jd.meta, jd.chrom_offsets,
        arr, lens, CFG, True, rc=rc))
    got = tp.detect_batch_packed(
        td.words, td.nbases, td.table, td.meta, td.chrom_offsets,
        torch.from_numpy(arr), torch.from_numpy(lens), CFG, True)
    assert np.array_equal(got.numpy(), want)


def test_overflow_redo_keeps_oracle_equality(lib):
    """A fallback slice far too small for the library's error anchors
    sets multi bit 3; the classic redo keeps run_reads equal to the
    oracle read for read (as tests/test_exact_first.py)."""
    sim, index, _, td = lib
    cfg = dataclasses.replace(CFG, exact_fallback_slots=2)
    arr, lens = _batch(sim.reads, cfg.batch_size)
    packed = tp.dispatch_packed(td, arr, lens, cfg).numpy()
    assert (tp.unpack_results(packed)["multi"] & 8).all()
    calls = run_reads(td, sim.reads, cfg, slowpath=(sim.genome, index))
    assert len(calls) == len(sim.reads)
    for (name, seq), dc in zip(sim.reads, calls):
        assert astuple(dc) == astuple(call_read(sim.genome, index, name, seq,
                                                cfg)), name


def _render(agg, write=write_bed):
    buf = io.StringIO()
    write(buf, agg.rows("s"))
    return buf.getvalue(), sorted(agg.stats.counts.items())


def _reads(sim):
    """The library's reads, one too short and one too long added."""
    return list(sim.reads) + [("tiny", "ACGT" * 8), ("huge", "ACGT" * 50)]


def _fastq(sim, tmp_path):
    fq = tmp_path / "r.fastq"
    with open(fq, "wt") as fh:
        for name, seq in _reads(sim):
            write_fastq(fh, FastqRecord(name, seq, "I" * len(seq)))
    return fq


@pytest.mark.parametrize("slowpath,explore", [
    pytest.param(False, None, id="False"),
    pytest.param(True, None, id="True"),
    pytest.param(True, False, id="True-explore_off")])
def test_run_fastq_matches_jax(lib, tmp_path, slowpath, explore):
    """The port's streaming loop against the reference's on one FASTQ
    (as tests/test_native.py): same BED and stats. With the slow path,
    the reference explores §2b on its device program; the port does too
    (explore None: array-mode DeviceExplorer), or on the host twin
    (explore False)."""
    sim, index, jd, td = lib
    fq = _fastq(sim, tmp_path)
    sp = (sim.genome, index) if slowpath else None
    agg_j = Aggregator(sim.genome, CFG)
    jrun_fastq(jd, fq, agg_j, CFG, slowpath=sp)
    agg_t = TAggregator(sim.genome, CFG)
    times = StageTimes()
    run_fastq(td, fq, agg_t, CFG, slowpath=sp, explore=explore, times=times)
    bed, stats = _render(agg_t, twrite_bed)
    assert (bed, stats) == _render(agg_j)
    assert bed.count("\n") > 5
    device = {"explore_dispatch", "explore_multihit"} <= set(times.counts)
    host = "slowpath_multihit" in times.counts
    assert (device, host) == (slowpath and explore is None,
                              slowpath and explore is False)


def _stalled_ping():
    """A rescue worker that never answers its start-up ping."""
    time.sleep(60)


def test_stalled_rescue_worker_runs_inline(lib, tmp_path, monkeypatch):
    """A forked rescue worker that does not answer its start-up ping
    (stalled on purpose) is dropped at once: the run makes its host
    re-calls inline from the start, gives the reference's BED and stats,
    and returns well within the worker's TIMEOUT_S."""
    from find_circ2_tpu_torch.models import stream
    assert stream._RescuePool.PING_S <= 10 < stream._RescuePool.TIMEOUT_S
    made = []

    class Pool(stream._RescuePool):
        PING_S = 1.0

        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(stream, "_RescuePool", Pool)
    monkeypatch.setattr(stream, "_rescue_ping", _stalled_ping)
    sim, index, jd, td = lib
    fq = _fastq(sim, tmp_path)
    sp = (sim.genome, index)
    agg_j = Aggregator(sim.genome, CFG)
    jrun_fastq(jd, fq, agg_j, CFG, slowpath=sp)
    agg_t = TAggregator(sim.genome, CFG)
    times = StageTimes()
    t0 = time.perf_counter()
    run_fastq(td, fq, agg_t, CFG, slowpath=sp, explore=False, times=times)
    took = time.perf_counter() - t0
    assert _render(agg_t, twrite_bed) == _render(agg_j)
    assert [p.pool for p in made] == [None]
    assert "slowpath_multihit" in times.counts
    assert took < Pool.TIMEOUT_S / 4, took


@pytest.fixture(scope="module")
def jax_fastq(lib, tmp_path_factory):
    """The reference's run_fastq on `_fastq`'s file, slow path on: its
    BED and stats."""
    sim, index, jd, _ = lib
    fq = _fastq(sim, tmp_path_factory.mktemp("jax_fastq"))
    agg = Aggregator(sim.genome, CFG)
    jrun_fastq(jd, fq, agg, CFG, slowpath=(sim.genome, index))
    return _render(agg)


def test_run_fastq_journal_explores_from_rows(lib, jax_fastq, tmp_path,
                                              monkeypatch):
    """With a journal, routed reads are explored from the batch's own
    rows (DeviceExplorer.dispatch_arrays), not on the host twin; BED and
    stats equal the reference's, on the first run and on the replay."""
    sim, index, _, td = lib
    fq = _fastq(sim, tmp_path)
    seen = []       # the rows of each DeviceExplorer.dispatch_arrays call
    orig = tp.DeviceExplorer.dispatch_arrays

    def watched(self, arr, lens):
        seen.append(int(arr.shape[0]))
        return orig(self, arr, lens)
    monkeypatch.setattr(tp.DeviceExplorer, "dispatch_arrays", watched)
    for run in range(2):
        agg_t = TAggregator(sim.genome, CFG)
        times = StageTimes()
        run_fastq(td, fq, agg_t, CFG, slowpath=(sim.genome, index),
                  times=times, journal=RunJournal(str(tmp_path / "j.jsonl")))
        assert _render(agg_t, twrite_bed) == jax_fastq
        assert ("explore_dispatch" in times.counts) == (run == 0)
        assert "slowpath_multihit" not in times.counts
        if run == 0:
            assert times.counts["explore_dispatch/reads"] == sum(seen) > 0
            assert times.counts["explore_dispatch"] == len(seen)


@pytest.mark.parametrize("journal", [False, True],
                         ids=["no_journal", "journal"])
@pytest.mark.parametrize("explore", [None, False],
                         ids=["explore_device", "explore_host"])
def test_one_loop_both_sources(lib, jax_fastq, tmp_path, explore, journal):
    """Both sources of the one streaming loop over the same reads (tiny
    and huge ones included): run_reads' calls added to an Aggregator, and
    run_fastq, give the reference run_fastq's BED and stats, with §2b on
    the device or on the host twin; every journal replays to them."""
    sim, index, _, td = lib
    reads = _reads(sim)
    fq = _fastq(sim, tmp_path)
    sp = (sim.genome, index)

    def journal_of(name):
        return RunJournal(str(tmp_path / name)) if journal else None

    for run in range(1 + journal):
        times = StageTimes()
        calls = run_reads(td, reads, CFG, slowpath=sp, explore=explore,
                          journal=journal_of("reads.jsonl"), times=times)
        assert [c.name for c in calls] == [n for n, _ in reads]
        agg = TAggregator(sim.genome, CFG)
        for call in calls:
            agg.add(call)
        assert _render(agg, twrite_bed) == jax_fastq
        assert ("device_dispatch" in times.counts) == (run == 0)
        agg = TAggregator(sim.genome, CFG)
        times = StageTimes()
        run_fastq(td, fq, agg, CFG, slowpath=sp, explore=explore,
                  journal=journal_of("fastq.jsonl"), times=times)
        assert _render(agg, twrite_bed) == jax_fastq
        assert ("device_dispatch" in times.counts) == (run == 0)
        if run == 0:
            host = "slowpath_multihit" in times.counts
            assert host == (explore is False)
            assert ("explore_dispatch" in times.counts) == (not host)


def test_run_reads_matches_oracle_on_simulated_reads():
    sim = simulate(seed=7, n_circ=8, n_linear=6, reads_per_junction=3,
                   n_contiguous=20, n_random=10, err_rate=0.35)
    index = build_index(sim.genome, CFG)
    td = tp.DeviceIndex.build(sim.genome, index, CFG, device="cpu")
    for prefilter in (True, False):
        calls = run_reads(td, sim.reads, CFG, prefilter)
        want = [call_read(sim.genome, index, n, s, CFG, prefilter)
                for n, s in sim.reads]
        assert [astuple(c) for c in calls] == [astuple(c) for c in want]


def _read(path):
    with open(path) as fh:
        return fh.read()


def test_cli_reproduces_golden_on_cpu(tmp_path):
    bed = tmp_path / "out.bed"
    stats = tmp_path / "out.stats"
    rc = cli_main.main([
        "find_circ", os.path.join(DATA, "reads.fastq"),
        "-G", os.path.join(DATA, "genome.fa"), "--reads-format", "fastq",
        "--device", "cpu", "-n", "golden", "-o", str(bed), "-s", str(stats),
        "--batch-size", "64"])
    assert rc == 0
    assert _read(bed) == _read(os.path.join(DATA, "splice_sites.bed"))
    assert _read(stats) == _read(os.path.join(DATA, "stats.txt"))


def test_cli_journal_replay_reproduces_golden(tmp_path):
    """A second run over a complete journal replays every batch from it
    and still writes the golden bytes."""
    args = ["find_circ", os.path.join(DATA, "reads.fastq"),
            "-G", os.path.join(DATA, "genome.fa"), "--reads-format", "fastq",
            "--device", "cpu", "-n", "golden", "--batch-size", "64",
            "--journal", str(tmp_path / "j.jsonl")]
    for run in range(2):
        bed = tmp_path / f"out{run}.bed"
        stats = tmp_path / f"out{run}.stats"
        assert cli_main.main(args + ["-o", str(bed), "-s", str(stats)]) == 0
        assert _read(bed) == _read(os.path.join(DATA, "splice_sites.bed"))
        assert _read(stats) == _read(os.path.join(DATA, "stats.txt"))


def test_cli_pe_matches_reference(tmp_path):
    """--pe reverse-complements the mate-2 file on the native path; the
    port's output must equal the reference CLI's."""
    from find_circ2_tpu.cli import main as ref_main
    reads = os.path.join(DATA, "reads.fastq")
    outs = []
    for name, main, extra in (("ref", ref_main, []),
                              ("port", cli_main, ["--device", "cpu"])):
        bed = tmp_path / f"{name}.bed"
        stats = tmp_path / f"{name}.stats"
        assert main.main(["find_circ", reads, reads, "--pe", "-G",
                          os.path.join(DATA, "genome.fa"), "--reads-format",
                          "fastq", "--stranded", "--batch-size", "64", "-o",
                          str(bed), "-s", str(stats)] + extra) == 0
        outs.append((_read(bed), _read(stats)))
    assert outs[0] == outs[1]
    assert outs[1][0].count("\n") > 2


def test_cli_run_filter_reproduces_golden_candidates(tmp_path):
    rc = cli_main.main([
        "run", os.path.join(DATA, "reads.fastq"),
        "-G", os.path.join(DATA, "genome.fa"), "-o", str(tmp_path),
        "-n", "golden", "--filter", "--device", "cpu"])
    assert rc == 0
    assert _read(tmp_path / "circ_candidates.bed") == \
        _read(os.path.join(DATA, "circ_candidates.bed"))


@pytest.mark.parametrize("flags", [
    (["--nproc", "2"], "--nproc requires --proc-id"),
    (["--mesh", "2x4", "--nproc", "2", "--proc-id", "0", "-o", "o.bed"],
     "--mesh shards within one process"),
    (["--mesh", "2x"], "--mesh expects DATAxINDEX")])
def test_cli_unported_modes_exit(flags):
    """The reference's checks of --mesh and --nproc, made before any
    input is read or any process group is joined."""
    extra, match = flags
    with pytest.raises(SystemExit, match=match):
        cli_main.main(["find_circ", "x.fq", "-G", "g.fa", "--device", "cpu"]
                      + extra)


def test_cli_oracle_backend_reproduces_golden(tmp_path):
    """--backend oracle (the numpy caller, no device) on test_data/."""
    bed, stats = tmp_path / "out.bed", tmp_path / "out.stats"
    assert cli_main.main([
        "find_circ", os.path.join(DATA, "reads.fastq"),
        "-G", os.path.join(DATA, "genome.fa"), "--reads-format", "fastq",
        "--backend", "oracle", "--device", "cpu", "-n", "golden",
        "-o", str(bed), "-s", str(stats)]) == 0
    assert _read(bed) == _read(os.path.join(DATA, "splice_sites.bed"))
    assert _read(stats) == _read(os.path.join(DATA, "stats.txt"))


@pytest.mark.parametrize("exact_first", [True, False])
def test_detect_batch_and_phased_match_jax(lib, exact_first):
    """detect_batch (the unpacked classic step) and detect_batch_phased
    (K1 then core; exact-first with a neighbour table) equal the
    reference's, field for field, with the reverse complement built on
    the device (rc=None) and shipped from the host."""
    sim, _, jd, td = lib
    arr, lens = _batch(sim.reads[1::2], 64)
    rc = jp.revcomp_batch(arr, lens)
    reads_t, lens_t = torch.from_numpy(arr), torch.from_numpy(lens)
    want = jp.detect_batch(jd.gpacked, jd.nbases, jd.table, jd.meta,
                           jd.chrom_offsets, arr, lens, CFG, True)
    got = tp.detect_batch(td.words, td.nbases, td.table, td.meta,
                          td.chrom_offsets, reads_t, lens_t, CFG, True)
    if not exact_first:
        jd = dataclasses.replace(jd, ntable=None)
        td = dataclasses.replace(td, ntable=None)
    jph = jp.detect_batch_phased(jd, arr, lens, CFG, True, rc=rc)
    tph = tp.detect_batch_phased(td, reads_t, lens_t, CFG, True,
                                 rc=torch.from_numpy(rc))
    assert set(got) == set(want) == set(tph) == set(jph)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert np.array_equal(tph[k].numpy(), np.asarray(jph[k])), k
        assert np.array_equal(tph[k].numpy(), got[k].numpy()), k


def test_cli_cuda_without_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_main.main(["find_circ", os.path.join(DATA, "reads.fastq"),
                       "-G", os.path.join(DATA, "genome.fa"),
                       "--reads-format", "fastq"])


def _port_files():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "find_circ2_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return paths


def _module(path):
    mod = os.path.relpath(path, ROOT)[:-len(".py")].replace(os.sep, ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def test_port_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports the JAX package
    or any of its modules (every import in the AST, at module level or
    inside a function), and importing all of them in a fresh interpreter
    leaves no module of the JAX package, jax or jaxlib loaded."""
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in ("find_circ2_tpu", "jax", "jaxlib")]
    assert not bad, bad
    mods = sorted(_module(p) for p in _port_files())
    assert {"chip_smoke", "find_circ2_tpu_torch.models.multihit",
            "find_circ2_tpu_torch.ops.merge",
            "find_circ2_tpu_torch.index.shard",
            "find_circ2_tpu_torch.parallel.mesh",
            "find_circ2_tpu_torch.parallel.sharded",
            "find_circ2_tpu_torch.parallel.distributed",
            "find_circ2_tpu_torch.utils.explore_cases"} <= set(mods)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('find_circ2_tpu', 'jax', 'jaxlib')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_device_index_defaults_to_the_card(lib, monkeypatch):
    """DeviceIndex.build and from_reference without a device put the
    index on the card; without one they raise instead of running on the
    CPU."""
    sim, index, jd, _ = lib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tp.DeviceIndex.build(sim.genome, index, CFG),
                 lambda: tp.DeviceIndex.from_reference(jd)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
