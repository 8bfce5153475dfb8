"""The port's multi-process layer (find_circ2_tpu_torch/parallel/
distributed.py, `find_circ --nproc`) on the CPU, case for case with
tests/test_distributed.py and tests/test_multiproc_cli.py: real OS
processes joined over gloo on localhost.

- Two processes, each with a 4-slot CPU mesh, form one global mesh whose
  "data" (or "dhost") axis crosses the process boundary; the merged
  junction table and the summed stats equal a single-process run and the
  reference's. The worker is this file run as a script (it imports the
  port only).
- `find_circ --nproc 2` gives byte-identical BED and stats to a
  single-process run: golden data, a ~10k-read library on the native
  path, SAM input on the per-read path, journal write and resume; a
  journal written under another sharding is refused.

The processes run through tests/launcher.py's `run_all`, which kills
every rank's process group once one fails or its deadline passes; the
workers' torch.distributed group has a timeout of its own. So a dead
rank fails its test in seconds instead of hanging the run.
"""

import json
import os
import sys

import numpy as np
import pytest

from launcher import ROOT, free_port, run_all

DATA = os.path.join(ROOT, "test_data")
CLI = [sys.executable, "-m", "find_circ2_tpu_torch.cli.main", "find_circ"]
SIM = dict(seed=77, n_circ=5, n_linear=3, reads_per_junction=4,
           n_contiguous=8, n_random=4, err_rate=0.3)
B = 64
WORKER_TIMEOUT_S = 60


def _batch():
    """The reads of the two-process merge, as one host batch."""
    from find_circ2_tpu_torch.config import RPAD_CODE, Config
    from find_circ2_tpu_torch.index.build import build_index
    from find_circ2_tpu_torch.io.twobit import seq_to_codes
    from find_circ2_tpu_torch.utils.simulate import simulate
    cfg = Config()
    sim = simulate(**SIM)
    idx = build_index(sim.genome, cfg)
    reads = np.full((B, cfg.max_read_len), RPAD_CODE, np.uint8)
    lens = np.zeros(B, np.int32)
    kept = [(n, s) for n, s in sim.reads
            if 2 * cfg.anchor_len <= len(s) <= cfg.max_read_len][:B]
    for i, (_, s) in enumerate(kept):
        codes = seq_to_codes(s)
        reads[i, :codes.size] = codes
        lens[i] = codes.size
    return cfg, sim, idx, reads, lens


def worker(pid: int, nproc: int, port: str, outdir: str, hier: bool):
    """One process of the two-process merge: its local slice of the
    batch through the sharded detect and merge, the stats summed."""
    from find_circ2_tpu_torch.parallel.distributed import (
        allreduce_counts, close_distributed, global_mesh, host_read_slice,
        init_distributed)
    from find_circ2_tpu_torch.parallel.mesh import make_hier_mesh
    from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
    init_distributed(f"localhost:{port}", nproc, pid,
                     timeout_s=WORKER_TIMEOUT_S)
    try:
        cfg, sim, idx, reads, lens = _batch()
        local = ["cpu"] * 4
        mesh = (make_hier_mesh(nproc, 2, 2, local) if hier
                else global_mesh(devices=local))   # (data=nproc, index=4)
        eng = ShardedEngine(sim.genome, idx, mesh, cfg)
        lo, hi = host_read_slice(B, pid, nproc)
        merged = eng.detect_merged(reads[lo:hi], lens[lo:hi])
        n = int(merged["valid"].sum())
        counts = allreduce_counts(np.asarray([hi - lo, n], np.int64))
        with open(os.path.join(outdir, f"out_{pid}.json"), "w") as fh:
            json.dump({"mesh": mesh.shape, "n": n,
                       "table": {k: v[:n].tolist() for k, v in merged.items()},
                       "counts": counts.tolist(),
                       "rows": int(merged["valid"].shape[0])}, fh)
    finally:
        close_distributed()


def _expected():
    """Single-process truth: the port's and the reference's single-device
    detect and merge of the whole batch, which must agree."""
    import jax.numpy as jnp
    import torch
    from find_circ2_tpu.models.pipeline import DeviceIndex as JIndex
    from find_circ2_tpu.models.pipeline import detect_batch as jdetect
    from find_circ2_tpu.ops.merge import merge_junctions as jmerge
    from find_circ2_tpu_torch.models import pipeline as tp
    from find_circ2_tpu_torch.ops.merge import merge_junctions
    cfg, sim, idx, reads, lens = _batch()
    td = tp.DeviceIndex.build(sim.genome, idx, cfg, device="cpu")
    res = tp.detect_batch(td.words, td.nbases, td.table, td.meta,
                          td.chrom_offsets, torch.from_numpy(reads),
                          torch.from_numpy(lens), cfg, True)
    merged = {k: v.numpy() for k, v in
              merge_junctions(res, torch.from_numpy(lens), cfg).items()}
    jd = JIndex.build(sim.genome, idx, cfg)
    jres = jdetect(jd.gpacked, jd.nbases, jd.table, jd.meta,
                   jd.chrom_offsets, reads, lens, cfg, True)
    want = jmerge(jres, jnp.asarray(lens), cfg)
    n = int(merged["valid"].sum())
    for k, v in merged.items():
        assert np.array_equal(v, np.asarray(want[k])), k
    return {k: v[:n].tolist() for k, v in merged.items()}, n


@pytest.mark.parametrize("hier", [False, True])
def test_two_process_merge_matches_single(tmp_path, hier):
    want_table, want_n = _expected()
    port = free_port()
    rcs, outs = run_all([[sys.executable, os.path.abspath(__file__), str(pid),
                          "2", str(port), str(tmp_path)]
                         + (["hier"] if hier else []) for pid in range(2)],
                        tmp_path / "logs")
    assert rcs == [0, 0], "\n====\n".join(outs)
    for pid in range(2):
        with open(tmp_path / f"out_{pid}.json") as fh:
            got = json.load(fh)
        assert got["n"] == want_n, (pid, got["mesh"])
        assert got["rows"] == B
        for k, v in want_table.items():
            assert got["table"][k] == v, (pid, k)
        # Summed stats: 2 processes x 32 local reads, n junctions each.
        assert got["counts"] == [64, 2 * want_n]
        assert got["mesh"] == ({"dhost": 2, "data": 2, "index": 2} if hier
                               else {"data": 2, "index": 4})


def _write_genome(tmp_path, sim):
    from find_circ2_tpu_torch.io.fasta import write_fasta
    from find_circ2_tpu_torch.io.twobit import codes_to_seq
    fa = tmp_path / "g.fa"
    write_fasta(fa, [(n, codes_to_seq(
        sim.genome.codes[sim.genome.chrom_offsets[i]:
                         sim.genome.chrom_offsets[i]
                         + sim.genome.chrom_lengths[i]]))
        for i, n in enumerate(sim.genome.chrom_names)])
    return fa


def _write_inputs(tmp_path, **sim_kw):
    from find_circ2_tpu_torch.io.fastq import FastqRecord, write_fastq
    from find_circ2_tpu_torch.utils.simulate import simulate
    kw = dict(seed=91, n_circ=4, n_linear=2, reads_per_junction=3,
              n_contiguous=8, n_random=4, err_rate=0.3)
    kw.update(sim_kw)
    sim = simulate(**kw)
    fa = _write_genome(tmp_path, sim)
    fq = tmp_path / "r.fastq"
    with open(fq, "wt") as fh:
        for name, seq in sim.reads:
            write_fastq(fh, FastqRecord(name, seq, "I" * len(seq)))
    return fa, fq


def _args_for(tmp_path, tag, inputs, base):
    a = list(base) + ["--device", "cpu"]
    a[a.index(None)] = str(tmp_path / f"{tag}.stats")
    a[a.index(None)] = str(tmp_path / f"{tag}.bed")
    return CLI + [str(f) for f in inputs] + a


def _run_single(tmp_path, inputs, base):
    rcs, outs = run_all([_args_for(tmp_path, "single", inputs, base)],
                        tmp_path / "single_logs")
    assert rcs == [0], outs[0]


def _run_nproc(tmp_path, inputs, base, extra=(), tag="nproc"):
    port = free_port()
    rcs, outs = run_all([_args_for(tmp_path, tag, inputs, base)
                         + ["--nproc", "2", "--proc-id", str(pid),
                            "--coordinator", f"localhost:{port}"]
                         + list(extra) for pid in range(2)],
                        tmp_path / f"{tag}_logs")
    assert rcs == [0, 0], "\n====\n".join(outs)


def _assert_equal_outputs(tmp_path, tag="nproc"):
    single_bed = (tmp_path / "single.bed").read_text()
    assert (tmp_path / f"{tag}.bed").read_text() == single_bed
    assert (tmp_path / f"{tag}.stats").read_text() == \
        (tmp_path / "single.stats").read_text()
    assert "circ_" in single_bed
    # Part files were cleaned up after the merge.
    assert not list(tmp_path.glob(f"{tag}.bed.part*"))


@pytest.mark.parametrize("data", ["sim", "golden"])
def test_nproc2_cli_byte_identical(tmp_path, data):
    """--nproc 2 on the reference's small library, and on test_data/,
    where both runs must also give the golden BED and stats."""
    if data == "golden":
        fa = os.path.join(DATA, "genome.fa")
        fq = os.path.join(DATA, "reads.fastq")
        extra = ["-n", "golden", "--batch-size", "64"]
    else:
        fa, fq = _write_inputs(tmp_path)
        extra = ["--batch-size", "32"]
    base = ["--reads-format", "fastq", "-G", str(fa), "-s", None,
            "-o", None] + extra
    _run_single(tmp_path, [fq], base)
    _run_nproc(tmp_path, [fq], base)
    _assert_equal_outputs(tmp_path)
    if data == "golden":
        with open(os.path.join(DATA, "splice_sites.bed")) as fh:
            assert (tmp_path / "nproc.bed").read_text() == fh.read()
        with open(os.path.join(DATA, "stats.txt")) as fh:
            assert (tmp_path / "nproc.stats").read_text() == fh.read()


def test_nproc2_native_large_library(tmp_path):
    """~10k reads through the native path (batch-granular shard): the
    two-process output stays byte-identical over many batches."""
    from find_circ2_tpu_torch import native
    if not native.available():
        pytest.skip("native loader unavailable")
    fa, fq = _write_inputs(tmp_path, seed=17, n_circ=40, n_linear=20,
                           reads_per_junction=100, n_contiguous=800,
                           n_random=200, err_rate=0.2,
                           chrom_lengths={"chrS1": 600_000,
                                          "chrS2": 400_000})
    n_reads = sum(1 for line in open(fq) if line.startswith("@"))
    assert n_reads >= 7000
    base = ["--reads-format", "fastq", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "512"]
    _run_single(tmp_path, [fq], base)
    _run_nproc(tmp_path, [fq], base)
    _assert_equal_outputs(tmp_path)


def test_nproc2_sam_input(tmp_path):
    """--nproc with SAM text input (per-read path, islice sharding)."""
    from find_circ2_tpu_torch.io.fastq import read_fastq
    fa, fq = _write_inputs(tmp_path)
    sam = tmp_path / "r.sam"
    with open(sam, "wt") as fh:
        fh.write("@HD\tVN:1.6\n")
        for rec in read_fastq(fq):
            fh.write(f"{rec.name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                     f"{rec.seq}\t{rec.qual}\n")
    base = ["--reads-format", "sam", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "32", "--no-prefilter"]
    _run_single(tmp_path, [sam], base)
    _run_nproc(tmp_path, [sam], base)
    _assert_equal_outputs(tmp_path)


def test_nproc2_journal_resume(tmp_path):
    """--nproc with per-rank journals: the first run writes {out}.r{rank}
    with a sharding header; the rerun replays every batch and writes the
    same bytes."""
    fa, fq = _write_inputs(tmp_path)
    base = ["--reads-format", "fastq", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "8"]
    jpath = tmp_path / "run.journal"
    _run_single(tmp_path, [fq], base)
    _run_nproc(tmp_path, [fq], base, extra=["--journal", str(jpath)])
    _assert_equal_outputs(tmp_path)
    for rank in range(2):
        jf = tmp_path / f"run.journal.r{rank}"
        assert jf.exists()
        head = json.loads(jf.read_text().splitlines()[0])
        assert head == {"meta": {"nproc": 2, "proc_id": rank}}
    _run_nproc(tmp_path, [fq], base, extra=["--journal", str(jpath)],
               tag="resumed")
    assert (tmp_path / "resumed.bed").read_text() == \
        (tmp_path / "nproc.bed").read_text()
    assert (tmp_path / "resumed.stats").read_text() == \
        (tmp_path / "nproc.stats").read_text()


def test_journal_sharding_mismatch_rejected(tmp_path):
    """A journal written under one (nproc, proc_id) refuses replay under
    another; a metaless reader ignores the header."""
    from find_circ2_tpu_torch.utils.journal import RunJournal
    j = RunJournal(tmp_path / "j", meta={"nproc": 2, "proc_id": 0})
    j.record(0, [])
    RunJournal(tmp_path / "j",
               meta={"nproc": 2, "proc_id": 0}).completed_batches()
    with pytest.raises(ValueError, match="journal"):
        RunJournal(tmp_path / "j",
                   meta={"nproc": 4, "proc_id": 0}).completed_batches()
    assert 0 in RunJournal(tmp_path / "j").completed_batches()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           len(sys.argv) > 5 and sys.argv[5] == "hier")


@pytest.mark.parametrize("cards,want", [(1, [0, 0, 0]), (2, [0, 1, 0]),
                                        (4, [0, 1, 2])])
def test_nproc_rank_takes_its_own_card(monkeypatch, cards, want):
    """--nproc rank r detects on cuda:(r mod visible cards): the ranks of
    a host with several cards each take their own, and with one card they
    share it. Without --nproc the device stays as --device names it."""
    import torch

    from find_circ2_tpu_torch.cli.find_circ import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert [resolve_device("cuda", r) for r in range(3)] == [
        torch.device("cuda", i) for i in want]
    assert resolve_device("cuda") == torch.device("cuda")
    assert resolve_device("cpu", 1) == torch.device("cpu")
