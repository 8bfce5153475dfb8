"""The port's sharded engine (find_circ2_tpu_torch/parallel) against the
reference's on the CPU, case for case with tests/test_sharded.py: the
reference runs on its 8 virtual CPU devices (conftest.py), the port on
an 8-slot mesh of the one CPU device. Results equal the reference's
engine and the port's single-device step. Tolerance 0."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import jax

from find_circ2_tpu.config import RPAD_CODE, Config
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.io.twobit import seq_to_codes
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.parallel.mesh import make_hier_mesh as jmake_hier_mesh
from find_circ2_tpu.parallel.mesh import make_mesh as jmake_mesh
from find_circ2_tpu.parallel.sharded import ShardedEngine as JEngine
from find_circ2_tpu.utils.simulate import simulate
from find_circ2_tpu_torch.cli import main as cli_main
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.ops.anchor_align import key_ranges
from find_circ2_tpu_torch.ops.merge import merge_junctions
from find_circ2_tpu_torch.parallel.mesh import make_hier_mesh, make_mesh
from find_circ2_tpu_torch.parallel.sharded import ShardedEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "test_data")
CFG = Config(batch_size=64)
CPU8 = ["cpu"] * 8


def _batchify(reads, cfg, bs):
    arr = np.full((bs, cfg.max_read_len), RPAD_CODE, np.uint8)
    lens = np.zeros(bs, np.int32)
    kept = [(n, s) for n, s in reads
            if 2 * cfg.anchor_len <= len(s) <= cfg.max_read_len][:bs]
    for i, (_, s) in enumerate(kept):
        codes = seq_to_codes(s)
        arr[i, :codes.size] = codes
        lens[i] = codes.size
    return arr, lens


def _single(sim, idx, reads, lens, cfg=CFG):
    """The port's single-device classic detect_batch, on host arrays."""
    td = tp.DeviceIndex.build(sim.genome, idx, cfg, device="cpu")
    res = tp.detect_batch(td.words, td.nbases, td.table, td.meta,
                          td.chrom_offsets, torch.from_numpy(reads),
                          torch.from_numpy(lens), cfg, True)
    return res, {k: v.numpy() for k, v in res.items()}


def _equal_live(a, b, lens, what):
    live = lens > 0
    for key in a:
        mask = live[:, None] if key == "signal" else live
        assert np.array_equal(np.where(mask, a[key], 0),
                              np.where(mask, b[key], 0)), (key, what)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1), (4, 2)])
def test_sharded_matches_single_chip(shape):
    sim = simulate(seed=33, n_circ=5, n_linear=3, reads_per_junction=3,
                   n_contiguous=10, n_random=6, err_rate=0.3)
    idx = build_index(sim.genome, CFG)
    reads, lens = _batchify(sim.reads, CFG, 64)
    _, single = _single(sim, idx, reads, lens)

    eng = ShardedEngine(sim.genome, idx, make_mesh(8, shape, CPU8), CFG,
                        prefilter=True)
    assert eng.fast and eng.n_data == shape[0]
    # One copy of each shard however many data rows share the device;
    # each shard owns the keys of its prefix range.
    copies = {id(s.table) for row in eng.rows for s in row.shards}
    assert len(copies) == shape[1]
    assert all([s.owns for s in row.shards] == key_ranges(idx.n_buckets,
                                                          shape[1])
               for row in eng.rows)
    got = eng.detect(reads, lens)
    want = JEngine(sim.genome, idx, jmake_mesh(8, shape=shape), CFG,
                   prefilter=True).detect(reads, lens)
    assert set(got) == set(want) == set(single)
    for key in want:
        assert np.array_equal(got[key], np.asarray(want[key])), (key, shape)
    _equal_live(got, single, lens, shape)


def test_distributed_helpers():
    from find_circ2_tpu_torch.parallel.distributed import (global_mesh,
                                                           host_read_slice)
    mesh = global_mesh(devices=CPU8)
    assert set(mesh.axis_names) == {"data", "index"}
    assert mesh.devices.size == len(jax.devices()) == 8
    assert mesh.shape == {"data": 1, "index": 8}
    mesh2 = global_mesh(index_parallel=2, devices=CPU8)
    assert mesh2.shape["index"] == 2
    # Contiguous, covering, near-even host split.
    slices = [host_read_slice(103, h, 4) for h in range(4)]
    assert slices[0][0] == 0 and slices[-1][1] == 103
    for (a0, a1), (b0, b1) in zip(slices, slices[1:]):
        assert a1 == b0
    from find_circ2_tpu.parallel.distributed import \
        host_read_slice as jhost_read_slice
    assert slices == [jhost_read_slice(103, h, 4) for h in range(4)]


def test_hierarchical_merge_matches_flat():
    """(dhost, data, index) hierarchical merge equals the flat (data,
    index) merge, the single-device merge of the same batch and the
    reference's engines, on the valid rows."""
    sim = simulate(seed=34, n_circ=6, n_linear=3, reads_per_junction=4,
                   n_contiguous=8, n_random=4, err_rate=0.3)
    idx = build_index(sim.genome, CFG)
    reads, lens = _batchify(sim.reads, CFG, 64)

    flat = ShardedEngine(sim.genome, idx, make_mesh(8, (4, 2), CPU8),
                         CFG).detect_merged(reads, lens)
    hier = ShardedEngine(sim.genome, idx, make_hier_mesh(2, 2, 2, CPU8),
                         CFG).detect_merged(reads, lens)
    jflat = JEngine(sim.genome, idx, jmake_mesh(8, shape=(4, 2)),
                    CFG).detect_merged(reads, lens)
    jhier = JEngine(sim.genome, idx, jmake_hier_mesh(2, 2, 2),
                    CFG).detect_merged(reads, lens)

    res, _ = _single(sim, idx, reads, lens)
    single = {k: v.numpy() for k, v in
              merge_junctions(res, torch.from_numpy(lens), CFG).items()}

    n = int(single["valid"].sum())
    assert n > 0
    for k in single:
        s = single[k][:n]
        assert np.array_equal(flat[k][:n], s), (k, "flat")
        assert np.array_equal(hier[k][:n], s), (k, "hier")
        assert np.array_equal(np.asarray(jflat[k])[:n], s), (k, "jax flat")
        assert np.array_equal(np.asarray(jhier[k])[:n], s), (k, "jax hier")
    for table in (flat, hier):
        assert int(table["valid"].sum()) == n
        assert table["valid"].shape == (64,)


def test_overflow_redo_matches_classic():
    """A fallback slice of 2 anchors overflows on a library with error
    anchors: the packed rows carry multi bit 3 on every data row,
    redo_packed gives the classic rows of the single device and of the
    reference's engine, and detect redoes the batch by itself."""
    cfg = dataclasses.replace(CFG, exact_fallback_slots=2)
    sim = simulate(seed=33, n_circ=5, n_linear=3, reads_per_junction=3,
                   n_contiguous=10, n_random=6, err_rate=0.3)
    idx = build_index(sim.genome, cfg)
    reads, lens = _batchify(sim.reads, cfg, 64)
    eng = ShardedEngine(sim.genome, idx, make_mesh(8, (2, 4), CPU8), cfg)
    jeng = JEngine(sim.genome, idx, jmake_mesh(8, shape=(2, 4)), cfg)
    packed = eng.dispatch_packed(reads, lens).numpy()
    assert (tp.unpack_results(packed)["multi"] & 8).all()
    assert np.array_equal(packed, np.asarray(jeng.dispatch_packed(reads,
                                                                  lens)))
    redo = eng.redo_packed(reads, lens).numpy()
    assert np.array_equal(redo, np.asarray(jeng.redo_packed(reads, lens)))
    td = tp.DeviceIndex.build(sim.genome, idx, cfg, device="cpu")
    classic = tp.detect_batch_packed(
        td.words, td.nbases, td.table, td.meta, td.chrom_offsets,
        torch.from_numpy(reads), torch.from_numpy(lens), cfg,
        True).numpy()
    assert np.array_equal(redo, classic)
    got = eng.detect(reads, lens)
    assert not (got["multi"] & 8).any()
    _equal_live(got, tp.unpack_results(classic), lens, "detect")


def test_streaming_loops_redo_through_engine(tmp_path):
    """run_reads and run_fastq with the engine's dispatch and redo, on a
    fallback slice of 2 anchors that overflows every batch: the redo
    keeps run_reads equal to the oracle read for read, and run_fastq's
    BED and stats equal the single device's."""
    from find_circ2_tpu_torch.io.bed import write_bed
    from find_circ2_tpu_torch.models.aggregate import Aggregator
    from find_circ2_tpu_torch.models.oracle import call_read
    from find_circ2_tpu_torch.models.stream import run_fastq, run_reads
    cfg = dataclasses.replace(CFG, exact_fallback_slots=2)
    sim = simulate(seed=33, n_circ=5, n_linear=3, reads_per_junction=3,
                   n_contiguous=10, n_random=6, err_rate=0.3)
    idx = build_index(sim.genome, cfg)
    slowpath = (sim.genome, idx)
    eng = ShardedEngine(sim.genome, idx, make_mesh(8, (2, 4), CPU8), cfg)
    redone = []

    def redo(arr, lens):
        redone.append(arr.shape[0])
        return eng.redo_packed(arr, lens)

    hooks = dict(dispatch=eng.dispatch_packed, redo=redo)
    calls = run_reads(None, sim.reads, cfg, slowpath=slowpath, **hooks)
    assert redone and len(calls) == len(sim.reads)
    for (name, seq), c in zip(sim.reads, calls):
        assert dataclasses.astuple(c) == dataclasses.astuple(
            call_read(sim.genome, idx, name, seq, cfg)), name
    _, fq = _write_inputs(tmp_path, sim)
    td = tp.DeviceIndex.build(sim.genome, idx, cfg, device="cpu")
    out = []
    for dindex, kw in ((None, hooks), (td, {})):
        agg = Aggregator(sim.genome, cfg)
        run_fastq(dindex, fq, agg, cfg, slowpath=slowpath, **kw)
        buf = io.StringIO()
        write_bed(buf, agg.rows("s"))
        out.append((buf.getvalue(), sorted(agg.stats.counts.items())))
    assert out[0] == out[1] and "circ_" in out[0][0]


def test_coincident_probe_buckets():
    """A table key whose two cuckoo buckets are one bucket matches both
    probes, so the single table's K1 counts it twice: the port as the
    reference, bit for bit. The engine's shards place the key in two
    buckets and count it once, as the oracle does; on every other anchor
    the three agree (ROADMAP.md §3)."""
    from find_circ2_tpu.index import hashtable as jht
    from find_circ2_tpu.models.oracle import align_anchor
    from find_circ2_tpu.ops.anchor_align import align_anchors as jalign
    from find_circ2_tpu.utils.simulate import rnase_r_library
    from find_circ2_tpu_torch.ops import anchor_align as ta
    a = CFG.anchor_len
    sim = rnase_r_library(seed=7, chrom_lengths={"chrR": 400_000},
                          n_circ=100, n_linear=20, cfg=CFG)
    g = sim.genome
    idx = build_index(g, CFG)
    qt = idx.qtable = jht.build_query_table(idx, CFG, extras=False)
    tab = qt.table.reshape(-1, jht.LANES)
    occ = np.flatnonzero(tab[:, 0] != jht.EMPTY_KEY)
    h1, h2 = (jht.mix_hash(tab[occ, 0].astype(np.uint32),
                           (tab[occ, 1] & jht.S8_MASK).astype(np.uint32),
                           s).astype(np.int64) % int(qt.meta[2])
              for s in np.asarray(qt.meta[:2], np.int32).view(np.uint32))
    # The 20-mers at the genome positions of such keys, then the first
    # anchors of some reads.
    pos = tab[occ[h1 == h2], 2:4].view(np.uint32).min(axis=1).astype(
        np.int64)
    pos = pos[pos + a <= len(g)]
    assert pos.size >= 2
    anchors = np.stack([g.codes[p:p + a] for p in pos]
                       + [_batchify(sim.reads, CFG, 16)[0][i, :a]
                          for i in range(16)])
    n_co = pos.size

    single = tp.DeviceIndex.build(g, idx, CFG, device="cpu")
    got = ta.align_anchors(single.table, single.meta,
                           torch.from_numpy(anchors), CFG)
    jd = jp.DeviceIndex.build(g, idx, CFG)
    want = jalign(jd.table, jd.meta, anchors, CFG)
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), np.asarray(y))
    eng = ShardedEngine(g, idx, make_mesh(2, (1, 2), ["cpu"] * 2), CFG,
                        exact_first=False)
    sharded = ta.align_anchors_sharded(eng.rows[0].shards,
                                       torch.from_numpy(anchors), CFG)
    for i, anchor in enumerate(anchors):
        hit = align_anchor(g, idx, anchor, CFG)
        assert (bool(sharded.aligned[i]), int(sharded.n_best[i]),
                int(sharded.mm[i]), int(sharded.qual[i])) == (
            hit.aligned, hit.n_best, hit.mm, hit.qual), i
        # The double count: twice the oracle's n_best at the coincident
        # keys, the oracle's everywhere else.
        assert int(got.n_best[i]) == hit.n_best * (2 if i < n_co else 1), i


def _write_inputs(tmp_path, sim):
    from find_circ2_tpu.io.fasta import write_fasta
    from find_circ2_tpu.io.fastq import FastqRecord, write_fastq
    from find_circ2_tpu.io.twobit import codes_to_seq
    fa = tmp_path / "g.fa"
    write_fasta(fa, [(n, codes_to_seq(
        sim.genome.codes[sim.genome.chrom_offsets[i]:
                         sim.genome.chrom_offsets[i]
                         + sim.genome.chrom_lengths[i]]))
        for i, n in enumerate(sim.genome.chrom_names)])
    fq = tmp_path / "r.fastq"
    with open(fq, "wt") as fh:
        for name, seq in sim.reads:
            write_fastq(fh, FastqRecord(name, seq, "I" * len(seq)))
    return fa, fq


def test_sharded_cli_byte_identical(tmp_path):
    """find_circ --mesh 2x4 --device cpu gives the bytes of the port's
    single-device run and of the reference's --mesh 2x4 run."""
    from find_circ2_tpu.cli import main as ref_main
    sim = simulate(seed=35, n_circ=4, n_linear=2, reads_per_junction=3,
                   n_contiguous=8, n_random=4, err_rate=0.3)
    fa, fq = _write_inputs(tmp_path, sim)

    def run(main, tag, extra):
        bed = tmp_path / f"{tag}.bed"
        st = tmp_path / f"{tag}.stats"
        rc = main.main(["find_circ", str(fq), "-G", str(fa),
                        "--reads-format", "fastq", "-o", str(bed),
                        "-s", str(st), "--batch-size", "64"] + extra)
        assert rc == 0
        return bed.read_text(), st.read_text()

    single = run(cli_main, "single", ["--device", "cpu"])
    sharded = run(cli_main, "sharded", ["--mesh", "2x4", "--device", "cpu"])
    assert sharded == single
    assert sharded == run(ref_main, "ref", ["--mesh", "2x4"])
    assert "circ_" in single[0]


@pytest.mark.parametrize("reads_format", ["fastq", "sam"])
def test_sharded_cli_reproduces_golden(tmp_path, reads_format):
    """--mesh 2x4 --device cpu on test_data/ writes the golden BED and
    stats: the native streaming loop (fastq) and the per-read loop
    (the same reads as SAM)."""
    reads = os.path.join(DATA, "reads.fastq")
    if reads_format == "sam":
        from find_circ2_tpu.io.fastq import read_fastq
        sam = tmp_path / "r.sam"
        with open(sam, "wt") as fh:
            fh.write("@HD\tVN:1.6\n")
            for rec in read_fastq(reads):
                fh.write(f"{rec.name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                         f"{rec.seq}\t{rec.qual}\n")
        reads = str(sam)
    bed, st = tmp_path / "out.bed", tmp_path / "out.stats"
    assert cli_main.main([
        "find_circ", reads, "-G", os.path.join(DATA, "genome.fa"),
        "--reads-format", reads_format, "--device", "cpu", "--mesh", "2x4",
        "-n", "golden", "--batch-size", "64", "-o", str(bed),
        "-s", str(st)]) == 0
    with open(os.path.join(DATA, "splice_sites.bed")) as fh:
        assert bed.read_text() == fh.read()
    with open(os.path.join(DATA, "stats.txt")) as fh:
        assert st.read_text() == fh.read()
