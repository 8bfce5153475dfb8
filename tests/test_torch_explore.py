"""The PyTorch port's §2b multi-hit explore path (find_circ2_tpu_torch/ops/
explore, models/pipeline.DeviceExplorer and the streaming loop's explore
modes) against the reference JAX package and the CPU oracle on the CPU,
on repeat-rich RNase-R libraries. Tolerance 0: every output is an
integer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from find_circ2_tpu.config import RPAD_CODE, Config, ST_JUNCTION
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.index.hashtable import build_query_table
from find_circ2_tpu.io.twobit import seq_to_codes
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.models.aggregate import Aggregator
from find_circ2_tpu.models.oracle import anchor_candidates, call_read
from find_circ2_tpu.ops import anchor_align as ja
from find_circ2_tpu.ops import explore as jx
from find_circ2_tpu.utils.simulate import rnase_r_library
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.models.stream import run_fastq, run_reads
from find_circ2_tpu_torch.ops import anchor_align as ta
from find_circ2_tpu_torch.ops import explore as tx
from find_circ2_tpu_torch.ops.packed import pack_words
from find_circ2_tpu_torch.utils.profiling import StageTimes

CFG = Config()
CFG_1MM = dataclasses.replace(CFG, rescue_anchor_mm=1)
astuple = dataclasses.astuple
# The reference's functions, compiled once (eager op-by-op dispatch of
# the enumeration costs seconds on the CPU).
j_candidate_stats = jax.jit(ja.candidate_stats, static_argnames=("cfg",))
j_merged_candidates = jax.jit(jx.merged_candidates,
                              static_argnames=("cfg",))


def _t(x):
    return torch.from_numpy(np.array(x))


def _encode(reads):
    """(name, seq) reads -> uint8 [n, Lp] rows and int32 [n] lengths."""
    return tp.encode_batch([s for _, s in reads], len(reads),
                           CFG.max_read_len)


@pytest.fixture(scope="module")
def lib():
    """A 300 kbp RNase-R library with 40% planted repeats: its index
    (with §2b extras), the reference's and the port's device indexes,
    and its reads of valid length."""
    sim = rnase_r_library(seed=13, chrom_lengths={"chrR": 300_000},
                          n_circ=60, n_linear=8, depth_mean=4.0,
                          repeat_frac=0.4, cfg=CFG)
    index = build_index(sim.genome, CFG)
    jd = jp.DeviceIndex.build(sim.genome, index, CFG)
    reads = [r for r in sim.reads
             if 2 * CFG.anchor_len <= len(r[1]) <= CFG.max_read_len]
    return (sim, index, jd, tp.DeviceIndex.from_reference(jd, device="cpu"),
            reads)


@pytest.fixture(scope="module")
def jax_rows(lib):
    """The reference's explore rows of every read, per prefilter."""
    _, _, jd, _, reads = lib
    arr, lens = _encode(reads)
    return {pf: np.asarray(jx.explore_batch_packed(
        jd.gpacked, jd.nbases, jd.table, jd.meta, jd.ext, jd.ext_id,
        jd.chrom_offsets, jnp.asarray(arr), jnp.asarray(lens), CFG, pf))
        for pf in (True, False)}


def _port_rows(td, reads, prefilter, cfg=CFG):
    arr, lens = _encode(reads)
    return tx.explore_batch_packed(
        td.words, td.nbases, td.table, td.meta, td.ext, td.ext_id,
        td.chrom_offsets, _t(arr), _t(lens), cfg, prefilter).numpy()


def _calls(rows, reads):
    res = tp.unpack_results(rows)
    return [tp.call_from_row(res, i, n, s) for i, (n, s) in enumerate(reads)]


def test_candidate_stats_extras_match_jax(lib):
    _, _, jd, td, reads = lib
    arr, lens = _encode(reads[:256])
    for anchors in ja.read_anchors(jnp.asarray(arr), jnp.asarray(lens), CFG):
        anc = np.asarray(anchors)
        want = j_candidate_stats(jd.table, jd.meta, jnp.asarray(anc), CFG,
                                 jd.ext, jd.ext_id)
        got = ta.candidate_stats(td.table, td.meta, _t(anc), CFG, td.ext,
                                 td.ext_id)
        assert len(got) == 5
        for w, g in zip(want, got):
            assert np.array_equal(g.numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64))
        extras = got[4].numpy()
        assert extras.shape == (len(anc), 2 * (1 + 3 * CFG.anchor_len),
                                CFG.max_pair_hits - 1)
        assert (extras < 0xFFFFFFFF).any()


def test_merged_candidates_match_jax_and_oracle(lib):
    """The port's first-K candidate lists equal the reference's and
    oracle.anchor_candidates' capped (strand, pos) list for every
    anchor (as tests/test_explore.py)."""
    sim, index, jd, td, reads = lib
    reads = reads[:256]
    arr, lens = _encode(reads)
    n_multi = 0
    for side, anchors in enumerate(ta.read_anchors(_t(arr), _t(lens), CFG)):
        ca, fa, mm_v, strand_v, xa = ta.candidate_stats(
            td.table, td.meta, anchors, CFG, td.ext, td.ext_id)
        hits = ta.finalize_hits(ca, fa, mm_v, strand_v, CFG)
        pos, strand, valid = tx.merged_candidates(ca, fa, xa, mm_v, hits.mm,
                                                  CFG)
        jc = j_candidate_stats(jd.table, jd.meta,
                               jnp.asarray(anchors.numpy()), CFG, jd.ext,
                               jd.ext_id)
        jh = ja.finalize_hits(*jc[:4], CFG)
        want = j_merged_candidates(jc[0], jc[1], jc[4], jc[2], jh.mm, CFG)
        for w, g in zip(want, (pos, strand, valid)):
            assert np.array_equal(g.numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64))
        pos, strand, valid = pos.numpy(), strand.numpy(), valid.numpy()
        for i, (_, seq) in enumerate(reads):
            codes = seq_to_codes(seq)
            anchor = codes[:CFG.anchor_len] if side == 0 \
                else codes[-CFG.anchor_len:]
            _, pairs = anchor_candidates(sim.genome, index, anchor, CFG)
            got = [(int(strand[i, k]), int(pos[i, k]))
                   for k in range(CFG.max_pair_hits) if valid[i, k]]
            assert got == pairs, (i, side, got, pairs)
            n_multi += len(pairs) > 1
    assert n_multi >= 30, f"library too tame: {n_multi} multi anchors"


@pytest.mark.parametrize("prefilter", [True, False])
def test_explore_rows_match_jax(lib, jax_rows, prefilter):
    _, _, _, td, reads = lib
    got = _port_rows(td, reads, prefilter)
    assert got.dtype == np.int32 and got.shape == (len(reads), 14)
    assert np.array_equal(got, jax_rows[prefilter])
    status = got[:, 0]
    assert (status == ST_JUNCTION).sum() > 20
    assert (got[:, 12] == 0).all()


def test_explore_equals_oracle_without_rescue(lib, jax_rows):
    """ReadCall equality with the oracle on every read, with the 2-mm
    rescue off (the explore program's <=1-mm contract; production routes
    rescuable reads to the host first), as tests/test_explore.py."""
    sim, index, _, td, reads = lib
    got = _calls(_port_rows(td, reads, True, CFG_1MM), reads)
    for (name, seq), g in zip(reads, got):
        assert astuple(g) == astuple(call_read(sim.genome, index, name, seq,
                                               CFG_1MM)), name
    # Multi reads: an anchor's best hit ties (detect's multi bit 0).
    multi = tp.unpack_results(tp.dispatch_packed(
        td, *_encode(reads), CFG).numpy())["multi"] & 1
    assert multi.sum() >= 20, f"library must exercise multi reads: {multi}"


def test_explore_on_decoy_case():
    """The planted decoy of tests/test_multihit._setup resolves to the
    true junction, as the reference and the oracle resolve it."""
    from tests.test_multihit import TRUE_E, TRUE_S, _setup
    genome, index, read_seq = _setup()
    td = tp.DeviceIndex.build(genome, index, CFG, device="cpu")
    [got] = _calls(_port_rows(td, [("r", read_seq)], True), [("r", read_seq)])
    assert astuple(got) == astuple(call_read(genome, index, "r", read_seq,
                                             CFG))
    gap = CFG.chrom_gap
    assert (got.start - gap, got.end - gap) == (TRUE_S, TRUE_E)


def _synthetic_hits(rng, B, pos_pool):
    aligned = rng.random(B) < 0.9
    pos = rng.choice(pos_pool, size=B).astype(np.uint32)
    fields = dict(aligned=aligned, pos=pos,
                  strand=rng.integers(0, 3, B).astype(np.int32),
                  mm=rng.integers(0, 2, B).astype(np.int32),
                  n_best=rng.integers(1, 4, B).astype(np.int32),
                  second_mm=rng.integers(0, 2, B).astype(np.int32),
                  qual=rng.integers(0, 41, B).astype(np.int32))
    jh = ja.AnchorHits(**{k: jnp.asarray(v) for k, v in fields.items()})
    th = ta.AnchorHits(**{k: _t(v.astype(np.int64) if k == "pos" else v)
                          for k, v in fields.items()})
    return jh, th


def test_explore_core_positions_above_2gb_match_jax():
    """explore_core on synthetic candidates at positions >= 2^31, next to
    2^32 (where pB + a wraps) and LARGE_POS lanes, on a second
    chromosome that starts at 3e9: every output field equals the
    reference's (uint32 wrap-around included)."""
    rng = np.random.default_rng(29)
    B, K, Lp, a = 48, CFG.max_pair_hits, CFG.max_read_len, CFG.anchor_len
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    from find_circ2_tpu.ops.packed import pack_nibbles
    base = 3_000_000_000
    offsets = np.array([0, base], np.uint32)
    near = base + rng.integers(0, 3000, 64)
    wrap = 2 ** 32 - 1 - rng.integers(1, 60, 16)
    pool = np.concatenate([near, wrap, [2 ** 31 + 5, 0xFFFFFFFF]])
    reads = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    lens = rng.integers(2 * a, Lp + 1, B).astype(np.int32)
    for i in range(B):
        reads[i, lens[i]:] = RPAD_CODE

    def cands():
        pos = np.sort(rng.choice(pool, size=(B, K)), axis=1).astype(np.int64)
        valid = rng.random((B, K)) < 0.7
        pos = np.where(valid, pos, 0xFFFFFFFF)
        strand = np.where(valid, rng.integers(0, 2, (B, K)), 0)
        return pos, strand.astype(np.int32), valid

    (pA, sA, vA), (pB, sB, vB) = cands(), cands()
    jha, tha = _synthetic_hits(rng, B, pool)
    jhb, thb = _synthetic_hits(rng, B, pool)
    core = jax.jit(jx.explore_core,
                   static_argnames=("nbases", "cfg", "prefilter"))
    for prefilter in (True, False):
        want = core(
            jnp.asarray(pack_nibbles(codes)), codes.size, jnp.asarray(offsets),
            jnp.asarray(reads), jnp.asarray(lens), jha, jhb,
            jnp.asarray(pA.astype(np.uint32)), jnp.asarray(sA),
            jnp.asarray(vA), jnp.asarray(pB.astype(np.uint32)),
            jnp.asarray(sB), jnp.asarray(vB), cfg=CFG, prefilter=prefilter)
        got = tx.explore_core(
            _t(pack_words(codes)), codes.size, _t(offsets.astype(np.int64)),
            _t(reads), _t(lens), tha, thb, _t(pA), _t(sA), _t(vA), _t(pB),
            _t(sB), _t(vB), CFG, prefilter)
        assert set(got) == set(want)
        for key in want:
            w = np.asarray(want[key]).astype(np.int64)
            assert np.array_equal(got[key].numpy().astype(np.int64), w), key
    junction = np.asarray(want["status"]) == ST_JUNCTION
    assert junction.sum() >= 5
    assert (np.asarray(want["start"])[junction] > 2 ** 31).all()


@pytest.mark.parametrize("mode", ["reads", "arrays"])
def test_device_explorer_crosses_chunk_boundary(lib, jax_rows, mode):
    """More than BUCKETS[-1] routed reads split into a full chunk and a
    padded one; the result arrays ("arrays"), and the ReadCalls the
    streaming loop makes of them ("reads"), are the reference's rows in
    order."""
    _, _, _, td, reads = lib
    n = tp.DeviceExplorer.BUCKETS[-1] + 77
    reps = -(-n // len(reads))
    items = (reads * reps)[:n]
    want = np.tile(jax_rows[True], (reps, 1))[:n]
    ex = tp.DeviceExplorer(td, CFG)
    arr, lens = _encode(items)
    chunks = ex.dispatch_arrays(arr, lens)
    assert [c for c, _ in chunks] == [1024, 77]
    got = ex.fetch_arrays(chunks)
    if mode == "reads":
        assert [tp.call_from_row(got, i, *r) for i, r in enumerate(items)] \
            == _calls(want, items)
    else:
        ref = tp.unpack_results(want)
        assert set(got) == set(ref)
        for key in ref:
            assert np.array_equal(got[key], ref[key]), key


@pytest.fixture(scope="module")
def oracle_calls(lib):
    """The oracle's calls of the library's first 200 reads."""
    sim, index, _, _, _ = lib
    return [call_read(sim.genome, index, n, s, CFG)
            for n, s in sim.reads[:200]]


@pytest.mark.parametrize("explore", [None, False])
def test_run_reads_explore_modes_match_oracle(lib, oracle_calls, explore):
    """run_reads with the device explorer (None: the index has extras)
    and with the host twin (False) equals the oracle read for read, the
    2-mm rescue on."""
    sim, index, _, td, _ = lib
    times = StageTimes()
    calls = run_reads(td, sim.reads[:200], CFG, batch_size=64,
                      times=times, slowpath=(sim.genome, index),
                      explore=explore)
    assert [astuple(c) for c in calls] == [astuple(c) for c in oracle_calls]
    ran = "explore_dispatch" if explore is None else "slowpath_multihit"
    gone = "slowpath_multihit" if explore is None else "explore_dispatch"
    assert ran in times.counts and gone not in times.counts


@pytest.mark.parametrize("entry", ["run_reads", "run_fastq"])
def test_explore_true_without_extras_raises(tmp_path, entry):
    sim = rnase_r_library(seed=3, chrom_lengths={"chrR": 50_000}, n_circ=4,
                          n_linear=1, depth_mean=2.0, cfg=CFG)
    index = build_index(sim.genome, CFG)
    index.qtable = build_query_table(index, CFG, extras=False)
    td = tp.DeviceIndex.build(sim.genome, index, CFG, device="cpu")
    assert td.ext is None and td.ext_id is None
    slowpath = (sim.genome, index)
    with pytest.raises(ValueError, match="extras"):
        if entry == "run_reads":
            run_reads(td, sim.reads, CFG, slowpath=slowpath, explore=True)
        else:
            fq = tmp_path / "r.fastq"
            fq.write_text("@r\n" + "ACGT" * 20 + "\n+\n" + "I" * 80 + "\n")
            run_fastq(td, fq, Aggregator(sim.genome, CFG), CFG,
                      slowpath=slowpath, explore=True)
