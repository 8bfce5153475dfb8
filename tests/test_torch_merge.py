"""The port's junction merge (find_circ2_tpu_torch/ops/merge.py, K-h)
against the reference's on the CPU, case for case with
tests/test_merge.py, plus every one of the N output rows (fill rows
included) on synthetic tables with uint32 starts above 2^31. Tolerance
0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from find_circ2_tpu.config import Config, ST_JUNCTION
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.ops import merge as jm
from find_circ2_tpu.parallel.mesh import make_mesh as jmake_mesh
from find_circ2_tpu.parallel.sharded import ShardedEngine as JEngine
from find_circ2_tpu.utils.simulate import simulate
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.models.aggregate import Aggregator
from find_circ2_tpu_torch.models.stream import run_reads
from find_circ2_tpu_torch.ops import merge as tm
from find_circ2_tpu_torch.parallel.mesh import make_mesh
from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
from tests.test_torch_sharded import _batchify

CFG = Config(batch_size=128)


def _detect(sim, idx, reads, lens):
    """The port's and the reference's detect_batch on one batch."""
    td = tp.DeviceIndex.build(sim.genome, idx, CFG, device="cpu")
    got = tp.detect_batch(td.words, td.nbases, td.table, td.meta,
                          td.chrom_offsets, torch.from_numpy(reads),
                          torch.from_numpy(lens), CFG, True)
    jd = jp.DeviceIndex.build(sim.genome, idx, CFG)
    want = jp.detect_batch(jd.gpacked, jd.nbases, jd.table, jd.meta,
                           jd.chrom_offsets, reads, lens, CFG, True)
    return td, got, want


def _assert_tables_equal(got: dict, want: dict) -> None:
    """All N rows of every field, values and shapes."""
    assert set(got) == set(want) == set(tm.ALL_FIELDS)
    for k in tm.ALL_FIELDS:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.array_equal(g, w), (k, g[:8], w[:8])


def test_device_merge_matches_host_aggregation():
    sim = simulate(seed=41, n_circ=5, n_linear=3, reads_per_junction=4,
                   n_contiguous=8, n_random=4, err_rate=0.3)
    idx = build_index(sim.genome, CFG)
    reads, lens = _batchify(sim.reads, CFG, 128)
    td, res, jres = _detect(sim, idx, reads, lens)
    for k in jres:
        assert np.array_equal(res[k].numpy(), np.asarray(jres[k])), k
    agg = Aggregator(sim.genome, CFG)
    for c in run_reads(td, sim.reads, CFG):
        agg.add(c)
    table = {k: v.numpy() for k, v in
             tm.merge_junctions(res, torch.from_numpy(lens), CFG).items()}
    _assert_tables_equal(table, jm.merge_junctions(jres, jnp.asarray(lens),
                                                   CFG))
    n_valid = int(table["valid"].sum())
    host = agg.table()
    host_keys = list(zip(*(host[f].tolist() for f in
                           ("kind", "chrom", "start", "end", "sense"))))
    assert n_valid == len(host_keys)
    by_key = {}
    for i in range(n_valid):
        key = (int(table["kind"][i]), int(table["chrom"][i]),
               int(table["start"][i]), int(table["end"][i]),
               int(table["sense"][i]))
        by_key[key] = i
    assert set(by_key) == set(host_keys)
    for g, key in enumerate(host_keys):
        i = by_key[key]
        for f in ("n_reads", "uniq_bridges", "best_qual_left",
                  "best_qual_right", "edits", "overlap", "n_bp",
                  "n_strand_match"):
            assert int(table[f][i]) == int(host[f][g]), (key, f)
    keys = sorted(by_key, key=lambda k: by_key[k])
    assert keys == sorted(keys)


def test_sharded_collective_merge_matches_single_device():
    sim = simulate(seed=43, n_circ=6, n_linear=2, reads_per_junction=4,
                   n_contiguous=6, n_random=4, err_rate=0.2)
    idx = build_index(sim.genome, CFG)
    reads, lens = _batchify(sim.reads, CFG, 64)
    _, res, _ = _detect(sim, idx, reads, lens)
    single = {k: v.numpy() for k, v in
              tm.merge_junctions(res, torch.from_numpy(lens), CFG).items()}
    nv = int(single["valid"].sum())
    assert nv > 0

    for shape in ((2, 4), (4, 2)):
        eng = ShardedEngine(sim.genome, idx, make_mesh(8, shape, ["cpu"] * 8),
                            CFG)
        merged = eng.detect_merged(reads, lens)
        assert int(merged["valid"].sum()) == nv
        for name in single:
            assert np.array_equal(single[name][:nv], merged[name][:nv]), \
                (shape, name)
        # The reference's engine on the same mesh shape: all 64 rows.
        _assert_tables_equal(merged, JEngine(
            sim.genome, idx, jmake_mesh(8, shape=shape),
            CFG).detect_merged(reads, lens))


def _synthetic(seed: int, n: int) -> tuple[dict, np.ndarray]:
    """A detect result of n rows with few distinct keys (so segments
    merge), starts and ends on both sides of 2^31, dead rows of every
    kind (other statuses, multi-flagged, padding) and int32 fields
    spanning their ranges."""
    rng = np.random.default_rng(seed)
    big = np.array([5, 2 ** 31 - 3, 2 ** 31, 2 ** 31 + 9, 2 ** 32 - 7],
                   np.uint32)
    res = dict(
        status=np.where(rng.random(n) < 0.7, ST_JUNCTION,
                        rng.integers(1, 9, n)).astype(np.int32),
        kind=rng.integers(0, 2, n).astype(np.int32),
        chrom=rng.integers(0, 3, n).astype(np.int32),
        start=rng.choice(big, n),
        end=rng.choice(big, n),
        sense=rng.integers(0, 2, n).astype(np.int32),
        align_strand=rng.integers(0, 2, n).astype(np.int32),
        qual_left=rng.integers(0, 41, n).astype(np.int32),
        qual_right=rng.integers(0, 41, n).astype(np.int32),
        edits=rng.integers(0, 6, n).astype(np.int32),
        overlap=rng.integers(0, 30, n).astype(np.int32),
        n_bp=rng.integers(1, 4, n).astype(np.int32),
        multi=(rng.random(n) < 0.1).astype(np.int32),
    )
    lens = np.where(rng.random(n) < 0.9, 100, 0).astype(np.int32)
    return res, lens


def _port(res: dict) -> dict:
    """Host arrays as the port's detect results hold them (positions as
    int64)."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v) for k, v in res.items()}


@pytest.mark.parametrize("seed,n", [(0, 64), (1, 257), (2, 1000)])
def test_merge_junctions_all_rows_match_jax(seed, n):
    res, lens = _synthetic(seed, n)
    got = tm.merge_junctions(_port(res), torch.from_numpy(lens), CFG)
    want = jm.merge_junctions({k: jnp.asarray(v) for k, v in res.items()},
                              jnp.asarray(lens), CFG)
    _assert_tables_equal(got, want)
    assert 0 < int(got["valid"].sum()) < n
    assert (got["start"][got["valid"]] >= 2 ** 31).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_tables_all_rows_match_jax(seed):
    """K merged tables stacked [K, N] (an all_gather) re-merge to the
    reference's K*N rows."""
    K, n = 4, 96
    jt, tt = [], []
    for k in range(K):
        res, lens = _synthetic(seed * 10 + k, n)
        jt.append(jm.merge_junctions({a: jnp.asarray(v)
                                      for a, v in res.items()},
                                     jnp.asarray(lens), CFG))
        tt.append(tm.merge_junctions(_port(res), torch.from_numpy(lens),
                                     CFG))
    got = tm.merge_tables({f: torch.stack([t[f] for t in tt])
                           for f in tm.ALL_FIELDS})
    want = jm.merge_tables({f: jnp.stack([t[f] for t in jt])
                            for f in jm.ALL_FIELDS})
    _assert_tables_equal(got, want)
    assert got["valid"].shape == (K * n,)
