"""The sharded engine's K1 (find_circ2_tpu_torch/ops/anchor_align
`*_sharded`): on the CPU its plain parts, and the plain versions of the
card's record layout and finish (exact_records_ref, classic_records_ref
and shard_finish_ref, run through the card's orchestration), against the
JAX package's exact_anchor_stats, align_anchors and
align_anchor_pair_fast with axis_name="index" under jax.shard_map on
conftest's 8 virtual CPU devices, at 1, 2, 4 and 8 index shards from
shard_query_table; the wrappers' routing (tensors off the CPU reach the
stubbed C calls of the partials modes, csrc/shard_k1.cu and the
compaction) and the kernels' argument layouts and constants. The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cards.py and chip_smoke.py. Tolerance 0: every output
is an integer."""

import dataclasses
import os
import re
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from find_circ2_tpu.config import Config
from find_circ2_tpu.ops import anchor_align as ja
from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.ops import anchor_align as ta
from find_circ2_tpu_torch.utils import detect_cases

CFG = Config()
CASE_ROWS = 96
CSRC = os.path.join(os.path.dirname(ta.__file__), os.pardir, "csrc")


@pytest.fixture(scope="module")
def case():
    return detect_cases.detect_case(2, CASE_ROWS, CFG)


@pytest.fixture(scope="module")
def shards(case):
    return detect_cases.shard_tables(case, detect_cases.SHARD_COUNTS, CFG)


def _jax_sharded(fn, tables, ntables, metas, *args):
    """fn(table, ntable, meta, *args) per index shard under shard_map,
    one shard a virtual device, its outputs replicated."""
    S = tables.shape[0]
    mesh = Mesh(np.array(jax.devices()[:S]), ("index",))

    def body(t, nt, m, *a):
        return fn(t[0], nt[0], m[0], *a)

    run = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("index"),) * 3 + (P(),) * len(args),
        out_specs=P(), check_vma=False))
    return run(tables, ntables, metas, *args)


def _same(got, want):
    got, want = (jax.tree_util.tree_leaves(x) for x in (got, want))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert np.array_equal(x.astype(np.int64),
                              np.asarray(y).astype(np.int64))


def _both_paths(fn, monkeypatch):
    """fn() on the plain parts, then on the card's orchestration with the
    plain records and finish (the CPU tensors take each wrapper's plain
    version)."""
    plain = fn()
    with monkeypatch.context() as m:
        m.setattr(ta, "_all_cpu", lambda *a: False)
        records = fn()
    return plain, records


def _port_shards(tables, ntables, metas):
    return detect_cases.shard_args(tables, ntables, metas,
                                   ["cpu"] * tables.shape[0])


@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
def test_exact_shards_match_jax(case, shards, S, monkeypatch):
    """exact_anchor_stats over S shards: hits and `resolved` of every
    anchor of the case (pinned, DIRTY_AT, a guarded repeat among them)
    equal the reference's psum/pmin; the records show a count above
    max_bucket, so the guard after the combine is exercised."""
    tables, ntables, metas = shards[S]
    sh = _port_shards(tables, ntables, metas)
    anchors = torch.from_numpy(case.anchors)
    want = _jax_sharded(partial(ja.exact_anchor_stats, cfg=CFG,
                                axis_name="index"),
                        tables, ntables, metas, case.anchors)
    for got in _both_paths(lambda: ta.exact_anchor_stats_sharded(
            sh, anchors, CFG), monkeypatch):
        _same(got, want)
    records = torch.stack([ta.exact_records(*s[:3], anchors, CFG,
                                            owns=s.owns) for s in sh])
    assert records.shape == (S, anchors.shape[0], ta.EXACT_FIELDS)
    assert (records[:, :, 1] + records[:, :, 3]).amax() > CFG.max_bucket
    # Each key lives on one shard: found at most once an anchor.
    assert int(records[:, :, 0].sum(0).max()) == 1
    resolved = want[1]
    assert not np.asarray(resolved).all()


@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
def test_classic_shards_match_jax(case, shards, S, monkeypatch):
    """align_anchors over S shards equals the reference's finalize_hits
    with psum/pmin on every anchor of the case."""
    tables, ntables, metas = shards[S]
    sh = _port_shards(tables, ntables, metas)
    anchors = torch.from_numpy(case.anchors)
    want = _jax_sharded(
        lambda t, nt, m, a: ja.align_anchors(t, m, a, CFG,
                                             axis_name="index"),
        tables, ntables, metas, case.anchors)
    for got in _both_paths(lambda: ta.align_anchors_sharded(sh, anchors,
                                                            CFG),
                           monkeypatch):
        _same(got, want)


@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
@pytest.mark.parametrize("slots", [4, 1024])
def test_fast_pair_shards_match_jax(case, shards, S, slots, monkeypatch):
    """align_anchor_pair_fast over S shards, the fallback slice in slot
    mode: with 4 slots more anchors are unresolved than the slice holds
    (overflow), with 1024 every anchor is in it."""
    cfg = dataclasses.replace(CFG, exact_fallback_slots=slots)
    tables, ntables, metas = shards[S]
    sh = _port_shards(tables, ntables, metas)
    half = case.anchors.shape[0] // 2
    a, b = case.anchors[:half], case.anchors[half:2 * half]
    want = _jax_sharded(
        lambda t, nt, m, x, y: ja.align_anchor_pair_fast(
            t, nt, m, x, y, cfg, axis_name="index"),
        tables, ntables, metas, a, b)
    assert bool(want[2]) == (slots == 4)
    for got in _both_paths(lambda: ta.align_anchor_pair_fast_sharded(
            sh, torch.from_numpy(a), torch.from_numpy(b), cfg),
            monkeypatch):
        _same(got, want)


def test_records_and_finish_are_the_plain_combine(case, shards):
    """The record layout loses nothing the finish reads: on 4 shards the
    finish of the stacked records equals _combine + exact_finish (exact)
    and _combine + finalize_hits (classic, full and slot mode)."""
    tables, ntables, metas = shards[4]
    sh = _port_shards(tables, ntables, metas)
    anchors = torch.from_numpy(case.anchors)
    exact = torch.stack([ta.exact_records_ref(*s[:3], anchors, CFG,
                                              s.owns) for s in sh])
    _same(ta.shard_finish_ref(exact, anchors, CFG),
          ta.exact_anchor_stats_sharded(sh, anchors, CFG))
    recs = torch.stack([ta.classic_records_ref(s.table, s.meta, anchors, CFG,
                                               owns=s.owns) for s in sh])
    _same(ta.shard_finish_ref(recs, None, CFG),
          ta.align_anchors_sharded(sh, anchors, CFG))
    slots = torch.arange(anchors.shape[0] - 1, -1, -3)
    hits, _ = ta.exact_anchor_stats_sharded(sh, anchors, CFG)
    recs = torch.stack([ta.classic_records_ref(s.table, s.meta, anchors, CFG,
                                               slots, s.owns) for s in sh])
    _same(ta.shard_finish_ref(recs, None, CFG, slots, hits),
          ta._scatter(hits, slots, ta.align_anchors_sharded(
              sh, anchors[slots], CFG)))


def test_coincident_bucket_read_on_shards_matches_jax(monkeypatch):
    """tests/test_torch_sharded.py's coincident-bucket anchors (keys whose
    two buckets are one bucket in the full table) and reads' anchors on
    2 shards: both paths equal the reference's sharded K1, classic and
    exact-first."""
    from find_circ2_tpu_torch.index import hashtable as tht
    from find_circ2_tpu_torch.index.build import build_index
    from find_circ2_tpu_torch.utils.simulate import rnase_r_library
    a = CFG.anchor_len
    sim = rnase_r_library(seed=7, chrom_lengths={"chrR": 400_000},
                          n_circ=100, n_linear=20, cfg=CFG)
    g = sim.genome
    idx = build_index(g, CFG)
    qt = idx.qtable = tht.build_query_table(idx, CFG, extras=False)
    tab = qt.table.reshape(-1, tht.LANES)
    occ = np.flatnonzero(tab[:, 0] != tht.EMPTY_KEY)
    h1, h2 = (tht.mix_hash(tab[occ, 0].astype(np.uint32),
                           (tab[occ, 1] & tht.S8_MASK).astype(np.uint32),
                           s).astype(np.int64) % int(qt.meta[2])
              for s in np.asarray(qt.meta[:2], np.int32).view(np.uint32))
    pos = tab[occ[h1 == h2], 2:4].view(np.uint32).min(axis=1).astype(
        np.int64)
    pos = pos[pos + a <= len(g)]
    assert pos.size >= 2
    rng = np.random.default_rng(11)
    starts = rng.integers(0, len(g) - a, 30)
    anchors = np.stack([g.codes[p:p + a] for p in pos]
                       + [g.codes[p:p + a] for p in starts])
    anchors = anchors[:anchors.shape[0] // 2 * 2]
    qt.ntable = tht.build_neighbor_table(idx, CFG)
    tables, metas = tht.shard_query_table(idx, 2, CFG)
    ntables = tht.shard_neighbor_tables(qt, tables)
    sh = _port_shards(tables, ntables, metas)
    want = _jax_sharded(
        lambda t, nt, m, x: ja.align_anchors(t, m, x, CFG,
                                             axis_name="index"),
        tables, ntables, metas, anchors)
    for got in _both_paths(lambda: ta.align_anchors_sharded(
            sh, torch.from_numpy(anchors), CFG), monkeypatch):
        _same(got, want)
    half = anchors.shape[0] // 2
    want = _jax_sharded(
        lambda t, nt, m, x, y: ja.align_anchor_pair_fast(
            t, nt, m, x, y, CFG, axis_name="index"),
        tables, ntables, metas, anchors[:half], anchors[half:])
    for got in _both_paths(lambda: ta.align_anchor_pair_fast_sharded(
            sh, torch.from_numpy(anchors[:half]),
            torch.from_numpy(anchors[half:]), CFG), monkeypatch):
        _same(got, want)


@pytest.fixture(scope="module")
def edge():
    return detect_cases.range_edge_case(5, CFG)


@pytest.fixture(scope="module")
def edge_shards(edge):
    return detect_cases.shard_tables(edge, detect_cases.SHARD_COUNTS, CFG)


@pytest.fixture(scope="module")
def batches(case, shards, edge, edge_shards):
    """Each batch of the ranged-records tests: its anchors and shards."""
    return {"detect": (case.anchors, shards),
            "range-edges": (edge.anchors, edge_shards)}


BATCHES = ("detect", "range-edges")
NB = 4 ** CFG.prefix_len
# The records of a key a shard does not hold (positions LARGE_POS).
EMPTY_EXACT = [0, 0, -1, 0, -1, 0, -1, 0, -1]
EMPTY_CLASSIC = [0, 0, 0, 0, -1, -1, -1, -1]


def _records(shard, anchors, slots, owns):
    """A shard's plain records of `anchors` on the keys of `owns`: exact,
    classic, and classic at `slots`."""
    t, nt, m = shard[:3]
    return (ta.exact_records_ref(t, nt, m, anchors, CFG, owns),
            ta.classic_records_ref(t, m, anchors, CFG, owns=owns),
            ta.classic_records_ref(t, m, anchors, CFG, slots, owns))


def _slots(anchors):
    return torch.arange(anchors.shape[0] - 1, -1, -3)


@pytest.mark.parametrize("which", BATCHES)
@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
def test_ranged_records_equal_unranged(batches, which, S):
    """On each carved shard, the records of the keys it owns (exact,
    classic, classic in slot mode) equal its records of every key: a
    shard holds only the keys of its range, so the range drops only
    lookups that find nothing. The batches hold dirty anchors (DIRTY_AT;
    an N first and last) and, in range-edges, keys at every cut and one
    below it."""
    anchors, shards = batches[which]
    anchors = torch.from_numpy(anchors)
    slots = _slots(anchors)
    sh = _port_shards(*shards[S])
    assert [s.owns for s in sh] == ta.key_ranges(NB, S)
    for s in sh:
        for got, want in zip(_records(s, anchors, slots, s.owns),
                             _records(s, anchors, slots, None)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("which", BATCHES)
@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
def test_ranges_partition_the_whole_table(batches, which, S):
    """On the whole table, which holds every key, the records on each of
    the S ranges are a key's own records where the range owns its
    canonical key and the empty record elsewhere; the finish of the S
    ranges' records equals the reference's single-table exact_anchor_stats
    and align_anchors, and at `slots` the single table's refill_slice."""
    anchors, shards = batches[which]
    x = torch.from_numpy(anchors)
    slots = _slots(x)
    whole = _port_shards(*shards[1])[0]
    every = _records(whole, x, slots, None)
    cp = ta._exact_keys(x, CFG)[2]
    got = [_records(whole, x, slots, r) for r in ta.key_ranges(NB, S)]
    for r, (exact, full, sliced) in zip(ta.key_ranges(NB, S), got):
        own = (cp >= r.lo) & (cp < r.hi)
        want = torch.where(own[:, None], every[0],
                           torch.tensor(EMPTY_EXACT, dtype=torch.int32))
        assert torch.equal(exact, want)
    if S > 1:
        assert all(bool((g[0][:, 0] == 0).any()) for g in got)
    stack = [torch.stack([g[j] for g in got]) for j in range(3)]
    t, nt, m = shards[1][0][0], shards[1][1][0], shards[1][2][0]
    _same(ta.shard_finish_ref(stack[0], x, CFG),
          ja.exact_anchor_stats(t, nt, m, anchors, CFG))
    want = ja.align_anchors(t, m, anchors, CFG)
    _same(ta.shard_finish_ref(stack[1], None, CFG), want)
    hits = ta.shard_finish_ref(stack[0], x, CFG)[0]
    _same(ta.shard_finish_ref(stack[2], None, CFG, slots, hits),
          ta.refill_slice_ref(whole.table, whole.meta, x, slots, hits, CFG))


@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
def test_range_edges_match_jax(edge, edge_shards, S, monkeypatch):
    """Keys at every cut between the shards' ranges and one below it,
    their reverse complements, 1-mm neighbours in other ranges and dirty
    forms: the sharded forms (exact, classic, the exact-first pair at 4
    and 1024 slots) on both paths equal the reference's sharded K1, and
    each edge key is found on the one shard whose range holds it."""
    tables, ntables, metas = edge_shards[S]
    sh = _port_shards(tables, ntables, metas)
    anchors = torch.from_numpy(edge.anchors)
    want = _jax_sharded(partial(ja.exact_anchor_stats, cfg=CFG,
                                axis_name="index"),
                        tables, ntables, metas, edge.anchors)
    for got in _both_paths(lambda: ta.exact_anchor_stats_sharded(
            sh, anchors, CFG), monkeypatch):
        _same(got, want)
    want = _jax_sharded(
        lambda t, nt, m, a: ja.align_anchors(t, m, a, CFG,
                                             axis_name="index"),
        tables, ntables, metas, edge.anchors)
    for got in _both_paths(lambda: ta.align_anchors_sharded(sh, anchors,
                                                            CFG),
                           monkeypatch):
        _same(got, want)
    half = anchors.shape[0] // 2
    for slots in (4, 1024):
        cfg = dataclasses.replace(CFG, exact_fallback_slots=slots)
        want = _jax_sharded(
            lambda t, nt, m, x, y: ja.align_anchor_pair_fast(
                t, nt, m, x, y, cfg, axis_name="index"),
            tables, ntables, metas, edge.anchors[:half],
            edge.anchors[half:2 * half])
        for got in _both_paths(lambda: ta.align_anchor_pair_fast_sharded(
                sh, anchors[:half], anchors[half:2 * half], cfg),
                monkeypatch):
            _same(got, want)
    found = torch.stack([ta.exact_records(*s[:3], anchors, CFG,
                                          owns=s.owns)[:, 0] for s in sh])
    kmers = np.arange(0, anchors.shape[0], len(detect_cases.RANGE_KINDS))
    owner = edge.cp[kmers] // -(-NB // S)
    assert found[:, kmers].sum(0).tolist() == [1] * kmers.size
    assert found[owner, kmers].tolist() == [1] * kmers.size


@pytest.mark.parametrize("S", [2, 4, 8])
def test_shard_owning_no_key_of_the_batch(case, shards, S, monkeypatch):
    """A batch none of whose keys, exact or 1-mm, the last of S shards
    owns: that shard's records are all the empty record, and the sharded
    forms equal the reference's; a range that owns nothing gives the
    empty records on the whole table too."""
    anchors = torch.from_numpy(case.anchors)
    p12, s8, p12r, s8r, _ = ta.enumerate_variants(anchors, CFG)
    cp = ta._canonical((p12, s8), (p12r, s8r))[1]
    last = ta.key_ranges(NB, S)[-1]
    keep = ~((cp >= last.lo) & (cp < last.hi)).any(1)
    x = anchors[keep][:keep.sum() // 2 * 2]
    assert x.shape[0] >= 16
    tables, ntables, metas = shards[S]
    sh = _port_shards(tables, ntables, metas)
    slots = _slots(x)
    for got, empty in zip(_records(sh[-1], x, slots, sh[-1].owns),
                          (EMPTY_EXACT, EMPTY_CLASSIC, EMPTY_CLASSIC)):
        assert (got == torch.tensor(empty, dtype=torch.int32)).all()
    nothing = ta.KeyRange(0, 0)
    for got, empty in zip(_records(_port_shards(*shards[1])[0], x, slots,
                                   nothing),
                          (EMPTY_EXACT, EMPTY_CLASSIC, EMPTY_CLASSIC)):
        assert (got == torch.tensor(empty, dtype=torch.int32)).all()
    want = _jax_sharded(partial(ja.exact_anchor_stats, cfg=CFG,
                                axis_name="index"),
                        tables, ntables, metas, x.numpy())
    for got in _both_paths(lambda: ta.exact_anchor_stats_sharded(sh, x, CFG),
                           monkeypatch):
        _same(got, want)
    half = x.shape[0] // 2
    want = _jax_sharded(
        lambda t, nt, m, a, b: ja.align_anchor_pair_fast(
            t, nt, m, a, b, CFG, axis_name="index"),
        tables, ntables, metas, x[:half].numpy(), x[half:].numpy())
    for got in _both_paths(lambda: ta.align_anchor_pair_fast_sharded(
            sh, x[:half], x[half:], CFG), monkeypatch):
        _same(got, want)


@pytest.mark.parametrize("which", BATCHES)
def test_key_ranges_hold_every_occupied_slot(batches, which):
    """key_ranges cuts [0, 4^prefix_len) as shard_query_table does: at 1,
    2, 4 and 8 shards the ranges follow each other from 0 past the last
    bucket, and every occupied slot of shard i's carved table holds a key
    of range i."""
    from find_circ2_tpu_torch.index.hashtable import EMPTY_KEY, LANES
    _, shards = batches[which]
    for S, (tables, _, _) in shards.items():
        owns = ta.key_ranges(NB, S)
        assert owns[0].lo == 0 and owns[-1].hi >= NB
        assert all(a.hi == b.lo for a, b in zip(owns, owns[1:]))
        for r, t in zip(owns, tables):
            keys = t.reshape(-1, LANES)[:, 0]
            keys = keys[keys != EMPTY_KEY]
            assert keys.size and ((keys >= r.lo) & (keys < r.hi)).all()


class _Device:
    """A stand-in for torch.cuda.device that records the current device."""
    current = [0]

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        self.prev, _Device.current[0] = _Device.current[0], self.dev

    def __exit__(self, *exc):
        _Device.current[0] = self.prev


class _Lib:
    """A stand-in for the kernel library: records each C call's entry,
    the current device and its unpacked arguments."""

    def __init__(self):
        self.seen = []

    def fc2t_exact_stats(self, buf):
        self.seen.append(("exact", _Device.current[0],
                          _build.EXACT_ARGS.unpack(buf)))
        return 1

    def fc2t_classic_k1(self, buf):
        self.seen.append(("classic", _Device.current[0],
                          _build.CLASSIC_ARGS.unpack(buf)))
        return 1

    def fc2t_compact(self, buf):
        self.seen.append(("compact", _Device.current[0],
                          _build.COMPACT_ARGS.unpack(buf)))
        return 1

    def fc2t_shard_finish(self, buf):
        self.seen.append(("finish", _Device.current[0],
                          _build.SHARD_ARGS.unpack(buf)))
        return 1


def _stub_cuda(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 2)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda s: False))
    for name in ("_check_exact", "_check_classic", "_check_compact",
                 "_check_finish"):
        monkeypatch.setattr(ta, name, lambda *a: None)
    for name in ("exact_records_ref", "classic_records_ref",
                 "shard_finish_ref", "fallback_slice_ref", "exact_partials",
                 "candidate_stats", "_combine"):
        monkeypatch.setattr(ta, name, lambda *a, **kw: pytest.fail(
            "a tensor off the CPU took a plain version"))
    _Device.current[0] = 0
    return lib


def _counts():
    return (ta.exact_record_launches, ta.classic_record_launches,
            ta.finish_launches, ta.compact_launches, ta.exact_launches,
            ta.classic_launches)


def test_cuda_tensors_reach_the_shard_kernels(case, shards, monkeypatch):
    """Tensors off the CPU take the kernels: align_anchor_pair_fast_sharded
    over two shards makes, with the tensors' device current, one
    partials-mode probe call a shard (hit pointers null, each writing its
    row of one [2, n, 9] record buffer), one finish of those records
    (resolved set), one compaction, one partials-mode enumeration a shard
    in slot mode on the compaction's slots (rows of a [2, k, 8] buffer),
    and one finish writing at those slots into the probe's hits; the
    classic pair one enumeration a shard and one finish. Each counts its
    launch; the single-table kernels' counts stay."""
    tables, ntables, metas = shards[2]
    sh = _port_shards(tables, ntables, metas)
    lib = _stub_cuda(monkeypatch)
    B = 40
    a = torch.from_numpy(case.anchors[:B].copy())
    b = torch.from_numpy(case.anchors[B:2 * B].copy())
    before = _counts()
    hits_a, hits_b, overflow = ta.align_anchor_pair_fast_sharded(sh, a, b,
                                                                 CFG)
    assert hits_a.pos.shape == (B,) and overflow.shape == ()
    assert [e[0] for e in lib.seen] == ["exact", "exact", "finish",
                                        "compact", "classic", "classic",
                                        "finish"]
    assert all(e[1] == 2 for e in lib.seen) and _Device.current == [0]
    (_, _, x1), (_, _, x2), (_, _, f1), (_, _, comp), (_, _, c1), \
        (_, _, c2), (_, _, f2) = lib.seen
    n, k = 2 * B, min(CFG.exact_fallback_slots, 2 * B)
    # ExactArgs: hit and resolved pointers 4..11 null, partials at 12,
    # the shard's range at 15..16; the two shards' rows 4 * n * 9 bytes
    # apart.
    for s, x in enumerate((x1, x2)):
        assert x[1] == sh[s][0].data_ptr() and x[4:12] == (0,) * 8
        assert x[15:17] == tuple(sh[s].owns) and x[-6] == n
    assert x2[12] - x1[12] == 4 * n * ta.EXACT_FIELDS
    # ShardArgs: records, anchors, slots, 8 outputs, stream; n; shards,
    # fields, anchor_len, prefix_len, max_bucket, max_anchor_mm, device.
    assert f1[0] == x1[12] and f1[1] == x1[0] and f1[2] == 0
    assert f1[10] != 0 and f1[12:19] == (n, 2, ta.EXACT_FIELDS,
                                         CFG.anchor_len, CFG.prefix_len,
                                         CFG.max_bucket, CFG.max_anchor_mm)
    assert comp[4:6] == (n, k)
    # ClassicArgs: slots at 5, hit pointers 6..12 null, the shard's range
    # at 27..28, partials last.
    for s, c in enumerate((c1, c2)):
        assert c[5] == comp[1] and c[6:13] == (0,) * 7 and c[19] == k
        assert c[27:29] == tuple(sh[s].owns)
    assert c2[-1] - c1[-1] == 4 * k * ta.CLASSIC_FIELDS
    assert f2[0] == c1[-1] and f2[1] == 0 and f2[2] == comp[1]
    assert f2[3:10] == f1[3:10] and f2[10] == 0
    assert f2[12:14] == (k, 2) and f2[14] == ta.CLASSIC_FIELDS
    after = _counts()
    assert [y - x for x, y in zip(before, after)] == [2, 2, 2, 1, 0, 0]
    lib.seen.clear()
    ta.align_anchor_pair_sharded(sh, a, b, CFG)
    assert [e[0] for e in lib.seen] == ["classic", "classic", "finish"]
    assert lib.seen[0][2][5] == 0 and lib.seen[2][2][14] == 8
    assert lib.seen[2][2][12] == 2 * B


class _StampedLib(_Lib):
    """A stand-in for the measurement build: also records where the
    stamps go (the buffer's pointer, then null)."""

    def fc2t_exact_stamps(self, ptr):
        self.seen.append(("stamps", _Device.current[0], ptr))
        return 0

    fc2t_classic_stamps = fc2t_exact_stamps


def test_record_stage_cycles_reach_the_stamped_c_calls(case, shards,
                                                       monkeypatch):
    """exact_stage_cycles and classic_stage_cycles with `records` run the
    partials modes through the (stubbed) measurement build on a shard's
    keys: one C call each between pointing the stamps at a zeroed buffer
    (a row a warp: EXACT_ANCHORS_PER_WARP anchors, or one slot) and at
    nothing, with the hit pointers null, the records' pointer and the
    range set; each counts one record launch and returns the records and
    the clocks' diffs."""
    tables, ntables, metas = shards[2]
    s = _port_shards(tables, ntables, metas)[1]
    _stub_cuda(monkeypatch)
    lib = _StampedLib()
    monkeypatch.setattr(_build, "load_stamped", lambda: lib)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    anchors = torch.from_numpy(case.anchors)
    n = anchors.shape[0]
    slots = _slots(anchors)
    before = _counts()
    exact, cyc = ta.exact_stage_cycles(*s[:3], anchors, CFG, records=True,
                                       owns=s.owns)
    assert exact.shape == (n, ta.EXACT_FIELDS)
    assert cyc.shape == (-(-n // ta.EXACT_ANCHORS_PER_WARP),
                         len(ta.EXACT_STAGES))
    sliced, scyc = ta.classic_stage_cycles(s.table, s.meta, anchors, CFG,
                                           slots=slots, records=True,
                                           owns=s.owns)
    assert sliced.shape == (slots.shape[0], ta.CLASSIC_FIELDS)
    assert scyc.shape == (slots.shape[0], len(ta.CLASSIC_STAGES))
    assert [y - x for x, y in zip(before, _counts())] == [1, 1, 0, 0, 0, 0]
    assert [e[0] for e in lib.seen] == ["stamps", "exact", "stamps",
                                        "stamps", "classic", "stamps"]
    assert [e[2] for e in lib.seen if e[0] == "stamps"][1::2] == [None] * 2
    x, c = lib.seen[1][2], lib.seen[4][2]
    assert x[4:12] == (0,) * 8 and x[12] == exact.data_ptr()
    assert x[15:17] == tuple(s.owns)
    assert c[6:13] == (0,) * 7 and c[-1] == sliced.data_ptr()
    assert c[5] == slots.data_ptr() and c[27:29] == tuple(s.owns)


def test_plain_versions_launch_nothing_off_the_cpu(case, shards,
                                                   monkeypatch):
    """The plain versions stay plain on tensors off the CPU (what
    chip_smoke.py's plain_detect and plain_shard swap in on the card):
    exact_anchor_stats_ref, the records' and the finish's plain versions
    make no C call and count no launch (their rows come through the row
    gather's plain version here), and equal their CPU results."""
    from find_circ2_tpu_torch.ops import gather_rows as gr
    tables, ntables, metas = shards[2]
    sh = _port_shards(tables, ntables, metas)
    anchors = torch.from_numpy(case.anchors)
    slots = torch.arange(anchors.shape[0] - 1, -1, -5)
    table, ntable, meta, _ = sh[0]

    def run():
        exact = torch.stack([ta.exact_records_ref(*s[:3], anchors, CFG,
                                                  s.owns) for s in sh])
        hits, resolved = ta.shard_finish_ref(exact, anchors, CFG)
        classic = torch.stack([ta.classic_records_ref(
            s.table, s.meta, anchors, CFG, slots, s.owns) for s in sh])
        return (ta.exact_anchor_stats_ref(table, ntable, meta, anchors, CFG),
                exact, resolved, classic,
                ta.shard_finish_ref(classic, None, CFG, slots, hits))

    want = run()
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda s: False))
    monkeypatch.setattr(ta, "gather_rows", gr.gather_rows_ref)
    monkeypatch.setattr(ta, "gather_rows_multi", gr.gather_rows_multi_ref)
    before = _counts()
    got = run()
    assert lib.seen == [] and _counts() == before
    _same(got, want)


def test_cpu_tensors_take_the_plain_parts(case, shards, monkeypatch):
    """On CPU tensors the sharded forms run today's plain parts and none
    of the records' or the finish's wrappers (the compaction's wrapper
    takes its plain version): no launch is counted."""
    tables, ntables, metas = shards[2]
    sh = _port_shards(tables, ntables, metas)
    for name in ("exact_records", "classic_records", "shard_finish"):
        monkeypatch.setattr(ta, name, lambda *a, **kw: pytest.fail(
            "a CPU tensor took a kernel's wrapper"))
    a = torch.from_numpy(case.anchors[:40].copy())
    b = torch.from_numpy(case.anchors[40:80].copy())
    before = _counts()
    ta.align_anchor_pair_fast_sharded(sh, a, b, CFG)
    ta.align_anchor_pair_sharded(sh, a, b, CFG)
    assert _counts() == before


def _constants(name):
    src = open(os.path.join(CSRC, name)).read()
    return src, {k: int(v, 0) for k, v in re.findall(
        r"\b(k[A-Z]\w*) = (0x[0-9A-Fa-f]+|\d+)u?\b", src)}


def test_shard_kernel_constants_and_layouts():
    """The record widths of the partials modes and of csrc/shard_k1.cu
    equal the wrappers', the kernels' every-key range EVERY_KEY, and
    ShardArgs', ExactArgs' and ClassicArgs' sizes _build's."""
    src, got = _constants("shard_k1.cu")
    assert (got["kExactFields"], got["kClassicFields"]) == (
        ta.EXACT_FIELDS, ta.CLASSIC_FIELDS)
    assert got["kMaxShards"] == ta.MAX_SHARDS >= max(
        detect_cases.SHARD_COUNTS)
    assert "sizeof(ShardArgs) == %d" % _build.SHARD_ARGS.size in src
    assert '#include "cuckoo.cuh"' in src
    exact, classic = (_constants(f)[1] for f in ("exact_stats.cu",
                                                  "classic_k1.cu"))
    assert exact["kExactFields"] == ta.EXACT_FIELDS == len(ta.EXACT_OPS)
    assert classic["kClassicFields"] == ta.CLASSIC_FIELDS == len(
        ta.CLASSIC_OPS)
    # The range of a call that looks up every key, which the C entries
    # require outside the partials modes.
    assert exact["kEveryKey"] == classic["kEveryKey"] == ta.EVERY_KEY.hi
    assert ta.EVERY_KEY.lo == 0
    assert _build.EXACT_ARGS.size == 160 and _build.CLASSIC_ARGS.size == 208
