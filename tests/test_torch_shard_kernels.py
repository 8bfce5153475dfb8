"""The sharded engine's K1 (find_circ2_tpu_torch/ops/anchor_align
`*_sharded`): on the CPU its plain parts, and the plain versions of the
card's record layout and combining modes (exact_records_ref,
classic_records_ref, exact_combine_ref and classic_combine_ref, which
end with shard_finish_ref, run through the card's orchestration),
against the
JAX package's exact_anchor_stats, align_anchors and
align_anchor_pair_fast with axis_name="index" under jax.shard_map on
conftest's 8 virtual CPU devices, at 1, 2, 4 and 8 index shards from
shard_query_table; the wrappers' routing (tensors off the CPU reach the
stubbed C calls of the partials and combining modes and the
compaction; no shard on the anchors' device raises) and the kernels'
argument layouts and constants. The kernels themselves are
held against these plain versions on the card by
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
    plain records and combining modes (the CPU tensors take each
    wrapper's plain version)."""
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
    2 shards: both paths (the card's orchestration through the combining
    modes' plain versions) equal the reference's sharded K1, classic and
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


def _jax_wants(anchors, shards):
    """The reference's sharded exact_anchor_stats and align_anchors."""
    return (_jax_sharded(partial(ja.exact_anchor_stats, cfg=CFG,
                                 axis_name="index"), *shards, anchors),
            _jax_sharded(lambda t, nt, m, a: ja.align_anchors(
                t, m, a, CFG, axis_name="index"), *shards, anchors))


@pytest.mark.parametrize("which", BATCHES)
@pytest.mark.parametrize("S", detect_cases.SHARD_COUNTS)
def test_combining_modes_equal_the_finish_and_jax(batches, which, S):
    """The combining modes' plain versions (the card path's shape: one
    shard's records folded with the other S - 1 shards' and finished),
    with the first and the last shard combining, equal shard_finish_ref
    over all S shards' stacked records and the reference's sharded K1:
    exact_combine (hits and `resolved`), classic_combine in full mode,
    and in slot mode at `slots` into the probe's hits (the reference's
    hits of anchors[slots] scattered there). The batches hold dirty
    anchors, which resolve unaligned."""
    anchors_np, shards = batches[which]
    anchors = torch.from_numpy(anchors_np)
    slots = _slots(anchors)
    sh = _port_shards(*shards[S])
    recs = [torch.stack(x) for x in zip(*(_records(s, anchors, slots, s.owns)
                                          for s in sh))]
    exact, full, sliced = recs
    hits, resolved = ta.shard_finish_ref(exact, anchors, CFG)
    want_exact, want_classic = _jax_wants(anchors_np, shards[S])
    _same((hits, resolved), want_exact)
    scattered = ta._scatter(hits, slots, ta.AnchorHits(*(
        torch.from_numpy(np.asarray(x).astype(np.int64))[slots].to(h.dtype)
        for x, h in zip(want_classic, hits))))
    for k in sorted({0, S - 1}):
        rest = [j for j in range(S) if j != k]
        t, nt, m, owns = sh[k]
        got = ta.exact_combine_ref(t, nt, m, anchors, CFG, exact[rest], owns)
        _same(got, (hits, resolved))
        got = ta.classic_combine_ref(t, m, anchors, CFG, full[rest],
                                     owns=owns)
        _same(got, ta.shard_finish_ref(full, None, CFG))
        _same(got, want_classic)
        got = ta.classic_combine_ref(t, m, anchors, CFG, sliced[rest], slots,
                                     hits, owns)
        _same(got, ta.shard_finish_ref(sliced, None, CFG, slots, hits))
        _same(got, scattered)
    dirty = (anchors >= 4).any(1)
    assert dirty.any() and resolved[dirty].all()
    assert not hits.aligned[dirty].any()


def test_combine_guards_the_summed_exact_counts(case, shards):
    """The guard applies to the exact counts summed over the shards: with
    one other shard holding max_bucket forward hits of every key, an
    anchor whose own forward count is 1..max_bucket passes the guard
    alone and not summed; with three others at 1023 on both orientations
    (the most a packed count holds, so the sum passes what one shard's
    packed fields hold) no clean anchor keeps an exact hit. exact_combine
    equals exact_finish on the explicit sums (counts added, positions
    least, `found` any), and every anchor resolves."""
    sh = _port_shards(*shards[2])
    anchors = torch.from_numpy(case.anchors)
    n = anchors.shape[0]
    t, nt, m, owns = sh[0]
    own = ta.exact_records_ref(t, nt, m, anchors, CFG, owns).to(torch.int64)
    clean, swap, _, _ = ta._exact_keys(anchors, CFG)
    alone = ta.exact_combine(t, nt, m, anchors, CFG,
                             detect_cases.found_records(n, 0, 0, 0), owns)
    _same(alone, ta.shard_finish_ref(own[None].to(torch.int32), anchors,
                                     CFG))
    for cf, cr, others in ((CFG.max_bucket, 0, 1), (1023, 1023, 3)):
        got = ta.exact_combine(t, nt, m, anchors, CFG,
                               detect_cases.found_records(n, cf, cr, others),
                               owns)
        summed = own.clone()
        summed[:, 0] = 1
        summed[:, 1] += others * cf
        summed[:, 3] += others * cr
        want = ta.exact_finish(tuple(summed[:, j] & ta.M32 if op == "min"
                                     else summed[:, j].bool() if op == "any"
                                     else summed[:, j]
                                     for j, op in enumerate(ta.EXACT_OPS)),
                               clean, swap, CFG)
        _same(got, want)
        assert bool(got[1].all())
        if cr == 0:
            bites = ((own[:, 1] >= 1) & (own[:, 1] <= CFG.max_bucket)
                     & (own[:, 3] <= CFG.max_bucket) & (own[:, 0] == 1)
                     & clean)
            assert bites.any() and (alone[0].mm[bites] == 0).all()
            assert ((got[0].n_best != alone[0].n_best)
                    | (got[0].mm != alone[0].mm))[bites].all()
        else:
            assert int(summed[:, 1].min()) > 1023
            assert not bool((got[0].mm[clean] == 0).any())


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


def _stub_cuda(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 2)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda s: False))
    for name in ("_check_exact", "_check_classic", "_check_compact"):
        monkeypatch.setattr(ta, name, lambda *a: None)
    for name in ("exact_records_ref", "classic_records_ref",
                 "exact_combine_ref", "classic_combine_ref",
                 "shard_finish_ref", "fallback_slice_ref", "exact_partials",
                 "candidate_stats", "_combine"):
        monkeypatch.setattr(ta, name, lambda *a, **kw: pytest.fail(
            "a tensor off the CPU took a plain version"))
    _Device.current[0] = 0
    return lib


def _counts():
    return (ta.exact_record_launches, ta.classic_record_launches,
            ta.exact_combine_launches, ta.classic_combine_launches,
            ta.compact_launches, ta.exact_launches, ta.classic_launches)


def test_cuda_tensors_reach_the_shard_kernels(case, shards, monkeypatch):
    """Tensors off the CPU take the kernels: align_anchor_pair_fast_sharded
    over two shards on the anchors' device makes, with the tensors'
    device current, shard 1's partials-mode probe call (hit pointers
    null, writing row 0 of a [1, n, 9] buffer of the other shards'
    records), then shard 0's combining probe last (hit and resolved
    pointers set, no partials, that buffer and its count 1), one
    compaction of its `resolved`, shard 1's slot-mode enumeration into a
    [1, k, 8] buffer and shard 0's combining enumeration at the
    compaction's slots, writing into the probe's hits; the classic pair
    one enumeration and one combining enumeration. Each counts its launch
    on its own count, and the single-table kernels' counts stay."""
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
    assert [e[0] for e in lib.seen] == ["exact", "exact", "compact",
                                        "classic", "classic"]
    assert all(e[1] == 2 for e in lib.seen) and _Device.current == [0]
    (_, _, x1), (_, _, x0), (_, _, comp), (_, _, c1), (_, _, c0) = lib.seen
    n, k = 2 * B, min(CFG.exact_fallback_slots, 2 * B)
    # ExactArgs: hit and resolved pointers 4..11, partials 12, the
    # shard's range 15..16, n 17, n_others 23, others 25.
    for s, x in ((1, x1), (0, x0)):
        assert x[1] == sh[s].table.data_ptr() and x[15:17] == tuple(
            sh[s].owns) and x[17] == n
    assert x1[4:12] == (0,) * 8 and x1[12] and (x1[25], x1[23]) == (0, 0)
    assert all(x0[4:12]) and x0[12] == 0 and (x0[25], x0[23]) == (x1[12], 1)
    assert comp[0] == x0[11] and comp[4:6] == (n, k)
    # ClassicArgs: slots 5, hit pointers 6..12, n 19, the shard's range
    # 27..28, partials 29, others 30, n_others 31.
    for s, c in ((1, c1), (0, c0)):
        assert c[1] == sh[s].table.data_ptr() and c[5] == comp[1]
        assert c[19] == k and c[27:29] == tuple(sh[s].owns)
    assert c1[6:13] == (0,) * 7 and c1[29] and c1[30:32] == (0, 0)
    assert c0[6:13] == x0[4:11] and c0[29] == 0
    assert c0[30:32] == (c1[29], 1)
    after = _counts()
    assert [y - x for x, y in zip(before, after)] == [1, 1, 1, 1, 1, 0, 0]
    lib.seen.clear()
    ta.align_anchor_pair_sharded(sh, a, b, CFG)
    assert [e[0] for e in lib.seen] == ["classic", "classic"]
    (_, _, c1), (_, _, c0) = lib.seen
    assert c1[5] == c0[5] == 0 and c0[19] == 2 * B and all(c0[6:13])
    assert c1[29] and c0[29] == 0 and c0[30:32] == (c1[29], 1)
    assert [y - x for x, y in zip(after, _counts())] == [0, 1, 0, 1, 0, 0, 0]


def _elsewhere(shard):
    """`shard` on another device than the anchors' (the meta device)."""
    return ta.Shard(*(x.to("meta") for x in shard[:3]), shard.owns)


@pytest.mark.parametrize("placement", ["shard 1 on it", "none on it"])
def test_placement_decides_the_combining_shard(case, shards, placement,
                                               monkeypatch):
    """Which shards lie on the anchors' device decides the orchestration
    (stubbed C calls; the meta device stands in for another card). With
    shard 0 elsewhere and shard 1 on the anchors' device, shard 0's
    records (probe, slice) are written there and copied over, no wait,
    before shard 1 combines them last: shard 1 is the first shard on the
    anchors' device. With no shard there, each sharded form raises
    ValueError before any C call or copy: the combining shard must lie
    on the anchors' device."""
    tables, ntables, metas = shards[2]
    sh = _port_shards(tables, ntables, metas)
    sh = ([_elsewhere(sh[0]), sh[1]] if placement == "shard 1 on it"
          else [_elsewhere(s) for s in sh])
    lib = _stub_cuda(monkeypatch)
    copy = torch.Tensor.copy_

    def copy_(self, src, non_blocking=False):
        if not src.is_meta:
            return copy(self, src, non_blocking)
        lib.seen.append(("copy", self.data_ptr(), non_blocking))
        return self

    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    B = 40
    a = torch.from_numpy(case.anchors[:B].copy())
    b = torch.from_numpy(case.anchors[B:2 * B].copy())
    before = _counts()
    if placement == "none on it":
        both = torch.cat([a, b])
        slots = torch.arange(B)
        hits = ta.AnchorHits(*(torch.zeros(2 * B, dtype=d) for d in (
            torch.bool, torch.int64, *(torch.int32,) * 5)))
        for run in (lambda: ta.exact_anchor_stats_sharded(sh, both, CFG),
                    lambda: ta.align_anchors_sharded(sh, both, CFG),
                    lambda: ta.refill_slice_sharded(sh, both, slots, hits,
                                                    CFG),
                    lambda: ta.align_anchor_pair_fast_sharded(sh, a, b,
                                                              CFG)):
            with pytest.raises(ValueError, match="anchors' device"):
                run()
        assert lib.seen == [] and _counts() == before
        return
    ta.align_anchor_pair_fast_sharded(sh, a, b, CFG)
    names = [e[0] for e in lib.seen]
    # A C call's arguments, or a copy's destination.
    seen = [e[1] if e[0] == "copy" else e[2] for e in lib.seen]
    assert all(e[2] for e in lib.seen if e[0] == "copy")
    assert names == ["exact", "copy", "exact", "compact", "classic", "copy",
                     "classic"]
    x0, cp1, x1, comp, c0, cp2, c1 = seen
    # Shard 0's records (partials mode: no hit pointers; on the other
    # device, so its pointers read 0 here) land in the buffer that shard
    # 1's combining launch reads, after their copy.
    assert x0[4:12] == (0,) * 8 and x0[15:17] == tuple(sh[0].owns)
    assert x1[15:17] == tuple(sh[1].owns) and x1[12] == 0
    assert (x1[25], x1[23]) == (cp1, 1) and all(x1[4:12])
    assert c0[6:13] == (0,) * 7 and c0[27:29] == tuple(sh[0].owns)
    assert c1[27:29] == tuple(sh[1].owns) and c1[29] == 0
    assert c1[30:32] == (cp2, 1) and c1[6:13] == x1[4:11]
    assert c1[5] == comp[1] and comp[0] == x1[11]
    assert [y - x for x, y in zip(before, _counts())] == [1, 1, 1, 1, 1, 0,
                                                          0]


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
    range set; with `others`, the combining modes: the hit pointers set,
    no records' pointer, the others' pointer and count. Each counts one
    launch, the partials modes on the record counts and the combining
    modes on the combine counts, and returns the records or hits and the
    clocks' diffs."""
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
    others = torch.zeros((1, n, ta.EXACT_FIELDS), dtype=torch.int32)
    (hits, resolved), xcyc = ta.exact_stage_cycles(
        *s[:3], anchors, CFG, owns=s.owns, others=others)
    assert resolved.shape == (n,) and xcyc.shape == cyc.shape
    sothers = torch.zeros((1, slots.shape[0], ta.CLASSIC_FIELDS),
                          dtype=torch.int32)
    got, ccyc = ta.classic_stage_cycles(s.table, s.meta, anchors, CFG,
                                        slots=slots, hits=hits, owns=s.owns,
                                        others=sothers)
    assert all(a is b for a, b in zip(got, hits))
    assert ccyc.shape == scyc.shape
    assert [y - x for x, y in zip(before, _counts())] == [1, 1, 1, 1, 0, 0,
                                                          0]
    assert [e[0] for e in lib.seen] == ["stamps", "exact", "stamps",
                                        "stamps", "classic", "stamps"] * 2
    assert [e[2] for e in lib.seen if e[0] == "stamps"][1::2] == [None] * 4
    x, c = lib.seen[1][2], lib.seen[4][2]
    assert x[4:12] == (0,) * 8 and x[12] == exact.data_ptr()
    assert x[15:17] == tuple(s.owns) and (x[25], x[23]) == (0, 0)
    assert c[6:13] == (0,) * 7 and c[29] == sliced.data_ptr()
    assert c[5] == slots.data_ptr() and c[27:29] == tuple(s.owns)
    x, c = lib.seen[7][2], lib.seen[10][2]
    assert x[4:12] == tuple(t.data_ptr() for t in (*hits, resolved))
    assert x[12] == 0 and (x[25], x[23]) == (others.data_ptr(), 1)
    assert x[15:17] == tuple(s.owns)
    assert c[6:13] == tuple(t.data_ptr() for t in hits) and c[29] == 0
    assert c[30:32] == (sothers.data_ptr(), 1) and c[27:29] == tuple(s.owns)


def test_plain_versions_launch_nothing_off_the_cpu(case, shards,
                                                   monkeypatch):
    """The plain versions stay plain on tensors off the CPU (what
    chip_smoke.py's plain_detect and plain_shard swap in on the card):
    exact_anchor_stats_ref, the records', the combining modes' and the
    finish's plain versions make no C call and count no launch (their
    rows come through the row gather's plain version here), and equal
    their CPU results."""
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
                ta.shard_finish_ref(classic, None, CFG, slots, hits),
                ta.exact_combine_ref(*sh[0][:3], anchors, CFG, exact[1:],
                                     sh[0].owns),
                ta.classic_combine_ref(sh[0].table, sh[0].meta, anchors,
                                       CFG, classic[1:], slots, hits,
                                       sh[0].owns))

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
    of the records' or the combining modes' wrappers (the compaction's
    wrapper takes its plain version): no launch is counted."""
    tables, ntables, metas = shards[2]
    sh = _port_shards(tables, ntables, metas)
    for name in ("exact_records", "classic_records", "exact_combine",
                 "classic_combine"):
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
    """The record widths and the shard limit of csrc/shard_finish.cuh,
    which the partials and combining modes of csrc/exact_stats.cu and
    csrc/classic_k1.cu share, equal the wrappers'; the kernels' every-key
    range EVERY_KEY; ExactArgs' and ClassicArgs' sizes _build's (with the
    other shards' records and their count), ExactArgs' fields before
    them at the offsets they had without (the single table's kernel reads
    its arguments where it did); and each finish is written once."""
    head, got = _constants("shard_finish.cuh")
    assert (got["kExactFields"], got["kClassicFields"]) == (
        ta.EXACT_FIELDS, ta.CLASSIC_FIELDS)
    assert ta.EXACT_FIELDS == len(ta.EXACT_OPS)
    assert ta.CLASSIC_FIELDS == len(ta.CLASSIC_OPS)
    assert got["kMaxShards"] == ta.MAX_SHARDS >= max(
        detect_cases.SHARD_COUNTS)
    exact, classic = (_constants(f) for f in ("exact_stats.cu",
                                               "classic_k1.cu"))
    for text, _ in (exact, classic):
        assert '#include "shard_finish.cuh"' in text
        assert "kExactFields = " not in text and "kMaxShards = " not in text
    # The enumeration's cross-shard finish lives in the header and its
    # combining mode calls it; the probe's combining mode runs the single
    # table's finish, which the header does not hold.
    assert classic[0].count("fc2t::classic_finish(") == 1
    assert exact[0].count("// exact_finish, on every lane") == 1
    assert "max_bucket" not in head
    assert not os.path.exists(os.path.join(CSRC, "shard_k1.cu"))
    # The range of a call that looks up every key, which with no other
    # shards' records is the single table's kernel.
    assert exact[1]["kEveryKey"] == classic[1]["kEveryKey"] == \
        ta.EVERY_KEY.hi
    assert ta.EVERY_KEY.lo == 0
    assert exact[1]["kHeldShards"] >= 1 and classic[1]["kHeldShards"] >= 1
    assert "sizeof(ExactArgs) == %d" % _build.EXACT_ARGS.size in exact[0]
    assert "sizeof(ClassicArgs) == %d" % _build.CLASSIC_ARGS.size in \
        classic[0]
    assert _build.EXACT_ARGS.size == 176 and _build.CLASSIC_ARGS.size == 224
    assert _build.EXACT_ARGS.format.startswith("<14Qq2q6i")
