"""The PyTorch port's CUDA kernels against their plain versions on the
card, on one card and on a second one. Nothing here imports JAX or the
JAX package (the card's machine has neither), so on that machine the
file runs without tests/conftest.py:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cards.py

Without a card every test skips; the one-card tests need one, the
second-card tests two (cuda:1 with cuda:0 current). Tolerance 0: every
output is an integer."""

import dataclasses

import numpy as np
import pytest
import torch

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.ops import anchor_align as ta
from find_circ2_tpu_torch.ops import detect as td
from find_circ2_tpu_torch.ops import explore as tx
from find_circ2_tpu_torch.ops import gather_rows as gr
from find_circ2_tpu_torch.utils import detect_cases, explore_cases

CFG = Config()
CASE_ROWS = 96


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 1)


@pytest.fixture(scope="module")
def case():
    return detect_cases.detect_case(2, CASE_ROWS, CFG)


def _card_table(g, rows, width, offset):
    """A contiguous int32 [rows, width] table on the card whose base lies
    `offset` 4-byte words past an allocation (a view)."""
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows * width + offset,),
                         dtype=torch.int32, device=g.device, generator=g)
    return flat[offset:].view(rows, width)


def _same_hits(got, want):
    (hits, resolved), (whits, wres) = got, want
    return (all(torch.equal(x, y) for x, y in zip(hits, whits))
            and torch.equal(resolved, wres))


def _same_classic(got, want):
    (hits, stats), (whits, wstats) = got, want
    return (all(torch.equal(x, y) for x, y in zip(hits, whits))
            and (stats is None) == (wstats is None)
            and all(torch.equal(x, y) for x, y in zip(stats or (),
                                                        wstats or ())))


def _classic_modes(case, device):
    """The enumeration kernel in each mode on the case's anchors against
    its plain version on the same tensors on `device`, then the fallback
    slice (compaction and refill) on resolved masks with and without
    overflow; returns the kernels' launches (classic, compact)."""
    table, meta, anchors, ext, ext_id = detect_cases.classic_args(case,
                                                                  device)
    before = (ta.classic_launches, ta.compact_launches)
    for x, stats in (((), False), ((), True), ((ext, ext_id), True)):
        got = ta.classic_anchor_stats(table, meta, anchors, CFG, *x,
                                      stats=stats)
        torch.cuda.synchronize(device)
        assert got[0].pos.device == anchors.device
        assert _same_classic(got, ta.classic_anchor_stats_ref(
            table, meta, anchors, CFG, *x, stats=stats))
    ntable = torch.from_numpy(case.ntable).to(device)
    n = anchors.shape[0]
    g = torch.Generator().manual_seed(3)
    for k, unresolved in ((16, 100), (n, 100), (1024, n), (1024, 0)):
        k = min(k, n)
        resolved = torch.ones(n, dtype=torch.bool)
        resolved[torch.randperm(n, generator=g)[:unresolved]] = False
        resolved = resolved.to(device)
        idx, over = ta.fallback_slice(resolved, k)
        widx, wover = ta.fallback_slice_ref(resolved, k)
        torch.cuda.synchronize(device)
        assert torch.equal(idx, widx) and torch.equal(over, wover)
        hits, _ = ta.exact_anchor_stats(table, ntable, meta, anchors, CFG)
        want = ta.refill_slice_ref(table, meta, anchors, idx, hits, CFG)
        got = ta.refill_slice(table, meta, anchors, idx, hits, CFG)
        torch.cuda.synchronize(device)
        assert all(a is b for a, b in zip(got, hits))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    return (ta.classic_launches - before[0],
            ta.compact_launches - before[1])


def _sharded_rows(case, device):
    """A 1x2 sharded engine's packed rows (exact-first and the classic
    redo) on the case's reads, its two index shards on `device`."""
    from find_circ2_tpu_torch.index.build import build_index
    from find_circ2_tpu_torch.parallel.mesh import make_mesh
    from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
    index = build_index(case.genome, CFG)
    eng = ShardedEngine(case.genome, index, make_mesh(
        2, (1, 2), [torch.device(device)] * 2), CFG)
    return [eng.dispatch_packed(case.reads, case.lens),
            eng.redo_packed(case.reads, case.lens)]


@pytest.mark.cuda
def test_detect_kernels_match_plain_on_card(case, cuda_device):
    """On the card, each kernel launches once a call and equals its plain
    version on the same inputs: the core on the detect_cases batch with
    the prefilter on and off and each overflow flag, the probe on the
    case's anchors (positions past 2^31 too), detect_batch_packed_fast
    with and without an overflowing fallback slice against the CPU, and
    the sharded engine's rows against the CPU's; then both kernels on
    each of detect_cases.EDGE_CASES (reads up to 301 bases in rows off 4
    bytes, 40 chromosomes, anchors of 18 and 16 bases)."""
    for prefilter in (True, False):
        for overflow in (None, False, True):
            args = detect_cases.core_args(case, cuda_device, overflow)
            before = td.launches
            got = td.detect_core_packed(*args, CFG, prefilter)
            torch.cuda.synchronize()
            assert td.launches == before + 1
            assert torch.equal(got, td.detect_core_packed_ref(*args, CFG,
                                                              prefilter))
    for shift in (0, 3_000_000_000):
        args = detect_cases.exact_args(case, cuda_device, shift)
        before = ta.exact_launches
        got = ta.exact_anchor_stats(*args, CFG)
        torch.cuda.synchronize()
        assert ta.exact_launches == before + 1
        assert _same_hits(got, ta.exact_anchor_stats_ref(*args, CFG))
    g = case.genome
    for cfg in (CFG, dataclasses.replace(CFG, exact_fallback_slots=4)):
        def run(dev):
            words = detect_cases.core_args(case, dev)[0]
            return tp.detect_batch_packed_fast(
                words, len(g), *(torch.from_numpy(x).to(dev) for x in (
                    case.table, case.ntable, case.meta, g.chrom_offsets,
                    case.reads, case.lens)), cfg, True)
        assert torch.equal(run(cuda_device).cpu(), run("cpu"))
    for got, want in zip(_sharded_rows(case, cuda_device),
                         _sharded_rows(case, "cpu")):
        assert torch.equal(got.cpu(), want)
    for name in detect_cases.EDGE_CASES:
        edge, cfg = detect_cases.edge_case(name, 2, CASE_ROWS)
        for prefilter in (True, False):
            args = detect_cases.core_args(edge, cuda_device, True)
            got = td.detect_core_packed(*args, cfg, prefilter)
            torch.cuda.synchronize()
            assert torch.equal(got, td.detect_core_packed_ref(*args, cfg,
                                                              prefilter))
        args = detect_cases.exact_args(edge, cuda_device)
        assert _same_hits(ta.exact_anchor_stats(*args, cfg),
                          ta.exact_anchor_stats_ref(*args, cfg))


@pytest.mark.cuda
def test_classic_kernels_match_plain_on_card(case, cuda_device):
    """On the card, the enumeration kernel equals its plain version on
    every element of every output in each mode (hits only, the
    statistics, the §2b extras; the case's pinned anchors: more than K
    hits, a guarded slot, keys whose buckets coincide with ext row ids
    doubled past and inside the rows), the compaction equals the stable
    argsort with and without overflow, the refill writes the plain hits
    in place; each launches once a call. The redo (detect_batch_packed)
    and explore's K1 on the card equal the CPU."""
    assert _classic_modes(case, cuda_device) == (3 + 4, 4)
    g = case.genome

    def redo(dev):
        words = detect_cases.core_args(case, dev)[0]
        return tp.detect_batch_packed(
            words, len(g), *(torch.from_numpy(x).to(dev) for x in (
                case.table, case.meta, g.chrom_offsets, case.reads,
                case.lens)), CFG, True)
    assert torch.equal(redo(cuda_device).cpu(), redo("cpu"))

    def k1(dev):
        words = detect_cases.core_args(case, dev)[0]
        return tx.explore_k1(words, len(g), *(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
                case.table, case.meta, case.ext, case.ext_id,
                g.chrom_offsets, case.reads, case.lens)), CFG)
    got, want = k1(cuda_device), k1("cpu")
    for x, y in zip(got[5:], want[5:]):     # stats, hits, mm_v
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        assert all(torch.equal(a.cpu(), b) for a, b in pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("n,unresolved,k", detect_cases.SLICE_SIZES,
                         ids=[detect_cases.slice_id(*c)
                              for c in detect_cases.SLICE_SIZES])
def test_compaction_matches_plain_at_edge_sizes_on_card(n, unresolved, k,
                                                        cuda_device):
    """The compaction kernel equals fallback_slice_ref (the stable
    argsort's first k indices and the overflow flag) at each of
    detect_cases.SLICE_SIZES, on a buffer on 8 bytes (one vector load a
    word) and on a view one byte past it (a byte at a time); one launch
    a call."""
    flags, k = detect_cases.slice_flags(n, unresolved, k, CFG, lead=1)
    whole = torch.from_numpy(flags).to(cuda_device)
    views = (whole[1:].clone(), whole[1:])
    assert [r.data_ptr() % 8 for r in views] == [0, 1]
    before = ta.compact_launches
    for resolved in views:
        idx, over = ta.fallback_slice(resolved, k)
        widx, wover = ta.fallback_slice_ref(resolved, k)
        torch.cuda.synchronize()
        assert torch.equal(idx, widx) and torch.equal(over, wover)
    assert ta.compact_launches == before + 2


@pytest.mark.cuda
def test_stamped_classic_kernels_match_plain_on_card(case, cuda_device):
    """The measurement build of csrc/classic_k1.cu computes what the
    plain versions do, in each enumeration mode, in slot mode and for the
    compaction, and its stage cycles come back one row a warp (one for the
    compaction's block), none negative, each row's sum positive."""
    table, meta, anchors, ext, ext_id = detect_cases.classic_args(
        case, cuda_device)
    n = anchors.shape[0]
    for x, stats in (((), False), ((), True), ((ext, ext_id), True)):
        got, cyc = ta.classic_stage_cycles(table, meta, anchors, CFG, *x,
                                           stats=stats)
        assert _same_classic(got, ta.classic_anchor_stats_ref(
            table, meta, anchors, CFG, *x, stats=stats))
        assert cyc.shape == (n, len(ta.CLASSIC_STAGES))
        assert (cyc >= 0).all() and (cyc.sum(1) > 0).all()
    ntable = torch.from_numpy(case.ntable).to(cuda_device)
    hits, resolved = ta.exact_anchor_stats(table, ntable, meta, anchors, CFG)
    k = min(CFG.exact_fallback_slots, n)
    (idx, over), cyc = ta.compact_stage_cycles(resolved, k)
    widx, wover = ta.fallback_slice_ref(resolved, k)
    assert torch.equal(idx, widx) and torch.equal(over, wover)
    assert cyc.shape == (1, len(ta.COMPACT_STAGES)) and (cyc >= 0).all()
    want = ta.refill_slice_ref(table, meta, anchors, idx, hits, CFG)
    (got, none), cyc = ta.classic_stage_cycles(
        table, meta, anchors, CFG, slots=idx,
        hits=ta.AnchorHits(*(f.clone() for f in hits)))
    assert none is None and all(torch.equal(a, b) for a, b in zip(got, want))
    assert cyc.shape == (k, len(ta.CLASSIC_STAGES)) and (cyc >= 0).all()


@pytest.mark.cuda
def test_stamped_detect_kernels_match_plain_on_card(case, cuda_device):
    """The measurement build of csrc/detect.cu and csrc/exact_stats.cu
    computes what the plain versions do (the core with the prefilter on
    and off, the probe with positions past 2^31 too), and its stage
    cycles come back one row a warp, none negative, each row's sum
    positive."""
    for prefilter in (True, False):
        args = detect_cases.core_args(case, cuda_device, True)
        rows, cyc = td.detect_stage_cycles(*args, CFG, prefilter)
        assert torch.equal(rows, td.detect_core_packed_ref(*args, CFG,
                                                           prefilter))
        assert cyc.shape == (-(-CASE_ROWS // td.READS_PER_WARP),
                             len(td.STAGES))
        assert (cyc >= 0).all() and (cyc.sum(1) > 0).all()
    for shift in (0, 3_000_000_000):
        args = detect_cases.exact_args(case, cuda_device, shift)
        got, cyc = ta.exact_stage_cycles(*args, CFG)
        assert _same_hits(got, ta.exact_anchor_stats_ref(*args, CFG))
        n = args[3].shape[0]
        assert cyc.shape == (-(-n // ta.EXACT_ANCHORS_PER_WARP),
                             len(ta.EXACT_STAGES))
        assert (cyc >= 0).all() and (cyc.sum(1) > 0).all()


def _shard_kernels(anchors_np, tables, whole, device, slots=(4, 1024)):
    """The sharded K1's kernels on `anchors_np` over `tables`' shards, all
    on `device`, against their plain versions on the same tensors: each
    shard's records (exact, classic, classic on a slice) of the keys it
    owns and of every key, and on the whole table `whole` of each shard's
    keys; the combining modes with the first and
    the last shard combining the others' records (exact; classic, full
    and written at slots in place), and the first shard's exact combine
    with synthetic others whose exact counts sum past max_bucket and past
    1023; and the sharded forms against the CPU's plain parts (the
    exact-first pair at each fallback slice size, the classic pair).
    Returns the combining shards it took."""
    sh = detect_cases.shard_args(*tables, [device] * tables[0].shape[0])
    anchors = torch.from_numpy(anchors_np).to(device)
    n = anchors.shape[0]
    slot = torch.arange(n - 1, -1, -3, device=device)

    def records(shards, owns):
        return [(ta.exact_records(*s[:3], anchors, CFG, owns=o),
                 ta.classic_records(s.table, s.meta, anchors, CFG, owns=o),
                 ta.classic_records(s.table, s.meta, anchors, CFG, slot,
                                    owns=o))
                for s, o in zip(shards, owns)]

    def plain(shards, owns):
        return [(ta.exact_records_ref(*s[:3], anchors, CFG, o),
                 ta.classic_records_ref(s.table, s.meta, anchors, CFG,
                                        owns=o),
                 ta.classic_records_ref(s.table, s.meta, anchors, CFG, slot,
                                        o))
                for s, o in zip(shards, owns)]

    whole = detect_cases.shard_args(*whole, [device])[0]
    owns = [s.owns for s in sh]
    calls = ((sh, owns), (sh, [None] * len(sh)), ([whole] * len(sh), owns))
    got = [records(*c) for c in calls]
    torch.cuda.synchronize(device)
    for g, c in zip(got, calls):
        for x, y in zip(g, plain(*c)):
            assert all(torch.equal(a, b) for a, b in zip(x, y))
    exact, classic, sliced = (torch.stack([r[j] for r in got[0]])
                              for j in range(3))
    hits = ta.shard_finish_ref(exact, anchors, CFG)[0]
    combining = sorted({0, len(sh) - 1})
    for k in combining:
        rest = [j for j in range(len(sh)) if j != k]
        t, nt, m, o = sh[k]
        assert _same_hits(
            ta.exact_combine(t, nt, m, anchors, CFG, exact[rest], o),
            ta.exact_combine_ref(t, nt, m, anchors, CFG, exact[rest], o))
        assert all(torch.equal(a, b) for a, b in zip(
            ta.classic_combine(t, m, anchors, CFG, classic[rest], owns=o),
            ta.classic_combine_ref(t, m, anchors, CFG, classic[rest],
                                   owns=o)))
        fresh = ta.AnchorHits(*(x.clone() for x in hits))
        want = ta.classic_combine_ref(t, m, anchors, CFG, sliced[rest], slot,
                                      hits, o)
        got = ta.classic_combine(t, m, anchors, CFG, sliced[rest], slot,
                                 fresh, o)
        assert all(a is b for a, b in zip(got, fresh))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    t, nt, m, o = sh[0]
    for cf, cr, others in ((CFG.max_bucket, 0, 1), (1023, 1023, 3)):
        syn = detect_cases.found_records(n, cf, cr, others, device)
        assert _same_hits(ta.exact_combine(t, nt, m, anchors, CFG, syn, o),
                          ta.exact_combine_ref(t, nt, m, anchors, CFG, syn,
                                               o))
    half = n // 2
    cpu = detect_cases.shard_args(*tables, ["cpu"] * tables[0].shape[0])
    for k in slots:
        cfg = dataclasses.replace(CFG, exact_fallback_slots=k)
        pair = (anchors_np[:half], anchors_np[half:2 * half])
        got = ta.align_anchor_pair_fast_sharded(
            sh, *(torch.from_numpy(x).to(device) for x in pair), cfg)
        want = ta.align_anchor_pair_fast_sharded(
            cpu, *(torch.from_numpy(x) for x in pair), cfg)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(
            [*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]]))
    got = ta.align_anchor_pair_sharded(sh, anchors[:half],
                                       anchors[half:2 * half], CFG)
    want = ta.align_anchor_pair_sharded(cpu, anchors[:half].cpu(),
                                        anchors[half:2 * half].cpu(), CFG)
    assert all(torch.equal(a.cpu(), b) for a, b in zip([*got[0], *got[1]],
                                                       [*want[0], *want[1]]))
    return combining


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["detect", "range-edges"])
def test_shard_kernels_match_plain_on_card(case, which, cuda_device):
    """On the card, at 1, 2, 4 and 8 index shards of the case's genome
    (detect) or of keys at every cut between the shards' key ranges
    (range-edges), the partials modes of the probe and the enumeration
    (each shard's own keys, every key, and each shard's keys on the whole
    table), their combining modes (the first and the last shard folding
    in the others' records; synthetic others past max_bucket and 1023),
    and the sharded forms equal their plain versions (the fallback slice
    overflowing at 4 slots); each wrapper launches once a call, and the
    single-table kernels' counts stay."""
    got = case if which == "detect" else detect_cases.range_edge_case(5, CFG)
    shards = detect_cases.shard_tables(got, detect_cases.SHARD_COUNTS, CFG)
    names = ("exact_record_launches", "classic_record_launches",
             "exact_combine_launches", "classic_combine_launches",
             "exact_launches", "classic_launches")
    before = [getattr(ta, k) for k in names]
    K = sum(len(_shard_kernels(got.anchors, tables, shards[1], cuda_device))
            for tables in shards.values())
    got = [getattr(ta, k) - b for k, b in zip(names, before)]
    # At S shards: the direct calls, 3S exact and 6S classic records;
    # each of the K combining shards one exact and two classic combines,
    # and two exact combines on synthetic others; each of the two fast
    # pairs S - 1 exact records and an exact combine, S - 1 classic
    # records and a classic combine; the classic pair likewise.
    S, m = sum(shards), len(shards)
    assert got == [5 * S - 2 * m, 9 * S - 3 * m, K + 4 * m, 2 * K + 3 * m,
                   0, 0], got


def _merge_tensors(name, n, seed, device):
    from find_circ2_tpu_torch.utils.merge_cases import merge_case
    res, lens = merge_case(name, n, seed)
    return ({k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                 else v).to(device) for k, v in res.items()},
            torch.from_numpy(lens).to(device))


# K-h's row counts on the card: one row, a ragged few, one tile
# (ops/merge.TILE_ROWS, 128) and its neighbours, the 2x2 engine's 2,048
# and 4,096, and many tiles past them.
MERGE_ROWS = (1, 97, 127, 128, 129, 2048, 4096, 8192, 8193, 20000)


@pytest.mark.cuda
def test_merge_kernel_matches_plain_on_card(cuda_device):
    """csrc/merge.cu equals the plain merge on all N rows, fill rows
    included, on every utils/merge_cases case at each of MERGE_ROWS rows
    (one tile, its edges, and the rank across tiles); merge_tables on two
    and three stacked tables; one C call a merge, launching
    merge_kernels(n) kernels."""
    from find_circ2_tpu_torch.ops import merge as tm
    from find_circ2_tpu_torch.utils.merge_cases import CASES
    assert MERGE_ROWS[2:5] == tuple(tm.TILE_ROWS + d for d in (-1, 0, 1))
    for n in MERGE_ROWS:
        for i, name in enumerate(CASES):
            res, lens = _merge_tensors(name, n, i + n, cuda_device)
            before = (tm.calls, tm.launches)
            got = tm.merge_junctions(res, lens, CFG)
            torch.cuda.synchronize()
            assert (tm.calls, tm.launches) == (
                before[0] + 1, before[1] + tm.merge_kernels(n))
            want = tm.merge_junctions_ref(res, lens, CFG)
            assert {k: v.dtype for k, v in got.items()} == tm.TABLE_DTYPES
            for k in tm.ALL_FIELDS:
                assert torch.equal(got[k], want[k]), (name, n, k)
            for K in (2, 3):
                stack = {k: torch.stack([got[k]] * K) for k in got}
                got2 = tm.merge_tables(stack)
                want2 = tm._sort_combine({k: v.reshape(-1)
                                          for k, v in stack.items()})
                for k in tm.ALL_FIELDS:
                    assert torch.equal(got2[k], want2[k]), (name, n, K, k)


@pytest.mark.cuda
def test_stamped_merge_kernel_matches_plain_on_card(cuda_device):
    """The measurement build of csrc/merge.cu computes what the plain
    merge does, on one tile and on many, and its stage cycles come back
    one row a tile, none negative, each row's sum positive; rank and
    scatter are 0 on one tile."""
    from find_circ2_tpu_torch.ops import merge as tm
    for n in (97, 2048, 8193):
        res, lens = _merge_tensors("long-runs", n, n, cuda_device)
        got, cyc = tm.merge_stage_cycles(res, lens, CFG)
        want = tm.merge_junctions_ref(res, lens, CFG)
        for k in tm.ALL_FIELDS:
            assert torch.equal(got[k], want[k]), (n, k)
        assert cyc.shape == (-(-n // tm.TILE_ROWS), len(tm.STAGES))
        assert (cyc >= 0).all() and (cyc.sum(1) > 0).all()
        rank = tm.STAGES.index("rank")
        assert bool((cyc[:, rank:rank + 2] == 0).all()) == (
            n <= tm.TILE_ROWS)


def _batchify(reads, cfg, bs):
    from find_circ2_tpu_torch.io.twobit import seq_to_codes
    arr = np.full((bs, cfg.max_read_len), detect_cases.RPAD_CODE, np.uint8)
    lens = np.zeros(bs, np.int32)
    kept = [s for _, s in reads
            if 2 * cfg.anchor_len <= len(s) <= cfg.max_read_len][:bs]
    for i, s in enumerate(kept):
        codes = seq_to_codes(s)
        arr[i, :codes.size] = codes
        lens[i] = codes.size
    return arr, lens


@pytest.mark.cuda
def test_sharded_engine_on_two_cards(two_cards):
    """A 1x2 sharded engine with its index shards on cuda:0 and cuda:1
    (the records of the shard on cuda:1 cross to cuda:0, the row's
    device, before the shard on cuda:0 combines them in its record
    kernel) gives the single device's detect rows, and its packed rows
    and detect_merged equal the same engine on the CPU, all N rows."""
    from find_circ2_tpu_torch.index.build import build_index
    from find_circ2_tpu_torch.parallel.mesh import make_mesh
    from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
    from find_circ2_tpu_torch.utils.simulate import simulate
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(CFG, batch_size=64)
    sim = simulate(seed=33, n_circ=5, n_linear=3, reads_per_junction=3,
                   n_contiguous=10, n_random=6, err_rate=0.3)
    idx = build_index(sim.genome, cfg)
    reads, lens = _batchify(sim.reads, cfg, 64)
    devs = [torch.device("cuda", 0), two_cards]
    eng = ShardedEngine(sim.genome, idx, make_mesh(2, (1, 2), devs), cfg)
    cpu = ShardedEngine(sim.genome, idx, make_mesh(2, (1, 2), ["cpu"] * 2),
                        cfg)
    assert eng.rows[0].shards[1][0].device == two_cards
    before = (ta.exact_record_launches, ta.classic_record_launches,
              ta.exact_combine_launches, ta.classic_combine_launches)
    for fn in ("dispatch_packed", "redo_packed"):
        assert torch.equal(getattr(eng, fn)(reads, lens).cpu(),
                           getattr(cpu, fn)(reads, lens))
    # Shard 1's records cross from cuda:1 before shard 0 (on cuda:0, the
    # row's device) combines them: shard 1's probe, slice and redo
    # records, and shard 0's combining launch of each.
    assert ta.exact_record_launches - before[0] == 1
    assert ta.classic_record_launches - before[1] == 2
    assert ta.exact_combine_launches - before[2] == 1
    assert ta.classic_combine_launches - before[3] == 2
    got, want = eng.detect_merged(reads, lens), cpu.detect_merged(reads,
                                                                   lens)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    dindex = tp.DeviceIndex.build(sim.genome, idx, cfg, device=devs[0])
    single = tp.detect_batch(dindex.words, dindex.nbases, dindex.table,
                             dindex.meta, dindex.chrom_offsets,
                             torch.from_numpy(reads).to(devs[0]),
                             torch.from_numpy(lens).to(devs[0]), cfg, True)
    out = eng.detect(reads, lens)
    live = lens > 0
    for k, v in single.items():
        v = v.cpu().numpy()
        mask = live[:, None] if v.ndim == 2 else live
        assert np.array_equal(np.where(mask, out[k], 0),
                              np.where(mask, v, 0)), k
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_classic_kernels_on_second_card(case, two_cards):
    """With cuda:0 current, the enumeration and the compaction run on
    tensors on cuda:1 and equal their plain versions there."""
    torch.cuda.set_device(0)
    assert _classic_modes(case, two_cards) == (3 + 4, 4)
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_gather_rows_on_second_card(two_cards):
    """With cuda:0 current, both wrappers gather tables on cuda:1 exactly,
    and a packed result on cuda:1 comes back through HostCopy."""
    torch.cuda.set_device(0)
    g = torch.Generator(device=two_cards).manual_seed(7)
    tables = [_card_table(g, 1 << 14, w, 0) for w in (8, 2)]
    idx = torch.randint(0, 1 << 14, (4097,), device=two_cards, generator=g)
    got = gr.gather_rows(tables[0], idx)
    multi = gr.gather_rows_multi(tables, idx)
    torch.cuda.synchronize(two_cards)
    assert torch.cuda.current_device() == 0
    assert torch.equal(got, gr.gather_rows_ref(tables[0], idx))
    for t, x in zip(tables, multi):
        assert torch.equal(x, gr.gather_rows_ref(t, idx))
    assert np.array_equal(tp.HostCopy(got).numpy(), got.cpu().numpy())


@pytest.mark.cuda
def test_explore_kernel_on_second_card(two_cards):
    """With cuda:0 current, the kernel explores an explore_cases batch on
    cuda:1 and equals its plain version there."""
    torch.cuda.set_device(0)
    args = explore_cases.pair_args(explore_cases.explore_case(6, 256, CFG),
                                   CFG, two_cards)
    before = tx.launches
    for prefilter in (True, False):
        got = tx.explore_pairs(*args, CFG, prefilter)
        torch.cuda.synchronize(two_cards)
        assert got.device == two_cards
        assert torch.equal(got, tx.explore_pairs_ref(*args, CFG, prefilter))
    assert tx.launches == before + 2 and torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_detect_kernels_on_second_card(case, two_cards):
    """With cuda:0 current, both detect kernels run on tensors on cuda:1
    and equal their plain versions there."""
    torch.cuda.set_device(0)
    before = (td.launches, ta.exact_launches)
    for prefilter in (True, False):
        args = detect_cases.core_args(case, two_cards, True)
        got = td.detect_core_packed(*args, CFG, prefilter)
        torch.cuda.synchronize(two_cards)
        assert got.device == two_cards
        assert torch.equal(got, td.detect_core_packed_ref(*args, CFG,
                                                          prefilter))
    args = detect_cases.exact_args(case, two_cards)
    got = ta.exact_anchor_stats(*args, CFG)
    torch.cuda.synchronize(two_cards)
    assert got[0].pos.device == two_cards
    assert _same_hits(got, ta.exact_anchor_stats_ref(*args, CFG))
    assert (td.launches, ta.exact_launches) == (before[0] + 2,
                                                before[1] + 1)
    assert torch.cuda.current_device() == 0
