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
                    case.reads, case.lens)), cfg, True,
                torch.from_numpy(case.rc).to(dev))
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
                case.lens)), CFG, True, torch.from_numpy(case.rc).to(dev))
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
