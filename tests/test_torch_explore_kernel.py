"""The §2b pair program of the PyTorch port (find_circ2_tpu_torch/ops/
explore.explore_pairs): its plain version against the reference JAX
package on synthetic edge cases, the wrapper's routing, the out-of-range
extras row of candidate_stats, and — on a CUDA card only — the CUDA
kernel (csrc/explore.cu) against its plain version. Tolerance 0: every
output is an integer."""

import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from find_circ2_tpu import config as jconfig
from find_circ2_tpu.config import Config
from find_circ2_tpu.index import hashtable as jht
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.ops import anchor_align as ja
from find_circ2_tpu.ops import explore as jx
from find_circ2_tpu.ops.packed import pack_nibbles
from find_circ2_tpu.utils.simulate import rnase_r_library
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.ops import anchor_align as ta
from find_circ2_tpu_torch.ops import explore as tx
from find_circ2_tpu_torch.utils import explore_cases

CFG = Config()
LARGE_POS = 0xFFFFFFFF
CASE_ROWS = 64


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@partial(jax.jit, static_argnames=("nbases", "cfg", "prefilter"))
def _jax_pairs(gpacked, nbases, chrom_offsets, reads, lens, stats_a,
               stats_b, mm_v, strand_v, cfg, prefilter):
    """The reference's explore_batch_packed after K1 (its lines after
    candidate_stats), on given K1 outputs."""
    hits = [ja.finalize_hits(c, f, mm_v, strand_v, cfg)
            for c, f, _ in (stats_a, stats_b)]
    cands = [jx.merged_candidates(c, f, x, mm_v, h.mm, cfg)
             for (c, f, x), h in zip((stats_a, stats_b), hits)]
    res = jx.explore_core(gpacked, nbases, chrom_offsets, reads, lens,
                          *hits, *cands[0], *cands[1], cfg, prefilter)
    sig = res["signal"].astype(jnp.int32)
    cols = [res[k].astype(jnp.int32) for k in tp.PACK_FIELDS[:-1]]
    cols.append(sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                | (sig[:, 3] << 9))
    return jnp.stack(cols, axis=1)


def _jax_case(case, prefilter):
    """The reference's rows for an explore_cases batch."""
    V = case.mm_v.shape[0] // 2
    stats = [tuple(jnp.asarray(x[i].astype(np.uint32) if x is not case.count
                               else x[i])
                   for x in (case.count, case.first_pos, case.extras))
             for i in (0, 1)]
    return np.asarray(_jax_pairs(
        jnp.asarray(pack_nibbles(case.codes)), len(case.codes),
        jnp.asarray(case.chrom_offsets.astype(np.uint32)),
        jnp.asarray(case.reads), jnp.asarray(case.lens), *stats,
        jnp.asarray(case.mm_v),
        jnp.repeat(jnp.arange(2, dtype=jnp.int32), V), cfg=CFG,
        prefilter=prefilter))


@pytest.fixture(scope="module")
def case():
    return explore_cases.explore_case(2, CASE_ROWS, CFG)


@pytest.mark.parametrize("prefilter", [True, False])
def test_explore_pairs_plain_matches_jax_on_edge_cases(case, prefilter):
    """explore_pairs' plain version equals the reference on the pinned
    edge rows of explore_cases and on its random rows: lengths 2a and
    Lp, no pair on a common strand, an anchor without candidates, ties
    on both strands decided by (pA, pB), by s and by row-major order,
    wrapped positions next to 2^32, more than K candidates per strand."""
    got = tx.explore_pairs(*explore_cases.pair_args(case, CFG), CFG,
                           prefilter).numpy()
    want = _jax_case(case, prefilter)
    assert got.dtype == np.int32 and got.shape == (CASE_ROWS, 14)
    assert np.array_equal(got, want)
    status, kind, strand, n_bp = got[:, 0], got[:, 1], got[:, 6], got[:, 8]
    assert case.lens[0] == 2 * CFG.anchor_len and case.lens[1] == \
        CFG.max_read_len
    assert status[0] == jconfig.ST_JUNCTION and n_bp[0] == 1
    assert status[1] == jconfig.ST_JUNCTION and kind[1] == \
        jconfig.KIND_CIRCULAR and strand[1] == 1
    assert status[2] == jconfig.ST_DIFF_STRAND
    assert status[3] == jconfig.ST_UNALIGNED_B
    assert status[4] == status[5] == jconfig.ST_JUNCTION
    assert strand[4] == strand[5] == 0
    assert status[9] == jconfig.ST_UNALIGNED_A
    assert (status == jconfig.ST_JUNCTION).sum() >= CASE_ROWS // 2
    assert (got[:, 3].view(np.uint32) > 2 ** 31).any()


def test_explore_pairs_routes_cpu_tensors_to_plain(case, monkeypatch):
    """CPU tensors take explore_pairs_ref and launch nothing; tensors on
    two devices, or on one that is not a CUDA card, raise."""
    args = explore_cases.pair_args(case, CFG)
    calls = []
    ref = tx.explore_pairs_ref

    def spy(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(tx, "explore_pairs_ref", spy)
    before = tx.launches
    got = tx.explore_pairs(*args, CFG, True)
    assert calls == [1] and tx.launches == before
    assert torch.equal(got, ref(*args, CFG, True))
    mixed = list(args)
    mixed[3] = mixed[3].to("meta")                # reads
    with pytest.raises(ValueError, match="one CUDA device"):
        tx.explore_pairs(*mixed, CFG, True)
    def on_meta(x):
        if isinstance(x, torch.Tensor):
            return x.to("meta")
        if isinstance(x, tuple):
            ys = [y.to("meta") for y in x]
            return type(x)(*ys) if hasattr(x, "_fields") else tuple(ys)
        return x

    meta = [on_meta(x) for x in args]
    with pytest.raises(ValueError, match="CUDA device"):
        tx.explore_pairs(*meta, CFG, True)
    assert calls == [1] and tx.launches == before


def test_kernel_constants_match_config():
    """The codes csrc/explore.cu spells out equal config.py's."""
    src = open(os.path.join(os.path.dirname(tx.__file__), os.pardir,
                            "csrc", "explore.cu")).read()
    got = dict(re.findall(r"\b(k[A-Z]\w*) = (\d+)\b", src))
    want = dict(kA=0, kC=1, kG=2, kT=3, kRpad=jconfig.RPAD_CODE,
                kJunction=jconfig.ST_JUNCTION,
                kPrefiltered=jconfig.ST_PREFILTERED,
                kUnalignedA=jconfig.ST_UNALIGNED_A,
                kUnalignedB=jconfig.ST_UNALIGNED_B,
                kDiffStrand=jconfig.ST_DIFF_STRAND,
                kDiffChrom=jconfig.ST_DIFF_CHROM,
                kAnchorOverlap=jconfig.ST_ANCHOR_OVERLAP,
                kNoJunction=jconfig.ST_NO_JUNCTION,
                kLinear=jconfig.KIND_LINEAR, kCircular=jconfig.KIND_CIRCULAR,
                kSenseMinus=jconfig.SENSE_MINUS, kMaxK=tx.MAX_PAIR_HITS,
                kPackFields=len(tp.PACK_FIELDS),
                kThreads=tx.MAX_PAIR_HITS ** 2,
                kMaxListLanes=tx.MAX_LIST_LANES,
                kLaneEntries=tx.MAX_LIST_LANES // 64,
                kRankMax=2 * tx.MAX_PAIR_HITS, kStamps=len(tx.STAGES) + 1)
    assert {k: int(got[k]) for k in want} == want
    assert re.search(r"a->Lp > (\d+)", src).group(1) == str(tx.MAX_READ_LEN)
    assert len(re.findall(r"\bSTAMP\(", src)) == len(tx.STAGES) + 3
    # The kernel's 16-bit split rows hold 4 * Lp + 3; its packed split
    # keys (score * 4 + 3) * (Lp + 2) + k, score <= 2 * Lp, stay under
    # the fill 2^30.
    Lp = tx.MAX_READ_LEN
    assert 4 * Lp + 3 < 2 ** 15
    assert (8 * Lp + 3) * (Lp + 2) + Lp + 1 < 2 ** 30


def _viable_pairs_and_lanes(args, cfg):
    """Per row: the pairs the kernel flags viable (valid lanes, one strand
    and chromosome, linear or circular), anchor A's merged candidates,
    and the lanes of A's '+' list at the best level."""
    words, nbases, offsets, reads, lens, sa, sb, ha, hb, mm_v = args
    K, a = cfg.max_pair_hits, cfg.anchor_len
    V = mm_v.shape[0] // 2
    (pa, sta, va), (pb, stb, vb) = (
        tx.merged_candidates(*st, mm_v, h.mm, cfg)
        for st, h in ((sa, ha), (sb, hb)))
    s0 = (sta == 0)[:, :, None]
    pA = torch.where(s0, pa[:, :, None], pb[:, None, :])
    pB = torch.where(s0, pb[:, None, :], pa[:, :, None])
    m32 = 0xFFFFFFFF
    geom = (((pA + a) & m32) <= pB) | (((pB + a) & m32) <= pA)
    same = (torch.searchsorted(offsets, pA, right=True)
            == torch.searchsorted(offsets, pB, right=True))
    viable = ((sta[:, :, None] == stb[:, None, :]) & va[:, :, None]
              & vb[:, None, :] & geom & same).sum((1, 2))
    count = sa[0]
    at_best = (mm_v[None, :] == ha.mm[:, None]) & (count > 0)
    lanes = torch.where(at_best, torch.clamp(count, max=K), 0)[:, :V].sum(1)
    return viable, pa, va, lanes


def test_pinned_rows_pin_what_they_say(case):
    """The explore_cases rows added for the warp-level kernel pin what
    PINNED says: lists of exactly K, 128 and 129 lanes; equal positions in
    the two warps of a list kept twice, in `sort`'s order; the 129th lane
    the smallest; 0, 1, 32, 33 and 256 viable pairs; a two-pair tie on the
    whole pair key."""
    args = explore_cases.pair_args(case, CFG)
    viable, pa, va, lanes = _viable_pairs_and_lanes(args, CFG)
    K = CFG.max_pair_hits
    for row, n in explore_cases.PINNED_PAIRS.items():
        assert int(viable[row]) == n, (row, explore_cases.PINNED[row])
    for row, n in explore_cases.PINNED_LANES.items():
        assert int(lanes[row]) == n, (row, explore_cases.PINNED[row])
    small = [1000 + 100 * i for i in range(K)]
    assert pa[12].tolist() == sorted(small * 2)[:K]
    assert int(pa[13, 0]) == 500 and bool(va[13].all())
    assert pa[19, :2].tolist() == [6000, 6000] and int(viable[19]) == 2
    got = tx.explore_pairs(*args, CFG, False).numpy()
    assert (got[[11, 15, 16, 17, 18, 19], 0] == jconfig.ST_JUNCTION).all()
    assert got[14, 0] == jconfig.ST_ANCHOR_OVERLAP


@pytest.mark.parametrize("prefilter", [True, False])
def test_explore_pairs_plain_matches_jax_on_second_seed(prefilter):
    """The plain version equals the reference on another explore_cases
    batch: the same pinned rows, other random rows."""
    case = explore_cases.explore_case(4, CASE_ROWS, CFG)
    got = tx.explore_pairs(*explore_cases.pair_args(case, CFG), CFG,
                           prefilter).numpy()
    assert np.array_equal(got, _jax_case(case, prefilter))


def test_candidate_stats_out_of_range_extras_row():
    """A key whose two cuckoo buckets coincide matches both probes, so its
    ext row id counts twice (ROADMAP.md §3); past the last ext row the
    reference's jnp.take fills LARGE_POS. With such keys' ext_id set to
    the last row, the port's candidate_stats equals the reference's on
    their anchors, every output, and their exact slots' extras are all
    LARGE_POS."""
    a = CFG.anchor_len
    sim = rnase_r_library(seed=7, chrom_lengths={"chrR": 400_000},
                          n_circ=100, n_linear=20, cfg=CFG)
    g = sim.genome
    idx = build_index(g, CFG)
    qt = idx.qtable = jht.build_query_table(idx, CFG)
    tab = qt.table.reshape(-1, jht.LANES)
    occ = np.flatnonzero(tab[:, 0] != jht.EMPTY_KEY)
    h1, h2 = (jht.mix_hash(tab[occ, 0].astype(np.uint32),
                           (tab[occ, 1] & jht.S8_MASK).astype(np.uint32),
                           s).astype(np.int64) % int(qt.meta[2])
              for s in np.asarray(qt.meta[:2], np.int32).view(np.uint32))
    co = occ[h1 == h2]
    assert co.size >= 1
    last = qt.ext.shape[0] - 1
    qt.ext_id.reshape(-1)[co] = last
    pos = tab[co, 2:4].view(np.uint32).min(axis=1).astype(np.int64)
    pos = pos[pos + a <= len(g)]
    anchors = np.stack([g.codes[p:p + a] for p in pos])
    jd = jp.DeviceIndex.build(g, idx, CFG)
    td = tp.DeviceIndex.from_reference(jd, device="cpu")
    assert 2 * last >= td.ext.shape[0]
    want = jax.jit(ja.candidate_stats, static_argnames=("cfg",))(
        jd.table, jd.meta, jnp.asarray(anchors), CFG, jd.ext, jd.ext_id)
    got = ta.candidate_stats(td.table, td.meta, _t(anchors), CFG, td.ext,
                             td.ext_id)
    assert len(got) == 5
    for w, x in zip(want, got):
        assert np.array_equal(x.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    V = 1 + 3 * a
    extras = got[4].numpy()
    assert (extras[:, [0, V]] == LARGE_POS).all()


@pytest.mark.cuda
def test_explore_kernel_matches_plain_on_card(cuda_device):
    """On the card, explore_batch_packed (K1, then the kernel: one launch)
    equals the plain version on the same K1 outputs, row for row, on a
    repeat-rich library's routed reads and on an explore_cases batch,
    prefilter on and off."""
    sim = rnase_r_library(seed=13, chrom_lengths={"chrR": 300_000},
                          n_circ=60, n_linear=8, depth_mean=4.0,
                          repeat_frac=0.4, cfg=CFG)
    jd = jp.DeviceIndex.build(sim.genome, build_index(sim.genome, CFG),
                              CFG)
    td = tp.DeviceIndex.from_reference(jd, device=cuda_device)
    reads = [s for _, s in sim.reads
             if 2 * CFG.anchor_len <= len(s) <= CFG.max_read_len]
    arr, lens = tp.encode_batch(reads, len(reads), CFG.max_read_len)
    multi = tp.unpack_results(tp.dispatch_packed(
        td, arr, lens, CFG).cpu().numpy())["multi"] & 1
    routed = np.flatnonzero(multi)
    assert routed.size >= 20
    R = _t(arr[routed]).to(cuda_device)
    L = _t(lens[routed]).to(cuda_device)
    lib_args = tx.explore_k1(td.words, td.nbases, td.table, td.meta, td.ext,
                             td.ext_id, td.chrom_offsets, R, L, CFG)
    case_args = explore_cases.pair_args(
        explore_cases.explore_case(3, 256, CFG), CFG, cuda_device)
    for args in (lib_args, case_args):
        for prefilter in (True, False):
            before = tx.launches
            got = tx.explore_pairs(*args, CFG, prefilter)
            torch.cuda.synchronize()
            assert tx.launches == before + 1
            assert torch.equal(got, tx.explore_pairs_ref(*args, CFG,
                                                         prefilter))
    before = tx.launches
    got = tx.explore_batch_packed(td.words, td.nbases, td.table, td.meta,
                                  td.ext, td.ext_id, td.chrom_offsets, R, L,
                                  CFG, True)
    assert tx.launches == before + 1
    assert torch.equal(got, tx.explore_pairs_ref(*lib_args, CFG, True))


def test_explore_c_call_runs_on_the_tensors_device(case, monkeypatch):
    """explore_pairs' C call runs with its tensors' device current (the
    C entry refuses any other device)."""
    from find_circ2_tpu_torch import _build
    args = explore_cases.pair_args(case, CFG)
    seen, current = [], [0]

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            self.prev, current[0] = current[0], self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    class Lib:
        def fc2t_explore(self, buf):
            seen.append((current[0], _build.EXPLORE_ARGS.unpack(buf)[-1]))
            return 1

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(tx, "_check", lambda *a: [args[3]] * 23)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 2)
    before = tx.launches
    out = tx._launch(args, CFG, True)
    assert out.shape == (CASE_ROWS, 14) and tx.launches == before + 1
    assert seen == [(2, 2)] and current == [0]
