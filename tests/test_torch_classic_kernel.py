"""K1's classic enumeration (find_circ2_tpu_torch/ops/anchor_align.
classic_anchor_stats, K-d) and K1 v4's fallback slice (fallback_slice and
refill_slice, K-c) of the PyTorch port: their plain versions against the
reference JAX package on the edge cases of utils/detect_cases, the pinned
anchors, the wrappers' routing, the C calls' device, the kernels'
constants and the profiler labels. The CUDA kernels (csrc/classic_k1.cu)
are held against their plain versions on the card by
tests/test_torch_cards.py, which imports nothing of JAX. Tolerance 0:
every output is an integer."""

import dataclasses
import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from find_circ2_tpu.config import Config
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.ops import anchor_align as ja
from find_circ2_tpu.ops.packed import pack_nibbles
from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.index import hashtable as tht
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.ops import anchor_align as ta
from find_circ2_tpu_torch.ops import explore as tx
from find_circ2_tpu_torch.utils import detect_cases

CFG = Config()
CASE_ROWS = 96
LARGE_POS = 0xFFFFFFFF
V = 1 + 3 * CFG.anchor_len
K1 = CFG.max_pair_hits - 1
CSRC = os.path.join(os.path.dirname(ta.__file__), os.pardir, "csrc")
# The pinned anchors, after the case's 2 * CASE_ROWS read anchors.
PIN = {name: 2 * CASE_ROWS + i for i, name in enumerate(
    ("dirty", "absent", "repeat", "swapped", "one_off", "random", "all_n",
     "many", "past", "inside"))}

j_candidate_stats = jax.jit(ja.candidate_stats, static_argnames=("cfg",))
j_finalize_hits = jax.jit(ja.finalize_hits, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def case():
    return detect_cases.detect_case(2, CASE_ROWS, CFG)


def _tables(case, device="cpu"):
    """(table, meta, ext, ext_id) of a case as tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (case.table, case.meta, case.ext, case.ext_id))


def _jax_stats(case, anchors, extras, meta=None):
    return j_candidate_stats(
        jnp.asarray(case.table), jnp.asarray(case.meta if meta is None
                                             else meta),
        jnp.asarray(anchors), CFG,
        *((jnp.asarray(case.ext.view(np.uint32)), jnp.asarray(case.ext_id))
          if extras else ()))


def _same(got, want):
    assert np.array_equal(np.asarray(got).astype(np.int64),
                          np.asarray(want).astype(np.int64))


def test_pin_names_follow_pinned_anchors(case):
    """PIN names detect_cases.PINNED_ANCHORS in order, and the case's
    anchors hold them after the reads' anchors, then the coincident
    keys' and DIRTY_AT's."""
    pins = detect_cases.PINNED_ANCHORS
    assert len(PIN) == len(pins)
    for name, words in (("repeat", "max_bucket"), ("many", "HIT_COPIES"),
                        ("past", "past the last"), ("inside", "inside"),
                        ("all_n", "all N")):
        assert words in pins[PIN[name] - 2 * CASE_ROWS]
    assert (case.anchors[PIN["all_n"]] == 4).all()
    assert case.anchors.shape[0] == (PIN["inside"] + 1 + case.coincident - 2
                                     + len(detect_cases.DIRTY_AT))


@pytest.mark.parametrize("extras", [False, True])
def test_candidate_stats_plain_matches_jax_on_edge_cases(case, extras):
    """candidate_stats' plain version equals the reference on every anchor
    of the case, every element of count, first_pos and (with the §2b
    ext and ext_id) extras, zero-count slots included: a slot guarded or
    of a dirty anchor keeps its least position and its row."""
    table, meta, ext, ext_id = _tables(case)
    got = ta.candidate_stats(table, meta, torch.from_numpy(case.anchors),
                             CFG, *((ext, ext_id) if extras else ()))
    want = _jax_stats(case, case.anchors, extras)
    assert len(got) == len(want) == (5 if extras else 4)
    for x, w in zip(got, want):
        _same(x.numpy(), w)
    count, first_pos = got[0].numpy(), got[1].numpy()
    assert ((count == 0) & (first_pos != LARGE_POS)).any()


def test_finalize_hits_plain_matches_jax(case):
    """finalize_hits' plain version equals the reference on the case's
    statistics, every AnchorHits field."""
    table, meta, _, _ = _tables(case)
    got = ta.finalize_hits(*ta.candidate_stats(
        table, meta, torch.from_numpy(case.anchors), CFG), CFG)
    want = j_finalize_hits(*_jax_stats(case, case.anchors, False), CFG)
    for f in ja.AnchorHits._fields:
        _same(getattr(got, f).numpy(), getattr(want, f))


@pytest.mark.parametrize("extras", [False, True])
def test_classic_anchor_stats_is_candidate_stats_and_finalize_hits(
        case, extras):
    """classic_anchor_stats on CPU tensors gives finalize_hits of
    candidate_stats, and with stats=True its count, first_pos and (with
    ext) extras; the reference agrees."""
    table, meta, ext, ext_id = _tables(case)
    anchors = torch.from_numpy(case.anchors)
    x = (ext, ext_id) if extras else ()
    hits, stats = ta.classic_anchor_stats(table, meta, anchors, CFG, *x,
                                          stats=True)
    want = _jax_stats(case, case.anchors, extras)
    jh = j_finalize_hits(*want[:4], CFG)
    for f in ja.AnchorHits._fields:
        _same(getattr(hits, f).numpy(), getattr(jh, f))
    assert len(stats) == (3 if extras else 2)
    for got, w in zip(stats, (want[0], want[1], *want[4:])):
        _same(got.numpy(), w)
    only, none = ta.classic_anchor_stats(table, meta, anchors, CFG)
    assert none is None
    assert all(torch.equal(a, b) for a, b in zip(only, hits))
    assert all(torch.equal(a, b) for a, b in zip(
        ta.align_anchors(table, meta, anchors, CFG), hits))
    with pytest.raises(ValueError, match="only with stats"):
        ta.classic_anchor_stats(table, meta, anchors, CFG, ext, ext_id)


def test_pinned_classic_anchors_pin_what_they_say(case):
    """The pinned anchors give what detect_cases.PINNED_ANCHORS says under
    the enumeration with the extras: a slot whose count exceeds K with a
    full ext row; the guarded repeat's exact slot at count 0 with its
    real first position; two keys whose buckets coincide, counted twice,
    one ext row id doubled past the last row (LARGE_POS), one doubled to
    2, inside the rows."""
    table, meta, ext, ext_id = _tables(case)
    anchors = torch.from_numpy(case.anchors)
    _, (count, first_pos, extras) = ta.classic_anchor_stats(
        table, meta, anchors, CFG, ext, ext_id, stats=True)
    count, first_pos, extras = (x.numpy() for x in (count, first_pos,
                                                    extras))
    ext_u = case.ext.view(np.uint32)
    K = CFG.max_pair_hits
    # More than K hits: the exact '+' or '-' slot of the planted 20-mer.
    many = PIN["many"]
    exact = count[many, [0, V]]
    assert exact.max() == detect_cases.HIT_COPIES > K
    s = [0, V][int(exact.argmax())]
    assert (extras[many, s] != LARGE_POS).all()
    assert (np.diff(extras[many, s].astype(np.int64)) > 0).all()
    assert extras[many, s, 0] > first_pos[many, s]
    # Guarded: count 0 at the exact slots, the real least position.
    rep = PIN["repeat"]
    assert (count[rep, [0, V]] == 0).all()
    assert min(first_pos[rep, [0, V]]) < LARGE_POS
    assert (extras[rep, [0, V]] == LARGE_POS).all()
    # Coincident buckets: counts 3 ('+') and 2 ('-') doubled; ext row id
    # doubled past the last row, or to 2.
    for name, rid in (("past", ext_u.shape[0] - 1), ("inside", 1)):
        b = PIN[name]
        assert sorted(count[b, [0, V]].tolist()) == [4, 6]
        row = (ext_u[2 * rid] if 2 * rid < ext_u.shape[0]
               else np.full(2 * K1, LARGE_POS, np.uint32))
        got = np.concatenate([extras[b, 0], extras[b, V]])
        assert sorted(got.tolist()) == sorted(row.astype(np.int64).tolist())
        assert (2 * rid >= ext_u.shape[0]) == (name == "past")
    assert (extras[PIN["past"], [0, V]] == LARGE_POS).all()
    assert (extras[PIN["inside"], [0, V]] != LARGE_POS).any()
    assert case.coincident >= 2


def test_bucket_past_the_table_reads_empty(case):
    """With n_buckets past the table's rows, a bucket at or past them
    reads as the reference's jnp.take fill: no key, nothing counted. The
    plain candidate_stats and exact_anchor_stats equal the reference."""
    table, meta, ext, ext_id = _tables(case)
    big = case.meta.copy()
    big[2] = 2 * case.table.shape[0] + 1
    anchors = torch.from_numpy(case.anchors)
    got = ta.candidate_stats(table, torch.from_numpy(big), anchors, CFG,
                             ext, ext_id)
    want = _jax_stats(case, case.anchors, True, meta=big)
    for x, w in zip(got, want):
        _same(x.numpy(), w)
    hits, resolved = ta.exact_anchor_stats(
        table, torch.from_numpy(case.ntable), torch.from_numpy(big),
        anchors, CFG)
    jh, jres = ja.exact_anchor_stats(
        jnp.asarray(case.table), jnp.asarray(case.ntable), jnp.asarray(big),
        jnp.asarray(case.anchors), CFG)
    for f in ja.AnchorHits._fields:
        _same(getattr(hits, f).numpy(), getattr(jh, f))
    _same(resolved.numpy(), jres)


def _jax_slice(resolved, k):
    order = jnp.argsort(jnp.asarray(resolved.astype(np.int8)), stable=True)
    return np.asarray(order[:k]), bool(jnp.sum(~jnp.asarray(resolved)) > k)


@pytest.mark.parametrize("n,unresolved,k", detect_cases.SLICE_SIZES,
                         ids=[detect_cases.slice_id(*c)
                              for c in detect_cases.SLICE_SIZES])
def test_fallback_slice_plain_matches_jax(n, unresolved, k):
    """fallback_slice's plain version equals the reference's stable
    argsort of `resolved` (its first k indices, k = min(
    exact_fallback_slots, n) as the stream takes it, or 0 or n) and its
    overflow flag, at the compaction kernel's edge sizes."""
    resolved, k = detect_cases.slice_flags(n, unresolved, k, CFG)
    idx, overflow = ta.fallback_slice(torch.from_numpy(resolved), k)
    want, want_over = _jax_slice(resolved, k)
    assert idx.dtype == torch.int64 and idx.shape == (k,)
    assert np.array_equal(idx.numpy(), want)
    assert overflow.dim() == 0 and bool(overflow) == want_over
    assert want_over == (unresolved > k)
    first = min(unresolved, k)
    assert not resolved[idx.numpy()[:first]].any()
    assert resolved[idx.numpy()[first:]].all()


@pytest.mark.parametrize("slots", [1024, 4])
def test_fast_pair_plain_matches_jax(case, slots):
    """align_anchor_pair_fast (probe, slice, refill) on the case's read
    anchors equals the reference's, with a slice that holds every
    unresolved anchor and one that overflows."""
    table, meta, _, _ = _tables(case)
    cfg = dataclasses.replace(CFG, exact_fallback_slots=slots)
    n = CASE_ROWS
    A, B = case.anchors[:n], case.anchors[n:2 * n]
    want = ja.align_anchor_pair_fast(
        jnp.asarray(case.table), jnp.asarray(case.ntable),
        jnp.asarray(case.meta), jnp.asarray(A), jnp.asarray(B), cfg)
    got = ta.align_anchor_pair_fast(table, torch.from_numpy(case.ntable),
                                    meta, torch.from_numpy(A),
                                    torch.from_numpy(B), cfg)
    for g, w in zip(got[:2], want[:2]):
        for f in ja.AnchorHits._fields:
            _same(getattr(g, f).numpy(), getattr(w, f))
    assert bool(got[2]) == bool(want[2]) == (slots == 4)


def test_explore_k1_is_one_stacked_call(case):
    """explore_k1 enumerates both anchors in one classic_anchor_stats call
    and splits its rows: each half equals the reference's candidate_stats
    and finalize_hits of that anchor, and each tensor is contiguous."""
    table, meta, ext, ext_id = _tables(case)
    calls = []
    real = ta.classic_anchor_stats

    def spy(*a, **kw):
        calls.append(a[2].shape[0])
        return real(*a, **kw)

    g = case.genome
    words = detect_cases.core_args(case)[0]
    reads, lens = torch.from_numpy(case.reads), torch.from_numpy(case.lens)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tx, "classic_anchor_stats", spy)
        args = tx.explore_k1(words, len(g), table, meta, ext, ext_id,
                             torch.from_numpy(g.chrom_offsets), reads, lens,
                             CFG)
    assert calls == [2 * CASE_ROWS]
    anchors = ta.read_anchors(reads, lens, CFG)
    mm_v = args[9]
    _same(mm_v.numpy(), ja.variant_metadata(CFG)[0])
    for stats, hits, anc in ((args[5], args[7], anchors[0]),
                             (args[6], args[8], anchors[1])):
        want = _jax_stats(case, anc.numpy(), True)
        for x, w in zip(stats, (want[0], want[1], want[4])):
            assert x.is_contiguous()
            _same(x.numpy(), w)
        jh = j_finalize_hits(*want[:4], CFG)
        for f in ja.AnchorHits._fields:
            assert getattr(hits, f).is_contiguous()
            _same(getattr(hits, f).numpy(), getattr(jh, f))


def _routes(fn, names, monkeypatch):
    """fn() on CPU tensors calls each plain version of `names` and
    launches nothing."""
    calls = []
    for name in names:
        ref = getattr(ta, name)

        def spy(*a, ref=ref, name=name, **kw):
            calls.append(name)
            return ref(*a, **kw)

        monkeypatch.setattr(ta, name, spy)
    before = (ta.classic_launches, ta.compact_launches)
    got = fn()
    assert set(calls) == set(names)
    assert (ta.classic_launches, ta.compact_launches) == before
    return got


def test_classic_routes_cpu_tensors_to_plain(case, monkeypatch):
    """CPU tensors take classic_anchor_stats_ref, refill_slice_ref and
    fallback_slice_ref and launch nothing; tensors on two devices, or on
    one that is not a CUDA card, raise."""
    table, meta, ext, ext_id = _tables(case)
    anchors = torch.from_numpy(case.anchors)
    _routes(lambda: ta.classic_anchor_stats(table, meta, anchors, CFG, ext,
                                            ext_id, stats=True),
            ["classic_anchor_stats_ref"], monkeypatch)
    _routes(lambda: ta.align_anchor_pair_fast(
        table, torch.from_numpy(case.ntable), meta, anchors[:8],
        anchors[8:16], CFG),
        ["fallback_slice_ref", "refill_slice_ref"], monkeypatch)
    with pytest.raises(ValueError, match="one CUDA device"):
        ta.classic_anchor_stats(table, meta, anchors.to("meta"), CFG)
    with pytest.raises(ValueError, match="CUDA device"):
        ta.classic_anchor_stats(table.to("meta"), meta.to("meta"),
                                anchors.to("meta"), CFG)
    with pytest.raises(ValueError, match="CUDA device"):
        ta.fallback_slice(torch.ones(8, dtype=torch.bool, device="meta"), 4)


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
    monkeypatch.setattr(ta, "_check_classic", lambda *a: None)
    monkeypatch.setattr(ta, "_check_compact", lambda *a: None)
    _Device.current[0] = 0
    return lib


def test_cuda_tensors_reach_the_c_calls(case, monkeypatch):
    """A tensor that is not on the CPU takes the kernels: the enumeration
    (hits, with the statistics and extras, and the slice's refill) and
    the compaction each make one C call into the (stubbed) library, with
    the tensors' device current, the modes' pointers set as the C entry
    wants them, and one launch counted each; the plain versions are not
    called."""
    lib = _stub_cuda(monkeypatch)
    for name in ("classic_anchor_stats_ref", "refill_slice_ref",
                 "fallback_slice_ref"):
        monkeypatch.setattr(ta, name, lambda *a, **kw: pytest.fail(
            "a tensor off the CPU took a plain version"))
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda s: False))
    table, meta, ext, ext_id = _tables(case)
    anchors = torch.from_numpy(case.anchors)
    n = anchors.shape[0]
    before = (ta.classic_launches, ta.compact_launches)
    hits, stats = ta.classic_anchor_stats(table, meta, anchors, CFG, ext,
                                          ext_id, stats=True)
    assert [tuple(x.shape) for x in stats] == [(n, 2 * V), (n, 2 * V),
                                               (n, 2 * V, K1)]
    assert [x.dtype for x in stats] == [torch.int32, torch.int64,
                                        torch.int64]
    assert ta.classic_anchor_stats(table, meta, anchors, CFG)[1] is None
    idx, overflow = ta.fallback_slice(torch.zeros(n, dtype=torch.bool), 64)
    assert idx.shape == (64,) and overflow.shape == ()
    out = ta.refill_slice(table, meta, anchors, idx, hits, CFG)
    assert all(a is b for a, b in zip(out, hits))      # in place
    assert (ta.classic_launches, ta.compact_launches) == (before[0] + 3,
                                                          before[1] + 1)
    (e1, d1, full), (e2, d2, bare), (e3, d3, comp), (e4, d4, slot) = \
        lib.seen
    assert (e1, e2, e3, e4) == ("classic", "classic", "compact", "classic")
    assert d1 == d2 == d3 == d4 == 2 and _Device.current == [0]
    # ClassicArgs: ext_id, ext, slots at 3..5; count, first_pos, extras
    # at 13..15; then rows, ext_rows, n, anchor_len, prefix_len,
    # max_bucket, max_anchor_mm, ext_width, device, reserved; the keys
    # looked up (every key); then the partials mode's records (null: none
    # of these calls is one).
    assert full[3] == ext_id.data_ptr() and full[4] == ext.data_ptr()
    assert full[5] == 0 and all(full[13:16])
    assert full[17:] == (table.shape[0], ext.shape[0], n, CFG.anchor_len,
                         CFG.prefix_len, CFG.max_bucket, CFG.max_anchor_mm,
                         K1, 2, 0, *ta.EVERY_KEY, 0)
    assert bare[-1] == slot[-1] == 0
    assert bare[3:6] == (0, 0, 0) and bare[13:16] == (0, 0, 0)
    assert slot[5] == idx.data_ptr() and slot[13:16] == (0, 0, 0)
    assert slot[6] == hits.aligned.data_ptr() and slot[19] == 64
    assert comp[1] == idx.data_ptr() and comp[4:] == (n, 64, 2, 0)


class _StampedLib(_Lib):
    """A stand-in for the measurement build: also records where the
    stamps go (the buffer's pointer, then null) and the current device."""

    def fc2t_classic_stamps(self, ptr):
        self.seen.append(("stamps", _Device.current[0], ptr))
        return 0


def test_classic_stage_cycles_reach_the_stamped_c_calls(case, monkeypatch):
    """classic_stage_cycles and compact_stage_cycles each make one C call
    into the (stubbed) measurement build, with the tensors' device
    current, between pointing the stamps at a zeroed int64 buffer of one
    row a warp (a slot in slot mode) or one row for the compaction's block,
    len(stages) + 1 clocks a row, and pointing them nowhere; each counts
    one launch and returns the launch's outputs and the clocks' diffs."""
    lib = _StampedLib()
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(_build, "load_stamped", lambda: lib)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    table, meta, ext, ext_id = _tables(case)
    anchors = torch.from_numpy(case.anchors)
    n = anchors.shape[0]
    made = []
    zeros = torch.zeros

    def spy_zeros(*a, **kw):
        made.append(zeros(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch, "zeros", spy_zeros)
    before = (ta.classic_launches, ta.compact_launches)
    (hits, stats), cyc = ta.classic_stage_cycles(table, meta, anchors, CFG,
                                                 ext, ext_id, stats=True)
    assert len(stats) == 3 and hits.pos.shape == (n,)
    assert cyc.shape == (n, len(ta.CLASSIC_STAGES))
    (idx, over), ccyc = ta.compact_stage_cycles(
        torch.zeros(n, dtype=torch.bool), 64)
    assert idx.shape == (64,) and ccyc.shape == (1, len(ta.COMPACT_STAGES))
    slots = idx[:16]
    (got, none), scyc = ta.classic_stage_cycles(table, meta, anchors, CFG,
                                                slots=slots, hits=hits)
    assert none is None and all(a is b for a, b in zip(got, hits))
    assert scyc.shape == (16, len(ta.CLASSIC_STAGES))
    assert (ta.classic_launches, ta.compact_launches) == (before[0] + 2,
                                                          before[1] + 1)
    bufs = [t for t in made if t.dtype == torch.int64 and t.dim() == 2]
    assert [tuple(t.shape) for t in bufs] == [
        (n, len(ta.CLASSIC_STAGES) + 1), (1, len(ta.COMPACT_STAGES) + 1),
        (16, len(ta.CLASSIC_STAGES) + 1)]
    entries = [(e[0], e[1]) for e in lib.seen]
    assert entries == [("stamps", 2), ("classic", 2), ("stamps", 2)] + [
        ("stamps", 2), ("compact", 2), ("stamps", 2)] + [
        ("stamps", 2), ("classic", 2), ("stamps", 2)]
    ptrs = [e[2] for e in lib.seen if e[0] == "stamps"]
    assert ptrs == [bufs[0].data_ptr(), None, bufs[1].data_ptr(), None,
                    bufs[2].data_ptr(), None]
    assert _Device.current == [0]
    full = lib.seen[1][2]
    assert full[3] == ext_id.data_ptr() and full[19] == n
    slot = lib.seen[7][2]
    assert slot[5] == slots.data_ptr() and slot[19] == 16


def _constants(name):
    src = open(os.path.join(CSRC, name)).read()
    return src, {k: int(v, 0) for k, v in re.findall(
        r"\b(k[A-Z]\w*) = (0x[0-9A-Fa-f]+|\d+)u?\b", src)}


def test_classic_kernel_constants_match_config():
    """csrc/classic_k1.cu's limits equal the wrapper's, its table layout
    comes from csrc/cuckoo.cuh (index/hashtable.py's), and its argument
    layouts match _build's."""
    src, got = _constants("classic_k1.cu")
    assert got["kMaxAnchor"] == ta.MAX_CLASSIC_ANCHOR_LEN
    assert got["kMaxExtWidth"] == ta.MAX_EXTRAS_HITS - 1
    assert ta.MAX_EXTRAS_HITS == tx.MAX_PAIR_HITS
    assert 1 + 3 * ta.MAX_CLASSIC_ANCHOR_LEN <= 32 * got["kPerLane"]
    assert 1 + 3 * CFG.anchor_len <= 32 * got["kPerLane"]
    assert '#include "cuckoo.cuh"' in src and "kSlots = " not in src
    _, head = _constants("cuckoo.cuh")
    assert (head["kSlots"], head["kLanes"], head["kCntBits"]) == (
        tht.SLOTS, tht.LANES, tht.CNT_BITS)
    assert "sizeof(ClassicArgs) == %d" % _build.CLASSIC_ARGS.size in src
    assert "sizeof(CompactArgs) == %d" % _build.COMPACT_ARGS.size in src
    # The measurement build's clocks: one more a warp (block) than stages.
    assert got["kClassicStamps"] == len(ta.CLASSIC_STAGES) + 1
    assert got["kCompactStamps"] == len(ta.COMPACT_STAGES) + 1
    assert "-DFC2T_CLASSIC_STAMPS" in _build.STAMP_FLAGS


def test_profiler_labels_are_unchanged(case):
    """A detect batch's phases (the exact-first program and the classic
    redo) and an explore chunk's carry their record_function labels."""
    from torch.profiler import ProfilerActivity, profile
    g = case.genome
    table, meta, ext, ext_id = _tables(case)
    words = detect_cases.core_args(case)[0]
    offsets = torch.from_numpy(g.chrom_offsets)
    reads, lens = torch.from_numpy(case.reads), torch.from_numpy(case.lens)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tp.detect_batch_packed_fast(
            words, len(g), table, torch.from_numpy(case.ntable), meta,
            offsets, reads, lens, CFG, True, torch.from_numpy(case.rc))
        tp.detect_batch_packed(words, len(g), table, meta, offsets, reads,
                               lens, CFG, True, torch.from_numpy(case.rc))
        tx.explore_batch_packed(words, len(g), table, meta, ext, ext_id,
                                offsets, reads[:16], lens[:16], CFG)
    names = {e.name for e in prof.events()}
    assert {"read_anchors", "k1_exact", "k1_fallback", "k1_classic",
            "detect_core", "explore_k1", "explore_pairs"} <= names


@partial(jax.jit, static_argnames=("nbases", "cfg", "prefilter"))
def _jax_classic(gpacked, nbases, table, meta, chrom_offsets, reads, lens,
                 rc, cfg, prefilter):
    return jp.detect_batch_packed(gpacked, nbases, table, meta,
                                  chrom_offsets, reads, lens, cfg,
                                  prefilter, rc=rc)


def test_classic_redo_plain_matches_jax(case):
    """The classic redo (detect_batch_packed: the enumeration of both
    anchors, then the core) on the case's reads equals the reference's."""
    g = case.genome
    table, meta, _, _ = _tables(case)
    got = tp.detect_batch_packed(
        detect_cases.core_args(case)[0], len(g), table, meta,
        torch.from_numpy(g.chrom_offsets), torch.from_numpy(case.reads),
        torch.from_numpy(case.lens), CFG, True,
        torch.from_numpy(case.rc)).numpy()
    want = np.asarray(_jax_classic(
        jnp.asarray(pack_nibbles(g.codes)), len(g), jnp.asarray(case.table),
        jnp.asarray(case.meta), jnp.asarray(g.chrom_offsets.astype(
            np.uint32)), jnp.asarray(case.reads), jnp.asarray(case.lens),
        jnp.asarray(case.rc), cfg=CFG, prefilter=True))
    assert np.array_equal(got, want)
