"""Detect's core (find_circ2_tpu_torch/ops/detect.detect_core_packed, K-e +
K-f) and K1 v4's exact-first probe (ops/anchor_align.exact_anchor_stats,
K-b) of the PyTorch port: their plain versions against the reference JAX
package on the edge cases of utils/detect_cases, the wrappers' routing,
the kernels' constants and the build's hash, and the profiler labels.
The CUDA kernels (csrc/detect.cu, csrc/exact_stats.cu) are held against
their plain versions on the card by tests/test_torch_cards.py, which
imports nothing of JAX. Tolerance 0: every output is an integer."""

import dataclasses
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
from find_circ2_tpu.models import pipeline as jp
from find_circ2_tpu.ops import anchor_align as ja
from find_circ2_tpu.ops.packed import pack_nibbles
from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.index import hashtable as tht
from find_circ2_tpu_torch.models import pipeline as tp
from find_circ2_tpu_torch.ops import anchor_align as ta
from find_circ2_tpu_torch.ops import breakpoint as tb
from find_circ2_tpu_torch.ops import detect as td
from find_circ2_tpu_torch.ops import explore as tx
from find_circ2_tpu_torch.utils import detect_cases

CFG = Config()
CASE_ROWS = 96
CSRC = os.path.join(os.path.dirname(td.__file__), os.pardir, "csrc")


@pytest.fixture(scope="module")
def case():
    return detect_cases.detect_case(2, CASE_ROWS, CFG)


_EDGES = {}


def _edge(name):
    """detect_cases.edge_case(name) at this file's seed and size, and its
    Config, built once."""
    if name not in _EDGES:
        _EDGES[name] = detect_cases.edge_case(name, 2, CASE_ROWS)
    return _EDGES[name]


def _jax_hits(fields):
    return ja.AnchorHits(*(jnp.asarray(fields[f].astype(np.uint32))
                           if f == "pos" else jnp.asarray(fields[f])
                           for f in ja.AnchorHits._fields))


@partial(jax.jit, static_argnames=("nbases", "cfg", "prefilter"))
def _jax_core(gpacked, nbases, chrom_offsets, reads, lens, rc, hits_a,
              hits_b, overflow, cfg, prefilter):
    """The reference's detect_core and packing (detect_batch_packed_fast
    after K1) on given hits."""
    res = jp.detect_core(gpacked, nbases, chrom_offsets, reads, lens,
                         hits_a, hits_b, cfg, prefilter, rc=rc)
    res["multi"] = res["multi"] | (overflow.astype(jnp.int32) << 3)
    sig = res["signal"].astype(jnp.int32)
    cols = [res[k].astype(jnp.int32) for k in tp.PACK_FIELDS[:-1]]
    cols.append(sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                | (sig[:, 3] << 9))
    return jnp.stack(cols, axis=1)


def _jax_case_rows(case, prefilter, overflow, cfg=CFG):
    g = case.genome
    return np.asarray(_jax_core(
        jnp.asarray(pack_nibbles(g.codes)), len(g),
        jnp.asarray(g.chrom_offsets.astype(np.uint32)),
        jnp.asarray(case.reads), jnp.asarray(case.lens),
        jnp.asarray(case.rc), _jax_hits(case.hits[0]),
        _jax_hits(case.hits[1]), jnp.asarray(overflow), cfg=cfg,
        prefilter=prefilter))


@pytest.mark.parametrize(
    "prefilter,overflow,edge",
    [(True, False, None), (False, True, None),
     (True, False, "long-rows"), (False, True, "long-rows"),
     (True, False, "many-chroms")],
    ids=["True-False", "False-True", "long-rows-True-False",
         "long-rows-False-True", "many-chroms-True-False"])
def test_detect_core_plain_matches_jax_on_edge_cases(case, prefilter,
                                                     overflow, edge):
    """detect_core_packed's plain version equals the reference's core on
    the detect_cases batch, every column of every row: the pinned rows
    (padding, unaligned anchors at 2^32 - 1, starts that wrap below 0,
    planted GT..AG and CT..AC sites, N, sense from align_strand 2, every
    status, positions next to 2^32, ties in score, windows clamped at the
    genome's end) and the random ones; and on the edge cases of the
    kernel's paths (detect_cases.EDGE_CASES): reads of up to 301 bases
    in rows off 4 bytes, the last of length Lp; 40 chromosomes with
    anchors on the first, the last and either side of a boundary."""
    c, cfg = (case, CFG) if edge is None else _edge(edge)
    got = td.detect_core_packed(*detect_cases.core_args(c, "cpu", overflow),
                                cfg, prefilter).numpy()
    want = _jax_case_rows(c, prefilter, overflow, cfg)
    assert got.dtype == np.int32 and got.shape == (CASE_ROWS, 14)
    assert np.array_equal(got, want)
    assert ((got[:, 12] >> 3) == int(overflow)).all()
    if edge == "long-rows":
        assert c.reads.shape[1] == 301 and c.lens[-1] == 301
        assert (c.lens > 8 * 16 * 2).any()
    if edge == "many-chroms":
        n = len(c.genome.chrom_names)
        at = len(detect_cases.PINNED)
        chrom, st = got[at:at + 4, 2], got[at:at + 4, 0]
        assert n > 32 and chrom.tolist() == [n - 1, 5, 0, n - 1]
        assert st[1] == jconfig.ST_DIFF_CHROM == st[2]
        assert st[0] != jconfig.ST_DIFF_CHROM != st[3]


def test_pinned_rows_pin_what_they_say(case):
    """The pinned rows of detect_cases give what PINNED says."""
    rows = tp.unpack_results(td.detect_core_packed(
        *detect_cases.core_args(case), CFG, True).numpy())
    off = td.detect_core_packed(*detect_cases.core_args(case), CFG,
                                False).numpy()
    st, sense = rows["status"], rows["sense"]
    n_chroms = len(case.genome.chrom_names)
    assert rows["edits"][0] == tb.BIG and rows["n_bp"][0] == 0
    assert st[1] == jconfig.ST_UNALIGNED_A and rows["chrom"][1] == \
        n_chroms - 1
    assert st[2] == jconfig.ST_DIFF_CHROM
    for b, s in ((3, 0), (4, 1)):
        assert st[b] == jconfig.ST_JUNCTION and sense[b] == s
        assert ''.join("ACGT"[x] for x in rows["signal"][b]) == "GTAG"
    assert rows["kind"][4] == jconfig.KIND_CIRCULAR
    assert st[5] == jconfig.ST_JUNCTION and rows["edits"][5] >= 1
    assert sense[6] == 2 and st[6] == jconfig.ST_UNALIGNED_A
    assert st[7] == jconfig.ST_PREFILTERED
    assert off[7, 0] != jconfig.ST_PREFILTERED
    assert st[8] == jconfig.ST_DIFF_STRAND and st[9] == jconfig.ST_DIFF_CHROM
    assert st[10] == jconfig.ST_ANCHOR_OVERLAP
    assert st[11] == jconfig.ST_NO_JUNCTION
    assert rows["kind"][12] == jconfig.KIND_CIRCULAR    # pB + a wrapped
    assert rows["multi"][13] == 3
    assert st[14] == jconfig.ST_JUNCTION and rows["n_bp"][14] > 1
    assert st[15] == jconfig.ST_JUNCTION and rows["n_bp"][15] == 1
    assert case.lens[16] == CFG.max_read_len
    assert set(st.tolist()) >= {jconfig.ST_JUNCTION, jconfig.ST_PREFILTERED,
                                jconfig.ST_UNALIGNED_A,
                                jconfig.ST_UNALIGNED_B}


@pytest.mark.parametrize("shift,edge",
                         [(0, None), (3_000_000_000, None),
                          (0, "anchor-18"), (0, "anchor-16")],
                         ids=["0", "3000000000", "anchor-18", "anchor-16"])
def test_exact_stats_plain_matches_jax_on_edge_cases(case, shift, edge):
    """exact_anchor_stats' plain version equals the reference on the case's
    anchors, every field and `resolved`: the reads' anchors, the pinned
    ones (dirty and found, dirty and absent, the guarded repeat, a swapped
    key, one substitution off, random, all N), keys whose two buckets
    coincide (counted twice, as the reference does) and an N at the
    first, the last and either side of the prefix's end; with positions
    past 2^31 too; and with anchors of 18 and 16 bases (the kernel reads
    those byte by byte and as four words)."""
    c, cfg = (case, CFG) if edge is None else _edge(edge)
    args = detect_cases.exact_args(c, "cpu", shift)
    hits, resolved = ta.exact_anchor_stats(*args, cfg)
    table, ntable, meta, anchors = (a.numpy() for a in args)
    want, want_res = ja.exact_anchor_stats(jnp.asarray(table),
                                           jnp.asarray(ntable),
                                           jnp.asarray(meta),
                                           jnp.asarray(anchors), cfg)
    for f in ja.AnchorHits._fields:
        assert np.array_equal(getattr(hits, f).numpy().astype(np.int64),
                              np.asarray(getattr(want, f)).astype(np.int64)), f
    assert np.array_equal(resolved.numpy(), np.asarray(want_res))
    n = 2 * CASE_ROWS
    res = resolved.numpy()
    assert res[n] and res[n + 1] and res[n + 6]          # dirty: resolved
    assert hits.n_best[n].item() == 0 and not hits.aligned[n].item()
    assert res[n + 2] and hits.mm[n + 2].item() != 0     # guarded repeat
    assert res[n + 3] and hits.mm[n + 3].item() == 0
    assert hits.strand[n + 3].item() == 1
    assert not res[n + 4] and not res[n + 5]
    assert c.coincident >= 1
    dirty = slice(-len(detect_cases.DIRTY_AT), None)
    assert anchors.shape[1] == cfg.anchor_len
    assert res[dirty].all() and (hits.n_best.numpy()[dirty] == 0).all()
    assert (anchors[dirty] >= 4).sum(1).tolist() == [1] * 4
    if shift:
        aligned = hits.aligned.numpy() & (hits.mm.numpy() == 0)
        assert (hits.pos.numpy()[aligned] >= shift).all() and aligned.any()


@pytest.mark.parametrize("prefilter", [True, False])
def test_detect_fast_plain_matches_jax_on_edge_cases(case, prefilter):
    """detect_batch_packed_fast (the probe, the fallback slice, the core)
    on the case's reads and tables equals the reference's, and so does
    the classic program with an overflowing fallback slice."""
    g = case.genome
    words = detect_cases.core_args(case)[0]
    for cfg in (CFG, dataclasses.replace(CFG, exact_fallback_slots=4)):
        want = np.asarray(jp.detect_batch_packed_fast(
            jnp.asarray(pack_nibbles(g.codes)), len(g),
            jnp.asarray(case.table), jnp.asarray(case.ntable),
            jnp.asarray(case.meta), jnp.asarray(g.chrom_offsets.astype(
                np.uint32)), jnp.asarray(case.reads), jnp.asarray(case.lens),
            cfg, prefilter, rc=jnp.asarray(case.rc)))
        got = tp.detect_batch_packed_fast(
            words, len(g), torch.from_numpy(case.table),
            torch.from_numpy(case.ntable), torch.from_numpy(case.meta),
            torch.from_numpy(g.chrom_offsets), torch.from_numpy(case.reads),
            torch.from_numpy(case.lens), cfg, prefilter,
            torch.from_numpy(case.rc)).numpy()
        assert np.array_equal(got, want)
        assert ((got[:, 12] & 8) != 0).all() == \
            (cfg.exact_fallback_slots < CASE_ROWS)


def _routes(fn, ref_name, module, counter, args, monkeypatch):
    """fn(*args) on CPU tensors calls module.<ref_name> once and launches
    nothing; returns its result."""
    calls = []
    ref = getattr(module, ref_name)

    def spy(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(module, ref_name, spy)
    before = getattr(module, counter)
    got = fn(*args)
    assert calls == [1] and getattr(module, counter) == before
    return got


def _on(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(y.to(device) for y in x))
    return x


def test_detect_routes_cpu_tensors_to_plain(case, monkeypatch):
    """CPU tensors take detect_core_packed_ref and launch nothing; tensors
    on two devices, or on one that is not a CUDA card, raise, and so does
    a missing reverse complement."""
    args = detect_cases.core_args(case, "cpu", True)
    got = _routes(lambda *a: td.detect_core_packed(*a, CFG, True),
                  "detect_core_packed_ref", td, "launches", args,
                  monkeypatch)
    assert torch.equal(got, td.detect_core_packed_ref(*args, CFG, True))
    mixed = list(args)
    mixed[3] = mixed[3].to("meta")                  # reads
    with pytest.raises(ValueError, match="one CUDA device"):
        td.detect_core_packed(*mixed, CFG, True)
    meta = [_on(x, "meta") for x in args]
    with pytest.raises(ValueError, match="CUDA device"):
        td.detect_core_packed(*meta, CFG, True)
    no_rc = list(args)
    no_rc[5] = None
    with pytest.raises(ValueError, match="rc is required"):
        td.detect_core_packed(*no_rc, CFG, True)


def test_exact_routes_cpu_tensors_to_plain(case, monkeypatch):
    """CPU tensors take exact_anchor_stats_ref and launch nothing; tensors
    on two devices, or on one that is not a CUDA card, raise."""
    args = detect_cases.exact_args(case)
    hits, resolved = _routes(lambda *a: ta.exact_anchor_stats(*a, CFG),
                             "exact_anchor_stats_ref", ta, "exact_launches",
                             args, monkeypatch)
    want = ta.exact_anchor_stats_ref(*args, CFG)
    assert all(torch.equal(x, y) for x, y in zip(hits, want[0]))
    assert torch.equal(resolved, want[1])
    mixed = list(args)
    mixed[3] = mixed[3].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ta.exact_anchor_stats(*mixed, CFG)
    with pytest.raises(ValueError, match="CUDA device"):
        ta.exact_anchor_stats(*(a.to("meta") for a in args), CFG)


class _Device:
    """A stand-in for torch.cuda.device that records the current device."""
    current = [0]

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        self.prev, _Device.current[0] = _Device.current[0], self.dev

    def __exit__(self, *exc):
        _Device.current[0] = self.prev


def _stub_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 2)
    _Device.current[0] = 0


def test_detect_c_call_runs_on_the_tensors_device(case, monkeypatch):
    """detect_core_packed's C call runs with its tensors' device current
    (the C entry refuses any other device), and packs the device last but
    one."""
    args = detect_cases.core_args(case, "cpu", False)
    seen = []

    class Lib:
        def fc2t_detect(self, buf):
            seen.append((_Device.current[0],
                         _build.DETECT_ARGS.unpack(buf)[-2]))
            return 1

    monkeypatch.setattr(_build, "load", lambda: Lib())
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(td, "_check", lambda *a: [args[3]] * 16)
    before = td.launches
    out = td._launch(args, CFG, True)
    assert out.shape == (CASE_ROWS, 14) and td.launches == before + 1
    assert seen == [(2, 2)] and _Device.current == [0]


def test_exact_c_call_runs_on_the_tensors_device(case, monkeypatch):
    """exact_anchor_stats' C call runs with its tensors' device current."""
    args = detect_cases.exact_args(case)
    seen = []

    class Lib:
        def fc2t_exact_stats(self, buf):
            seen.append((_Device.current[0],
                         _build.EXACT_ARGS.unpack(buf)[-1]))
            return 1

    monkeypatch.setattr(_build, "load", lambda: Lib())
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(ta, "_check_exact", lambda *a: None)
    before = ta.exact_launches
    hits, resolved = ta._launch_exact(args, CFG)
    assert resolved.shape == (args[3].shape[0],)
    assert ta.exact_launches == before + 1
    assert seen == [(2, 2)] and _Device.current == [0]


class _StampedLib:
    """A stand-in for the measurement build: records each C call (the
    stamps' pointer, or the launch's unpacked arguments) with the current
    device."""

    def __init__(self):
        self.seen = []

    def fc2t_detect(self, buf):
        self.seen.append(("detect", _Device.current[0],
                          _build.DETECT_ARGS.unpack(buf)))
        return 1

    def fc2t_exact_stats(self, buf):
        self.seen.append(("exact", _Device.current[0],
                          _build.EXACT_ARGS.unpack(buf)))
        return 1

    def fc2t_detect_stamps(self, ptr):
        self.seen.append(("detect_stamps", _Device.current[0], ptr))
        return 0

    def fc2t_exact_stamps(self, ptr):
        self.seen.append(("exact_stamps", _Device.current[0], ptr))
        return 0


def test_stage_cycles_reach_the_stamped_c_calls(case, monkeypatch):
    """detect_stage_cycles and exact_stage_cycles each make one C call into
    the (stubbed) measurement build, with the tensors' device current,
    between pointing their kernel's stamps at a zeroed int64 buffer of one
    row a warp (READS_PER_WARP reads, EXACT_ANCHORS_PER_WARP anchors),
    len(stages) + 1 clocks a row, and pointing them nowhere; each counts
    one launch and returns the launch's outputs and the clocks' diffs."""
    lib = _StampedLib()
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(_build, "load_stamped", lambda: lib)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(td, "_check", lambda *a: [None] * 16)
    monkeypatch.setattr(ta, "_check_exact", lambda *a: None)
    made = []
    zeros = torch.zeros

    def spy_zeros(*a, **kw):
        made.append(zeros(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch, "zeros", spy_zeros)
    core = detect_cases.core_args(case, "cpu", False)
    exact = detect_cases.exact_args(case)
    n = exact[3].shape[0]
    before = (td.launches, ta.exact_launches)
    rows, cyc = td.detect_stage_cycles(*core, CFG, True)
    warps = -(-CASE_ROWS // td.READS_PER_WARP)
    assert rows.shape == (CASE_ROWS, 14)
    assert cyc.shape == (warps, len(td.STAGES))
    (hits, resolved), ecyc = ta.exact_stage_cycles(*exact, CFG)
    ewarps = -(-n // ta.EXACT_ANCHORS_PER_WARP)
    assert resolved.shape == (n,) and hits.pos.shape == (n,)
    assert ecyc.shape == (ewarps, len(ta.EXACT_STAGES))
    assert (td.launches, ta.exact_launches) == (before[0] + 1,
                                                before[1] + 1)
    bufs = [t for t in made if t.dtype == torch.int64 and t.dim() == 2]
    assert [tuple(t.shape) for t in bufs] == [
        (warps, len(td.STAGES) + 1), (ewarps, len(ta.EXACT_STAGES) + 1)]
    assert [(e[0], e[1]) for e in lib.seen] == [
        ("detect_stamps", 2), ("detect", 2), ("detect_stamps", 2),
        ("exact_stamps", 2), ("exact", 2), ("exact_stamps", 2)]
    assert [e[2] for e in lib.seen if e[0].endswith("stamps")] == [
        bufs[0].data_ptr(), None, bufs[1].data_ptr(), None]
    assert lib.seen[1][2][-8] == CASE_ROWS                  # B
    assert lib.seen[4][2][-6] == n                          # n
    assert _Device.current == [0]


def _constants(name):
    src = open(os.path.join(CSRC, name)).read()
    return src, {k: int(v, 0) for k, v in re.findall(
        r"\b(k[A-Z]\w*) = (0x[0-9A-Fa-f]+|\d+)u?\b", src)}


def test_kernel_constants_match_config():
    """The codes and constants that csrc/detect.cu, csrc/exact_stats.cu
    and the table's header csrc/cuckoo.cuh spell out equal config.py's,
    ops/breakpoint.py's and index/hashtable.py's, and the argument
    layouts match _build's."""
    src, got = _constants("detect.cu")
    assert 1 << int(re.search(r"kBig = 1 << (\d+);", src).group(1)) == \
        tb.BIG
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
                kSensePlus=jconfig.SENSE_PLUS,
                kSenseMinus=jconfig.SENSE_MINUS,
                kPackFields=len(tp.PACK_FIELDS))
    assert {k: got[k] for k in want} == want
    assert re.search(r"a->Lp > (\d+)", src).group(1) == str(td.MAX_READ_LEN)
    assert "sizeof(DetectArgs) == %d" % _build.DETECT_ARGS.size in src
    Lp = td.MAX_READ_LEN
    assert (2 * Lp * 8 + 6) * (Lp + 2) + Lp < 2 ** 31
    # The table's layout and hash, shared through csrc/cuckoo.cuh.
    head, got = _constants("cuckoo.cuh")
    want = dict(kSlots=jht.SLOTS, kLanes=jht.LANES, kCntBits=jht.CNT_BITS,
                kC1=tht._C1, kC2=tht._C2, kC3=tht._C3,
                kLargeMm=ta.LARGE_MM)
    assert {k: got[k] for k in want} == want
    assert "kS8Mask = 0x%x" % jht.S8_MASK in head.replace("ffffu", "ffff")
    src, got = _constants("exact_stats.cu")
    want = dict(kNbrLanes=jht.NBR_LANES, kMaxAnchor=ta.MAX_ANCHOR_LEN)
    assert {k: got[k] for k in want} == want
    assert '#include "cuckoo.cuh"' in src and "mix_hash(uint32_t" not in src
    assert "sizeof(ExactArgs) == %d" % _build.EXACT_ARGS.size in src
    # The measurement build's clocks: one more a warp than stages, and
    # the anchors or reads a warp takes.
    assert got["kExactStamps"] == len(ta.EXACT_STAGES) + 1
    assert got["kAnchorsPerWarp"] == ta.EXACT_ANCHORS_PER_WARP
    src, got = _constants("detect.cu")
    assert got["kDetectStamps"] == len(td.STAGES) + 1
    assert got["kReadsPerWarp"] == td.READS_PER_WARP
    assert "-DFC2T_DETECT_STAMPS" in _build.STAMP_FLAGS
    assert "fc2t_detect_stamps" in _build.STAMP_ENTRIES
    assert "fc2t_exact_stamps" in _build.STAMP_ENTRIES
    for name in ("detect.cu", "exact_stats.cu"):
        assert "#ifdef FC2T_DETECT_STAMPS" in open(os.path.join(
            CSRC, name)).read()


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """The built library's name hashes every csrc/*.cu and *.cuh: an
    edited header gives a new library, so a stale one is never loaded."""
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name), "rb") as src, \
                open(tmp_path / name, "wb") as dst:
            dst.write(src.read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build.library_path()
    headers = sorted(p for p in os.listdir(tmp_path) if p.endswith(".cuh"))
    assert headers == ["cuckoo.cuh", "nibbles.cuh"]
    seen = {before}
    for header in headers:
        with open(tmp_path / header, "a") as fh:
            fh.write("// edited\n")
        seen.add(_build.library_path())
    assert len(seen) == 3
    assert {os.path.basename(s) for s in _build._sources()} == {
        "classic_k1.cu", "detect.cu", "exact_stats.cu", "explore.cu",
        "gather_rows.cu", "merge.cu", "shard_k1.cu"}


def test_profiler_labels_split_a_batch(case):
    """A detect batch's phases and an explore chunk's carry their
    record_function labels (the split of PERF.md §5)."""
    from torch.profiler import ProfilerActivity, profile
    g = case.genome
    words = detect_cases.core_args(case)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tp.detect_batch_packed_fast(
            words, len(g), torch.from_numpy(case.table),
            torch.from_numpy(case.ntable), torch.from_numpy(case.meta),
            torch.from_numpy(g.chrom_offsets), torch.from_numpy(case.reads),
            torch.from_numpy(case.lens), CFG, True,
            torch.from_numpy(case.rc))
    names = {e.name for e in prof.events()}
    assert {"read_anchors", "k1_exact", "k1_fallback",
            "detect_core"} <= names
    src = open(tx.__file__).read()
    assert 'record_function("explore_k1")' in src
    assert 'record_function("explore_pairs")' in src
