"""K-h, the junction merge (find_circ2_tpu_torch/ops/merge.py), on the
edge cases of utils/merge_cases: the plain version (what CPU tensors
take) of merge_junctions and merge_tables against the JAX package on all
N output rows, fill rows included; the wrappers' routing (a tensor off
the CPU reaches the stubbed C call of csrc/merge.cu with one scratch
buffer of the size the library asks for, and counts the call and its
kernels); merge_stage_cycles through the stubbed measurement build; and
the kernel's argument layout and constants. The kernel itself is held against the
plain version on the card by tests/test_torch_cards.py and chip_smoke.py.
Tolerance 0: every output is an integer."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from find_circ2_tpu.config import Config
from find_circ2_tpu.ops import merge as jm
from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.ops import merge as tm
from find_circ2_tpu_torch.utils.merge_cases import CASES, merge_case

CFG = Config()
CSRC = os.path.join(os.path.dirname(tm.__file__), os.pardir, "csrc")


def _port(res: dict) -> dict:
    """Host arrays as the port's detect results hold them (positions as
    int64)."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v) for k, v in res.items()}


def _assert_tables_equal(got: dict, want: dict) -> None:
    """All N rows of every field, values, dtypes' kinds and shapes."""
    assert set(got) == set(want) == set(tm.ALL_FIELDS)
    for k in tm.ALL_FIELDS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert got[k].dtype == tm.TABLE_DTYPES[k], k
        assert g.shape == w.shape, k
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), (
            k, g[:8], w[:8])


def _both(name, n, seed):
    res, lens = merge_case(name, n, seed)
    got = tm.merge_junctions(_port(res), torch.from_numpy(lens), CFG)
    want = jm.merge_junctions({k: jnp.asarray(v) for k, v in res.items()},
                              jnp.asarray(lens), CFG)
    return got, want


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n", [1, 97, 300])
def test_merge_junctions_edge_cases_match_jax(name, n):
    got, want = _both(name, n, seed=len(name) + n)
    _assert_tables_equal(got, want)
    heads = int(got["valid"].sum())
    if name == "all-dead":
        assert heads == 0
        # Segment N - 1 holds the dead rows; every other keeps the
        # identities.
        assert int(got["edits"][-1]) == tm.BIGDEF
        assert int(got["best_qual_left"][-1]) == 0
        if n > 1:
            assert int(got["edits"][0]) == tm.I32_MAX
            assert int(got["best_qual_left"][0]) == tm.I32_MIN
    elif name == "one-key":
        assert heads == 1 and int(got["n_reads"][0]) == n
    elif name == "distinct":
        assert heads == n
    elif name == "dups" and n > 1:
        assert heads < n and int(got["edits"][-1]) == tm.I32_MAX
    elif name == "big":
        assert (got["start"] >= 2 ** 31).all()


def test_stable_case_pins_the_fill_rows():
    """On the "stable" case the fill rows take the raw fields of the last
    dead row by index: a sort that is not stable would give another."""
    res, lens = merge_case("stable", 300, 5)
    got, want = _both("stable", 300, 5)
    _assert_tables_equal(got, want)
    heads = int(got["valid"].sum())
    last_dead = np.flatnonzero(res["status"] != 0)[-1]
    assert heads == 2
    for k in ("kind", "chrom", "start", "sense"):
        assert (got[k][heads:].numpy() == res[k][last_dead]).all(), k
    assert len({int(x) for x in res["kind"][res["status"] != 0]}) > 1


@pytest.mark.parametrize("names", [("random", "dups", "big"),
                                   ("one-key", "all-dead", "stable"),
                                   ("distinct", "distinct", "random",
                                    "one-key")])
def test_merge_tables_edge_cases_match_jax(names):
    """Merged tables of several cases stacked [K, N] re-merge to the
    reference's K*N rows."""
    jt, tt = [], []
    for k, name in enumerate(names):
        res, lens = merge_case(name, 80, 40 + k)
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
    def __init__(self):
        self.seen = []
        self.asked = []

    def fc2t_merge_scratch_bytes(self, n):
        self.asked.append(n)
        return 100 * n + 256

    def fc2t_merge(self, buf):
        self.seen.append((_Device.current[0], _build.MERGE_ARGS.unpack(buf)))
        return tm.merge_kernels(self.seen[-1][1][34])


def _stub_cuda(monkeypatch, lib=None):
    lib = lib or _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 2)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda s: False))
    monkeypatch.setattr(tm, "_check_merge",
                        lambda src: next(iter(src.values())).shape[0])
    monkeypatch.setattr(tm, "_sort_combine", lambda t: pytest.fail(
        "a tensor off the CPU took the plain version"))
    _Device.current[0] = 0
    return lib


@pytest.mark.parametrize("n", [64, tm.TILE_ROWS, tm.TILE_ROWS + 1, 8193])
def test_cuda_tensors_reach_the_c_call(n, monkeypatch):
    """A tensor off the CPU takes the kernel: merge_junctions and
    merge_tables each make one C call with the columns' device current,
    the result's or the table's pointers where MergeArgs wants them, the
    outputs of the plain version's dtypes, one scratch buffer of the
    bytes fc2t_merge_scratch_bytes gives, and the call and its kernels
    counted (two up to TILE_ROWS rows, three above)."""
    lib = _stub_cuda(monkeypatch)
    made = []
    empty = torch.empty

    def spy_empty(*a, **kw):
        made.append(empty(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch, "empty", spy_empty)
    res, lens = merge_case("random", n, 3)
    res = _port(res)
    lens = torch.from_numpy(lens)
    before = (tm.calls, tm.launches)
    out = tm.merge_junctions(res, lens, CFG)
    assert {k: v.dtype for k, v in out.items()} == tm.TABLE_DTYPES
    assert all(v.shape == (n,) for v in out.values())
    table = tm.merge_tables({k: torch.stack([v, v]) for k, v in out.items()})
    assert table["valid"].shape == (2 * n,)
    assert (tm.calls, tm.launches) == (
        before[0] + 2, before[1] + tm.merge_kernels(n)
        + tm.merge_kernels(2 * n))
    assert lib.asked == [n, 2 * n]
    (d1, a1), (d2, a2) = lib.seen
    assert d1 == d2 == 2 and _Device.current == [0]
    # MergeArgs: 18 row pointers, 14 outputs, scratch, stream; n, the
    # scratch's bytes; st_junction, min_uniq_qual, device, reserved.
    assert a1[0] == 0 and a1[1] == res["kind"].data_ptr()
    assert a1[6:9] == (0, 0, 0)
    assert a1[9] == res["qual_left"].data_ptr()
    assert a1[14:18] == (res["status"].data_ptr(), lens.data_ptr(),
                         res["multi"].data_ptr(),
                         res["align_strand"].data_ptr())
    assert a1[18] == out["valid"].data_ptr()
    assert a1[31] == out["n_bp"].data_ptr()
    assert a1[34:] == (n, 100 * n + 256, 0, CFG.min_uniq_qual, 2, 0)
    assert a2[0] != 0 and a2[14:18] == (0, 0, 0, 0)
    assert a2[34:] == (2 * n, 200 * n + 256, 0, 0, 2, 0)
    scratch = [t for t in made if t.dtype == torch.uint8]
    assert [t.numel() for t in scratch] == [100 * n + 256, 200 * n + 256]
    assert (a1[32], a2[32]) == tuple(t.data_ptr() for t in scratch)
    # Without "multi" its pointer is null.
    del res["multi"]
    tm.merge_junctions(res, lens, CFG)
    assert lib.seen[-1][1][16] == 0


class _StampedLib(_Lib):
    """A stand-in for the measurement build: records the stamps' pointer
    beside each C call, and its C call writes clocks into `stamps` (the
    buffer the stamps point at), stage k of tile t starting at 10 t + k
    and lasting (k + 1) (t + 1) cycles."""
    stamps = None

    def fc2t_merge_stamps(self, ptr):
        self.seen.append(("stamps", _Device.current[0], ptr))
        return 0

    def fc2t_merge(self, buf):
        got = super().fc2t_merge(buf)
        tiles, cols = self.stamps.shape
        for t in range(tiles):
            for k in range(cols // 2):
                self.stamps[t, 2 * k] = 10 * t + k
                self.stamps[t, 2 * k + 1] = 10 * t + k + (k + 1) * (t + 1)
        return got


@pytest.mark.parametrize("n", [97, 2048])
def test_merge_stage_cycles_reach_the_stamped_c_call(n, monkeypatch):
    """merge_stage_cycles makes one C call into the (stubbed) measurement
    build, with the tensors' device current, between pointing the merge's
    stamps at a zeroed int64 buffer of one row a tile, two clocks a stage,
    and pointing them nowhere; it counts the call and its kernels and
    returns the table and each stage's end minus its start."""
    lib = _StampedLib()
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(_build, "load_stamped", lambda: lib)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    made = []
    zeros = torch.zeros

    def spy_zeros(*a, **kw):
        made.append(zeros(*a, **kw))
        if made[-1].dtype == torch.int64 and made[-1].dim() == 2:
            assert not made[-1].any()
            lib.stamps = made[-1]
        return made[-1]

    monkeypatch.setattr(torch, "zeros", spy_zeros)
    res, lens = merge_case("random", n, 4)
    res = _port(res)
    lens = torch.from_numpy(lens)
    tiles = -(-n // tm.TILE_ROWS)
    before = (tm.calls, tm.launches)
    table, cyc = tm.merge_stage_cycles(res, lens, CFG)
    assert set(table) == set(tm.ALL_FIELDS) and table["valid"].shape == (n,)
    assert (tm.calls, tm.launches) == (before[0] + 1,
                                       before[1] + tm.merge_kernels(n))
    assert tuple(lib.stamps.shape) == (tiles, 2 * len(tm.STAGES))
    kinds = [e[0] if e[0] == "stamps" else "merge" for e in lib.seen]
    assert kinds == ["stamps", "merge", "stamps"]
    assert [lib.seen[0][2], lib.seen[2][2]] == [lib.stamps.data_ptr(), None]
    assert lib.seen[0][1] == lib.seen[1][0] == 2 and _Device.current == [0]
    assert lib.seen[1][1][34] == n
    want = torch.tensor([[(k + 1) * (t + 1) for k in range(len(tm.STAGES))]
                         for t in range(tiles)])
    assert cyc.dtype == torch.int64 and torch.equal(cyc, want)


def test_merge_checks_refuse_what_the_kernel_does_not_take():
    """On the CPU a tensor takes the plain version; the kernel's checks
    refuse columns of another dtype, length or device."""
    res, lens = merge_case("random", 16, 1)
    res = _port(res)
    src = dict({k: res[k] for k in tm.RESULT_FIELDS}, lens=torch.from_numpy(
        lens))
    with pytest.raises(ValueError, match="CUDA device"):
        tm._check_merge(src)
    bad = dict(src, start=src["start"].to(torch.int32))
    with pytest.raises(ValueError, match="start"):
        tm._check_merge(bad)
    bad = dict(src, edits=src["edits"][:8])
    with pytest.raises(ValueError, match="edits"):
        tm._check_merge(bad)


def test_merge_kernel_constants_and_layout():
    """csrc/merge.cu's tile, identities, stage clocks and argument layout
    equal ops/merge.py's and _build's; its entry launches merge_rank only
    above one tile, as merge_kernels counts; and the shared memory of
    each block stays within the static 48 KB."""
    src = open(os.path.join(CSRC, "merge.cu")).read()
    got = {k: v for k, v in re.findall(
        r"\b(k[A-Z]\w*) = ([^;]+);", src)}
    assert int(got["kTile"]) == tm.TILE_ROWS
    assert got["kDeadHi"] == "1 << 24" and got["kBigDef"] == "1 << 30"
    assert tm.BIGDEF == 1 << 30
    assert int(got["kMergeStamps"]) == 2 * len(tm.STAGES)
    assert "sizeof(MergeArgs) == %d" % _build.MERGE_ARGS.size in src
    assert _build.MERGE_ARGS.size == 34 * 8 + 2 * 8 + 4 * 4
    assert "-DFC2T_MERGE_STAMPS" in _build.STAMP_FLAGS
    assert "fc2t_merge_stamps" in _build.STAMP_ENTRIES
    assert ("if (tiles > 1) {\n        cfg.gridDim = dim3(tiles, groups);\n"
            "        err = cudaLaunchKernelEx(&cfg, merge_rank," in src)
    assert "(tiles > 1 ? 3 : 2)" in src
    assert [tm.merge_kernels(n) for n in (0, 1, tm.TILE_ROWS,
                                          tm.TILE_ROWS + 1, 20000)] == [
        0, 2, 2, 3, 3]
    # Each block's static shared memory: merge_tiles' keys and partial
    # counts, merge_rank's staged keys, merge_combine's segments.
    T, parts = tm.TILE_ROWS, int(got["kParts"])
    assert 16 * T + 4 * parts * T <= 48 * 1024
    assert 16 * T + 4 <= 48 * 1024
    assert 8 * (T + 1) * 4 + 64 <= 48 * 1024
    # The tile is a power of two (the search steps by halves) and a whole
    # number of warps, split evenly among a row's counting threads, and
    # merge_tiles' block is at most 1024 threads.
    assert T & (T - 1) == 0 and T % 32 == 0
    assert (T // parts) % 4 == 0 and parts * T <= 1024
    assert int(got["kMaxGroups"]) >= 1
