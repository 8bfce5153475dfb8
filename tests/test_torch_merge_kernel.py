"""K-h, the junction merge (find_circ2_tpu_torch/ops/merge.py), on the
edge cases of utils/merge_cases: the plain version (what CPU tensors
take) of merge_junctions and merge_tables against the JAX package on all
N output rows, fill rows included; the wrappers' routing (a tensor off
the CPU reaches the stubbed C call of csrc/merge.cu, with the scratch of
the multi-block sort above ONE_BLOCK_ROWS rows); and the kernel's
argument layout and constants. The kernel itself is held against the
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

    def fc2t_merge(self, buf):
        self.seen.append((_Device.current[0], _build.MERGE_ARGS.unpack(buf)))
        return 1


def _stub_cuda(monkeypatch):
    lib = _Lib()
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


@pytest.mark.parametrize("n", [64, tm.ONE_BLOCK_ROWS, tm.ONE_BLOCK_ROWS + 1])
def test_cuda_tensors_reach_the_c_call(n, monkeypatch):
    """A tensor off the CPU takes the kernel: merge_junctions and
    merge_tables each make one C call with the columns' device current,
    the result's or the table's pointers where MergeArgs wants them, the
    outputs of the plain version's dtypes, the sort's scratch only above
    ONE_BLOCK_ROWS rows, and a launch counted."""
    lib = _stub_cuda(monkeypatch)
    res, lens = merge_case("random", n, 3)
    res = _port(res)
    lens = torch.from_numpy(lens)
    before = tm.launches
    out = tm.merge_junctions(res, lens, CFG)
    assert {k: v.dtype for k, v in out.items()} == tm.TABLE_DTYPES
    assert all(v.shape == (n,) for v in out.values())
    table = tm.merge_tables({k: torch.stack([v, v]) for k, v in out.items()})
    assert table["valid"].shape == (2 * n,)
    assert tm.launches == before + 2
    (d1, a1), (d2, a2) = lib.seen
    assert d1 == d2 == 2 and _Device.current == [0]
    # MergeArgs: 18 row pointers, 14 outputs, 3 scratch, stream; n;
    # st_junction, min_uniq_qual, device, reserved.
    assert a1[0] == 0 and a1[1] == res["kind"].data_ptr()
    assert a1[6:9] == (0, 0, 0)
    assert a1[9] == res["qual_left"].data_ptr()
    assert a1[14:18] == (res["status"].data_ptr(), lens.data_ptr(),
                         res["multi"].data_ptr(),
                         res["align_strand"].data_ptr())
    assert a1[18] == out["valid"].data_ptr()
    assert a1[31] == out["n_bp"].data_ptr()
    assert a1[36:] == (n, 0, CFG.min_uniq_qual, 2, 0)
    assert a2[0] != 0 and a2[14:18] == (0, 0, 0, 0)
    assert a2[36:] == (2 * n, 0, 0, 2, 0)
    assert all(a1[32:35]) == (n > tm.ONE_BLOCK_ROWS)
    assert all(a2[32:35]) == (2 * n > tm.ONE_BLOCK_ROWS)
    # Without "multi" its pointer is null.
    del res["multi"]
    tm.merge_junctions(res, lens, CFG)
    assert lib.seen[-1][1][16] == 0


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
    """csrc/merge.cu's one-block limit, identities and argument layout
    equal ops/merge.py's and _build's."""
    src = open(os.path.join(CSRC, "merge.cu")).read()
    got = {k: v for k, v in re.findall(
        r"\b(k[A-Z]\w*) = ([^;]+);", src)}
    assert int(got["kOneBlock"]) == tm.ONE_BLOCK_ROWS
    assert got["kDeadHi"] == "1 << 24" and got["kBigDef"] == "1 << 30"
    assert tm.BIGDEF == 1 << 30
    assert "sizeof(MergeArgs) == %d" % _build.MERGE_ARGS.size in src
    assert _build.MERGE_ARGS.size == 36 * 8 + 8 + 4 * 4
    # 20 bytes a row of keys: kOneBlock rows fit the 227 KB of a block.
    assert tm.ONE_BLOCK_ROWS * 20 + 4096 <= 232448
