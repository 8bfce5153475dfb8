"""The per-layer readers on a stub run, the profile digest on a stub
profile, and the frozen bound arithmetic against chip_smoke.py's on the
same shapes."""

import types

import pytest
import torch

from portbench import profile as pp
from portbench.harness import Cell
from portbench.tests.tiny import REPO
from portbench.yardstick import bounds as yb

A = 20


def stub_run(profile=True):
    prof = dict(device_s={"detect": 0.002, "explore": 0.004, "other": 0.0},
                busy_s=0.006, window_s=2.0, activities=500,
                device_ops=[["k", 0.006]], idle_gaps=[["aggregate", 0.1]])
    return types.SimpleNamespace(
        reads=200_000, passes=2, window_s=2.5,
        stage_s={"device_dispatch": 0.8, "aggregate": 0.3,
                 "slowpath_rescue": 0.4, "explore_dispatch": 0.1,
                 "pass.rows": 1.0, "pass.write": 0.2},
        stage_n={"device_dispatch": 48},
        profile=prof if profile else None,
        bounds=dict(detect_s=0.0002, explore_s=0.0001, detect_batches=48,
                    explore_chunks=48))


EXPECT = {
    "stream.dispatch_us_per_read": 4.0,
    "stream.aggregate_us_per_read": 1.5,
    "rescue.wait_us_per_read": 2.0,
    "table.rows_us_per_read": 5.0,
    "table.write_us_per_read": 1.0,
    "explore.dispatch_us_per_read": 0.5,
    "detect.device_us_per_batch": 2000.0 / 48,
    "detect_roofline": 10.0,
    "explore_roofline": 2.5,
    "device.idle_pct": 99.7,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_on_a_stub_run(name):
    read = Cell(REPO, "rnase_r_16mb.enriched").reader(name)
    assert read(stub_run()) == pytest.approx(EXPECT[name])
    if name in ("detect.device_us_per_batch", "detect_roofline",
                "explore_roofline", "device.idle_pct"):
        assert read(stub_run(profile=False)) is None


def test_stage_reader_reads_zero_for_a_stage_that_never_ran():
    read = Cell(REPO, "rnase_r_16mb.enriched").reader(
        "rescue.wait_us_per_read")
    run = stub_run()
    run.stage_s = {}
    assert read(run) == 0.0


def _ev(name, dev, t0, t1, eid):
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, device_type=cuda if dev else cpu, id=eid,
        time_range=types.SimpleNamespace(start=t0, end=t1),
        is_user_annotation=False)


def test_digest_on_a_stub_profile():
    events = [
        _ev("stage.device_dispatch", False, 0, 100, 1),
        _ev("k1_exact", False, 10, 20, 2),
        _ev("cudaLaunchKernel", False, 12, 13, 3),
        _ev("detect_core", False, 30, 40, 4),
        _ev("cudaLaunchKernel", False, 32, 33, 5),
        _ev("stage.explore_dispatch", False, 200, 300, 6),
        _ev("explore_pairs", False, 210, 220, 7),
        _ev("cudaLaunchKernel", False, 212, 213, 8),
        _ev("stage.aggregate", False, 400, 900, 9),
        _ev("exact_kernel", True, 50, 60, 3),
        _ev("core_kernel", True, 60, 75, 5),
        _ev("explore_kernel", True, 250, 290, 8),
        _ev("Memcpy DtoH", True, 1000, 1002, 99),
        _ev("k1_exact", True, 50, 60, 2),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    d = pp.digest(prof, 0.002)
    assert d["activities"] == 4
    assert d["device_s"] == pytest.approx(
        {"detect": 25e-6, "explore": 40e-6, "other": 2e-6})
    assert d["busy_s"] == pytest.approx(67e-6)
    assert d["idle_gaps"][0] == ["aggregate", pytest.approx(710e-6)]
    assert d["idle_gaps"][1] == ["untimed", pytest.approx(175e-6)]
    assert d["device_ops"][0] == ["explore_kernel", pytest.approx(40e-6)]


@pytest.fixture(scope="module")
def cs():
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("prefilter", [True, False])
def test_detect_bounds_equal_chip_smokes(cs, prefilter):
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.ops.anchor_align import AnchorHits
    cfg = Config()
    B, Lp, n = 64, cfg.max_read_len, 128
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(0, Lp + 1, (B,), generator=g, dtype=torch.int32)
    lens[:5] = 0
    hits = AnchorHits(torch.zeros(B, dtype=torch.bool),
                      *(torch.zeros(B, dtype=d) for d in (
                          torch.int64, torch.int32, torch.int32,
                          torch.int32, torch.int32, torch.int32)))
    table = torch.zeros(1000, 8, dtype=torch.int32)
    exact_args = (table, table, torch.zeros(3, dtype=torch.int32),
                  torch.zeros(n, A, dtype=torch.uint8))
    offsets = torch.zeros(3, dtype=torch.int64)
    core_args = (None, 0, offsets, torch.zeros(B, Lp, dtype=torch.uint8),
                 lens, None, hits, hits, None)
    want = cs.detect_bounds(exact_args, core_args, cfg, prefilter)
    got_e, got_c = yb.probe(n, A), yb.core(lens.numpy(), 3, A, prefilter)
    for got, key in ((got_e, "exact"), (got_c, "core")):
        assert (got["bytes"], got["ops"]) == (want[key]["bytes"],
                                              want[key]["ops"])
        assert got["bound_ms"] == pytest.approx(want[key]["bound_ms"])


@pytest.mark.parametrize("slots", [False, True])
def test_classic_bound_equals_chip_smokes(cs, slots):
    from find_circ2_tpu_torch.config import Config
    cfg = Config()
    table = torch.zeros(1000, 8, dtype=torch.int32)
    assert yb.classic(300, A, slots) == cs.classic_bound(table, 300, cfg,
                                                         slots)


def test_explore_bounds_equal_chip_smokes(cs):
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.utils.explore_cases import (explore_case,
                                                          pair_args)
    cfg = Config()
    args = pair_args(explore_case(5, 64, cfg), cfg)
    want = cs.explore_bound(args, cfg)
    want.pop("long_lists")
    assert yb.explore_pairs(args, A, cfg.max_pair_hits) == want
    stats = tuple(torch.cat([x, y]) for x, y in zip(args[5], args[6]))
    table = torch.zeros(1000, 8, dtype=torch.int32)
    n = 2 * args[3].shape[0]
    assert yb.classic(n, A, stats=stats) == cs.classic_bound(
        table, n, cfg, stats=stats)
