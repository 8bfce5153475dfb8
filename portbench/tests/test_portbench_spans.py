"""The readers of the program's own spans and counters on stub runs:
each number from its key, 0 where the span's parent never ran, and
nothing from a program that times no such span (the parent of the
commit that added them); and the loop's routed-read counter against the
harness's wrapper around the routing call, on a pass of the program."""

import pytest

from portbench import harness
from portbench.harness import Cell
from portbench.tests import tiny
from portbench.tests.test_portbench_metrics import stub_run
from portbench.tests.test_portbench_pass import _captured
from portbench.tests.tiny import REPO

SPANS = {
    "device_dispatch/upload": 0.1,
    "device_dispatch/launch": 0.2, "device_dispatch/readback": 0.06,
    "pass.rows/drain": 0.3, "pass.rows/build": 0.5,
    "pass.rows/renumber": 0.1, "stream_start": 0.12, "stream_stop": 0.08}
COUNTERS = {"explore_dispatch/reads": 38_000,
            "slowpath_rescue/worker_us": 500_000}
# (value on the stub run of 200,000 reads, the root stage whose absence
# reads 0; None where the metric reads nothing without its own keys).
EXPECT = {
    "dispatch.upload_us_per_read": (0.5, "device_dispatch"),
    "dispatch.launch_us_per_read": (1.0, "device_dispatch"),
    "dispatch.readback_us_per_read": (0.3, "device_dispatch"),
    "table.drain_us_per_read": (1.5, "pass.rows"),
    "table.build_us_per_read": (2.5, "pass.rows"),
    "table.renumber_us_per_read": (0.5, "pass.rows"),
    "stream.start_stop_us_per_read": (1.0, None),
    "explore.routed_reads_pct": (19.0, "explore_dispatch"),
    "rescue.worker_us_per_read": (2.5, "slowpath_rescue"),
}


def plain_run():
    """A run of a program that times its stages and none of the spans."""
    run = stub_run()
    run.stage_n = {k: 1 for k in run.stage_s}
    return run


def traced_run():
    run = plain_run()
    run.stage_s.update(SPANS)
    run.stage_n.update({k: 1 for k in SPANS}, **COUNTERS)
    return run


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader_on_a_stub_run(name):
    read = Cell(REPO, "rnase_r_16mb.enriched").reader(name)
    want, root = EXPECT[name]
    assert read(traced_run()) == pytest.approx(want)
    assert read(plain_run()) is None
    if root is not None:
        run = traced_run()
        for d in (run.stage_s, run.stage_n):
            for k in [k for k in d if k == root or k.startswith(root + "/")]:
                del d[k]
        assert read(run) == 0.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("spans")))


def test_routed_reads_counter_equals_the_wrappers_count(tree):
    """The loop's counter `explore_dispatch/reads`, which
    `explore.routed_reads_pct` reads, and the harness's wrapper around
    DeviceExplorer.dispatch_arrays count the same reads in one pass; the
    traced run's check holds them equal and fails a wrapper that missed
    a read."""
    _, counts, stage_n = _captured(tree)
    assert counts["routed"] == stage_n["explore_dispatch/reads"] > 0
    harness.check_routed(counts, stage_n)
    with pytest.raises(SystemExit, match="routing wrapper"):
        harness.check_routed({**counts, "routed": counts["routed"] - 1},
                             stage_n)
