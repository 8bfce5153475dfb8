"""The tiny cell on the card, traced: run on the chip with
`python -m pytest -q -m cuda portbench/tests/test_portbench_card.py`;
skips without a card."""

import time

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.cuda
def test_tiny_cell_traced_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    root = tiny.make_tree(str(tmp_path))
    r = harness.run_cell(root, tiny.CELL, 2 ** 31 + 5, 1.0, True,
                         time.perf_counter())
    assert r["correct"] is True
    cell = harness.Cell(root, tiny.CELL)
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
    for name in ("detect_roofline", "explore_roofline"):
        assert 0 < r["metrics"][name]["value"] <= 105
    dev = r["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
