"""tests/launcher.py: `run_all` kills every process group it started,
forked children included, at the first failure or at its deadline, and
the processes it starts import the tree under test."""

import os
import sys
import time

import pytest

import launcher
from launcher import ROOT, run_all

SLEEPER = """import os, sys, time
if os.fork() == 0:
    with open(sys.argv[1], "w") as fh:
        fh.write(str(os.getpgid(0)))
time.sleep(600)
"""
FAILER = """import os, sys, time
while not os.path.exists(sys.argv[1]):
    time.sleep(0.01)
print(os.getpgid(0), flush=True)
sys.exit(1)
"""


@pytest.mark.parametrize("first", ["fails", "sleeps"])
def test_run_all_kills_every_process_group(tmp_path, monkeypatch, first):
    """One command sleeps far past the deadline and forks a child that
    sleeps too; the other exits 1 once that child is up (or, with
    "sleeps", does the same as the first). run_all returns long before
    the sleeps end, at the failure (or at its 2 s deadline), and no
    process of either group is left."""
    forked = [tmp_path / "forked0", tmp_path / "forked1"]
    cmds = [[sys.executable, "-c", SLEEPER, str(forked[0])],
            [sys.executable, "-c", FAILER, str(forked[0])]
            if first == "fails" else
            [sys.executable, "-c", SLEEPER, str(forked[1])]]
    if first == "sleeps":
        monkeypatch.setattr(launcher, "DEADLINE_S", 2)
    t0 = time.monotonic()
    rcs, tails = run_all(cmds, tmp_path / "logs")
    assert time.monotonic() - t0 < 60
    if first == "fails":
        assert rcs == [-9, 1]
        pgids = [int(forked[0].read_text()), int(tails[1].split()[0])]
    else:
        assert rcs == [-9, -9]
        assert all("killed at the 2 s deadline" in t for t in tails)
        pgids = [int(f.read_text()) for f in forked]
    for pgid in pgids:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                os.killpg(pgid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.05)
        with pytest.raises(ProcessLookupError):
            os.killpg(pgid, 0)


def test_run_all_imports_the_tree_under_test(tmp_path, monkeypatch):
    """A process started by run_all, from outside the tree, finds the
    port's package in the tree these tests belong to, not in another
    copy."""
    monkeypatch.chdir(tmp_path)
    rcs, tails = run_all([[sys.executable, "-c",
                           "import importlib.util as u; print(u.find_spec("
                           "'find_circ2_tpu_torch').origin)"]],
                         tmp_path / "logs")
    assert rcs == [0], tails[0]
    assert tails[0].strip().startswith(os.path.join(ROOT, ""))
