"""The stranded paired 2x150 cell `rnase_r_16mb_pe.enriched_dutp150`: its
configuration is `rnase_r_16mb`'s run as `find_circ --pe --stranded`, its
traffic draws two files of dUTP mates, and the two metrics it brings
(`encode.revcomp_us_per_read`, `rescue.routed_reads_pct`) read a number
in single-end and paired cells alike, and nothing where the program keeps
no such span or counter."""

import json
import os
import time
import types

import numpy as np
import pytest

from portbench import genome as pg
from portbench import harness, library
from portbench.tests import tiny

A = 20
CONFIG = "rnase_r_16mb_pe"
TRAFFIC = "enriched_dutp150"
CELL = f"{CONFIG}.{TRAFFIC}"


def _bench() -> dict:
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _config(name: str) -> tuple[list[str], dict]:
    with open(os.path.join(tiny.REPO, "portbench", "configs",
                           f"{name}.json")) as fh:
        text = fh.read()
    return text.splitlines(), json.loads(text)


def test_paired_config_is_cell_1s_run_as_find_circ_pe_stranded():
    """rnase_r_16mb_pe: rnase_r_16mb's genome and loci lines byte for byte
    (the same chromosome and loci), its cut, and its find_circ settings
    with `pe` and `stranded` on."""
    (se_lines, se), (pe_lines, pe) = (_config("rnase_r_16mb"),
                                      _config(CONFIG))
    for k in ("genome", "loci"):
        line = next(ln for ln in se_lines if ln.startswith(f'  "{k}": '))
        assert line in pe_lines, k
    for k in ("genome_bp", "published", "reduced_why"):
        assert pe[k] == se[k], k
    fs, fp = se["find_circ"], pe["find_circ"]
    assert {k for k in fs.keys() | fp.keys()
            if fs.get(k) != fp.get(k)} == {"pe", "stranded"}
    assert fp["pe"] is True and fp["stranded"] is True
    confs = {c["name"]: c for c in _bench()["configs"]}
    assert confs[CONFIG]["reduced"] == confs["rnase_r_16mb"]["reduced"]


def test_paired_cell_is_one_chip_over_its_files():
    cells = {w["name"]: w for w in _bench()["workloads"]}
    assert cells[CELL] | {"why": ""} == dict(
        name=CELL, config=CONFIG, traffic=TRAFFIC, chips=1, why="")
    cell = harness.Cell(tiny.REPO, CELL)
    one = harness.Cell(tiny.REPO, "rnase_r_16mb.enriched")
    assert cell.params["control"] == one.params["control"]


def test_paired_traffic_holds_the_deployments_parameters():
    with open(os.path.join(tiny.REPO, "portbench", "traffic",
                           f"{TRAFFIC}.json")) as fh:
        t = json.load(fh)
    assert t == dict(junctions="loci", loci="all", circ_draws=6000,
                     linear_draws=800, circ_depth_mean=12.0,
                     linear_depth_mean=6.0, mates=2, read_len=150,
                     insert_mean=300, insert_sd=60, errors_per_read=0.45,
                     revcomp_frac=1.0, contiguous_frac=0.10,
                     noise_frac=0.02)


def test_paired_traffic_draws_two_files_of_dutp_mates():
    """enriched_dutp150 over the tiny genome: two files of 150 bp mates,
    `r<i>/1` and `r<i>/2` pair for pair, every fragment read from its
    other strand (dUTP: mate 1 antisense)."""
    g = pg.make_genome(tiny.tiny_conf(n_circ=150, n_linear=30))
    t = tiny.tiny_traffic(TRAFFIC)
    seed = 2 ** 31 + 24
    files = library.make_library(g, t, seed, A)
    assert len(files) == 2 and files[0].shape == files[1].shape
    assert files[0].shape[1] == 150 and files[0].max() < 4
    m1, m2, info = library.make_pairs(g, t, seed, A)
    np.testing.assert_array_equal(files[0], m1)
    np.testing.assert_array_equal(files[1], m2)
    assert info["flip"].all()
    fq = library.fastq_files(files)
    n = files[0].shape[0]
    assert [f.count(b"\n") for f in fq] == [4 * n, 4 * n]
    assert fq[0].startswith(b"@r0/1\n") and b"\n@r%d/1\n" % (n - 1) in fq[0]
    assert fq[1].startswith(b"@r0/2\n") and b"\n@r%d/2\n" % (n - 1) in fq[1]


def _run(stage_s=None, stage_n=None, passes=2):
    return types.SimpleNamespace(reads=200_000, passes=passes,
                                 window_s=2.5, stage_s=stage_s or {},
                                 stage_n=stage_n or {})


def _reader(name):
    return harness.Cell(tiny.REPO, CELL).reader(name)


@pytest.mark.parametrize("stage_s,stream_starts,want", [
    ({"encode": 1.2, "encode/revcomp": 0.9}, 4, 4.5),
    ({"encode": 1.2}, 4, None),     # paired, a program without the span
    ({"encode": 1.2}, 2, 0.0),      # single-end: one file a pass
    ({}, 0, 0.0),                   # no loop ran
], ids=["paired", "paired_without_span", "single_end", "no_pass"])
def test_revcomp_reader(stage_s, stream_starts, want):
    run = _run(stage_s, {"stream_start": stream_starts})
    got = _reader("encode.revcomp_us_per_read")(run)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("stage_n,want", [
    ({"slowpath_rescue": 20, "aggregate/rescue_reads": 12_000}, 6.0),
    ({"slowpath_rescue": 20}, None),    # a program without the counter
    ({"aggregate/rescue_reads": 0}, 0.0),
    ({}, 0.0),                          # the rescue never ran
], ids=["value", "without_counter", "counted_none", "never_ran"])
def test_rescue_routed_reader(stage_n, want):
    got = _reader("rescue.routed_reads_pct")(_run(stage_n=stage_n))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("cell", [tiny.CELL, tiny.PE_CELL])
def test_traced_run_reports_both_metrics(tmp_path, monkeypatch, cell):
    """A traced run of a single-end and of a paired tiny cell reports both
    new metrics: mate 2's reverse complement 0 where one file is read and
    above 0 where mate 2 is flipped, and the rescue's share as the loop
    counted it."""
    root = tiny.make_tree(str(tmp_path))
    prof = dict(device_s={"detect": 1e-3, "explore": 1e-3, "other": 0.0},
                busy_s=1e-3, window_s=1.0, activities=3,
                device_ops=[["k", 1e-3]], idle_gaps=[["aggregate", 0.5]])
    tallies = dict(detect_s=1e-5, explore_s=1e-5, detect_batches=2,
                   slices=2, explore_chunks=2)
    monkeypatch.setattr(harness, "take_profile",
                        lambda program, n, cfg, keep: (prof, tallies))
    r = harness.run_cell(root, cell, 2 ** 31 + 24, 0.3, True,
                         time.perf_counter(), device="cpu")
    assert r["correct"] is True
    revcomp = r["metrics"]["encode.revcomp_us_per_read"]["value"]
    assert (revcomp > 0) is (cell == tiny.PE_CELL)
    assert 0 <= r["metrics"]["rescue.routed_reads_pct"]["value"] < 100
