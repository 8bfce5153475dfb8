"""BENCHMARK.json and the files it names: every configuration, cell,
traffic mix and per-layer metric is a file of its own, loads, and names
only what the benchmark's format accepts."""

import json
import os
import re

import pytest

from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s",
                                                    "reads_per_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_has_its_file(kind):
    b = bench()
    for entry in b[kind]:
        if kind == "configs":
            path = os.path.join(REPO, entry["file"])
        else:
            path = os.path.join(REPO, "portbench", "workloads",
                                f"{entry['name']}.json")
            traffic = os.path.join(REPO, "portbench", "traffic",
                                   f"{entry['traffic']}.json")
            with open(traffic) as fh:
                json.load(fh)
        with open(path) as fh:
            data = json.load(fh)
        if kind == "configs":
            assert data["name"] == entry["name"]
            for k in entry["reduced"]:
                assert k in data
        else:
            assert (data["config"], data["traffic"]) == (entry["config"],
                                                         entry["traffic"])


def test_every_per_layer_metric_has_a_reader():
    from portbench.harness import Cell
    b = bench()
    for w in b["workloads"]:
        cell = Cell(REPO, w["name"])
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))


def test_file_names_use_name_characters():
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, "portbench")):
        dirnames[:] = [d for d in dirnames
                       if d not in (".cache", "__pycache__")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
