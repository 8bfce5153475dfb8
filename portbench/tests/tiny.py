"""A tiny benchmark tree for the tests: a BENCHMARK.json of its own with
one small configuration, one traffic file, one cell and the repository's
per-layer readers, written as new files under a temporary directory, so
that the harness finds them by name exactly as it finds the real ones."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tiny.enriched"


def tiny_conf(genome_bp: int = 300_000, n_circ: int = 120,
              n_linear: int = 20) -> dict:
    with open(os.path.join(REPO, "portbench", "configs",
                           "rnase_r_16mb.json")) as fh:
        conf = json.load(fh)
    conf.update(name="tiny", genome_bp=genome_bp)
    conf["genome"]["chromosomes"] = [["chrT", genome_bp]]
    conf["loci"].update(n_circular=n_circ, n_linear=n_linear)
    return conf


def tiny_traffic(kind: str = "enriched", circ: int = 120,
                 linear: int = 20) -> dict:
    with open(os.path.join(REPO, "portbench", "traffic",
                           f"{kind}.json")) as fh:
        traffic = json.load(fh)
    traffic.update(circ_draws=circ, linear_draws=linear)
    return traffic


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def make_tree(root: str, traffic: str = "enriched") -> str:
    """The tree under `root`: returns root."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    pb = os.path.join(root, "portbench")
    write(os.path.join(pb, "configs", "tiny.json"), tiny_conf())
    write(os.path.join(pb, "traffic", "tiny_traffic.json"),
          tiny_traffic(traffic))
    write(os.path.join(pb, "workloads", f"{CELL}.json"),
          {"config": "tiny", "traffic": "tiny_traffic",
           "control": {"prefilter": False}})
    shutil.copytree(os.path.join(REPO, "portbench", "metrics"),
                    os.path.join(pb, "metrics"), dirs_exist_ok=True)
    bench["configs"] = [dict(name="tiny", source="tests", reduced=[],
                             file="portbench/configs/tiny.json", why="t")]
    bench["workloads"] = [dict(name=CELL, config="tiny",
                               traffic="tiny_traffic", chips=1, why="t")]
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root
