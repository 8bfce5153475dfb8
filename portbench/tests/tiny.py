"""A tiny benchmark tree for the tests: a BENCHMARK.json of its own with
two small configurations (single-end, and paired-end and stranded), one
traffic file for each, one cell each and the repository's per-layer
readers, written as new files under a temporary directory, so that the
harness finds them by name exactly as it finds the real ones."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tiny.enriched"
PE_CELL = "tiny_pe.dutp150"


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


def pe_conf() -> dict:
    """The tiny configuration run as `find_circ --pe --stranded`."""
    conf = tiny_conf()
    conf["name"] = "tiny_pe"
    conf["find_circ"].update(pe=True, stranded=True)
    return conf


def pe_traffic() -> dict:
    """2 x 150 bp mates of 300 +- 60 bp fragments, dUTP orientation."""
    return dict(tiny_traffic(), mates=2, read_len=150, insert_mean=300,
                insert_sd=60, revcomp_frac=1.0)


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
    write(os.path.join(pb, "configs", "tiny_pe.json"), pe_conf())
    write(os.path.join(pb, "traffic", "tiny_dutp150.json"), pe_traffic())
    write(os.path.join(pb, "workloads", f"{PE_CELL}.json"),
          {"config": "tiny_pe", "traffic": "tiny_dutp150",
           "control": {"prefilter": False}})
    shutil.copytree(os.path.join(REPO, "portbench", "metrics"),
                    os.path.join(pb, "metrics"), dirs_exist_ok=True)
    bench["configs"] = [dict(name=n, source="tests", reduced=[],
                             file=f"portbench/configs/{n}.json", why="t")
                        for n in ("tiny", "tiny_pe")]
    bench["workloads"] = [dict(name=CELL, config="tiny",
                               traffic="tiny_traffic", chips=1, why="t"),
                          dict(name=PE_CELL, config="tiny_pe",
                               traffic="tiny_dutp150", chips=1, why="t")]
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root
