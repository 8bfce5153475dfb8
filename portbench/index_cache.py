"""The host arrays of a configuration's index, cached in a fixed directory
of the checkout (`portbench/.cache/<config>/`).

The key is a hash of the configuration file's bytes, the port's table
format (`index/hashtable.TABLE_FORMAT`) and this module's LAYOUT. A
directory whose `key.json` holds another key, or none, is deleted and
built again with the port's own index functions (`index/build.build_index`,
`index/hashtable.build_query_table`, `build_neighbor_table`); one whose
key matches is loaded and never written. The arrays: the genome (its
codes and chromosome layout), its junction loci, the SeedIndex, and the
query table with its §2b extras and neighbour table.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

LAYOUT = 1
_GENOME = ("codes", "chrom_offsets", "chrom_lengths")
_INDEX = ("positions", "suffix_vals", "offsets")
_TABLE = ("table", "meta", "ext", "ext_id", "ntable")


def cache_key(conf_bytes: bytes) -> str:
    from find_circ2_tpu_torch.index.hashtable import TABLE_FORMAT
    h = hashlib.sha256(conf_bytes)
    h.update(f"|table_format={TABLE_FORMAT}|layout={LAYOUT}".encode())
    return h.hexdigest()


def _save(d: str, name: str, a: np.ndarray) -> None:
    np.save(os.path.join(d, f"{name}.npy"), np.ascontiguousarray(a))


def _load(d: str, name: str) -> np.ndarray:
    return np.load(os.path.join(d, f"{name}.npy"))


def load_or_build(cache_root: str, conf: dict, conf_bytes: bytes, cfg,
                  log) -> tuple[dict, object, dict]:
    """(genome arrays as portbench.genome.make_genome gives them, the
    port's SeedIndex with its QueryTable and neighbour table, info): info
    says whether the cache was built, the build's seconds and the cache's
    bytes."""
    from find_circ2_tpu_torch.index.build import SeedIndex, build_index
    from find_circ2_tpu_torch.index.hashtable import (QueryTable,
                                                      build_neighbor_table,
                                                      build_query_table)
    from find_circ2_tpu_torch.io.genome import Genome
    d = os.path.join(cache_root, conf["name"])
    key = cache_key(conf_bytes)
    meta_path = os.path.join(d, "key.json")
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    t0 = time.perf_counter()
    if meta is None or meta.get("key") != key:
        from portbench.genome import make_genome
        if os.path.isdir(d):
            log(f"index cache {d}: key differs, rebuilding")
            shutil.rmtree(d)
        os.makedirs(d)
        g = make_genome(conf)
        genome = Genome(codes=g["codes"], chrom_names=g["chrom_names"],
                        chrom_offsets=g["chrom_offsets"],
                        chrom_lengths=g["chrom_lengths"])
        index = build_index(genome, cfg)
        index.qtable = build_query_table(index, cfg)
        index.qtable.ntable = build_neighbor_table(index, cfg)
        build_s = time.perf_counter() - t0
        for k in _GENOME:
            _save(d, k, g[k])
        for kind, lk in g["loci"].items():
            for f, a in lk.items():
                _save(d, f"loci.{kind}.{f}", a)
        for k in _INDEX:
            _save(d, k, getattr(index, k))
        for k in _TABLE:
            _save(d, f"qtable.{k}", getattr(index.qtable, k))
        meta = dict(key=key, chrom_names=g["chrom_names"],
                    loci=sorted(g["loci"]), anchor_len=index.anchor_len,
                    prefix_len=index.prefix_len,
                    bsearch_iters=index.bsearch_iters, build_s=build_s)
        with open(meta_path + ".part", "w") as fh:
            json.dump(meta, fh)
        os.replace(meta_path + ".part", meta_path)
        built = True
    else:
        g = {k: _load(d, k) for k in _GENOME}
        g["chrom_names"] = meta["chrom_names"]
        g["loci"] = {kind: {f: _load(d, f"loci.{kind}.{f}")
                            for f in ("chrom", "j1", "j2", "clean")}
                     for kind in meta["loci"]}
        index = SeedIndex(anchor_len=meta["anchor_len"],
                          prefix_len=meta["prefix_len"],
                          positions=_load(d, "positions"),
                          suffix_vals=_load(d, "suffix_vals"),
                          offsets=_load(d, "offsets"),
                          bsearch_iters=meta["bsearch_iters"],
                          qtable=QueryTable(**{
                              k: _load(d, f"qtable.{k}") for k in _TABLE}))
        built = False
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    return g, index, dict(built=built, seconds=time.perf_counter() - t0,
                          build_s=meta["build_s"], bytes=nbytes, dir=d)
