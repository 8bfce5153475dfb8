"""The plain reference of a pass, and its comparison with the program's.

`reference` works a library out from the genome arrays and the FASTQ
files the harness gave the program, in three parts (a paired-end
configuration's mate 2, every odd-indexed file, is reverse-complemented
first, as `find_circ --pe` does, SPEC.md §7, so every part, `n_uniq`'s
deduplication too, sees the processed reads):

- its own seed index (`seedindex.build_index`) and every read called by
  a frozen copy of the port's vectorised host caller
  (`multihit.call_reads_multi_batch`: the ≤1-mm anchor ball, the 2-mm
  rescue, §2b pair exploration over K candidates, the prefilter), spread
  over forked worker processes, then aggregated call by call, named,
  filtered and written as `find_circ` writes them: the bytes a pass must
  equal;
- a sample of the reads, drawn from the seed with the 2-mm rescue's and
  §2b's reads first, called again by the per-read oracle
  (`oracle.call_read`, per-candidate loops, apart from the vectorised
  caller) and held call for call to the vectorised caller's calls;
- a plain recount of the table and stats from the calls
  (`recount.py`), apart from the frozen aggregator and writer.

`differences` counts how far a pass's BED and stats lie from the first
and the last.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import os
import types

import numpy as np

from portbench.reference import recount
from portbench.reference.aggregate import Aggregator
from portbench.reference.bed import passes_filter, write_bed
from portbench.reference.config import Config
from portbench.reference.genome import Genome
from portbench.reference.multihit import (anchor_candidates_batch,
                                          call_reads_multi_batch)
from portbench.reference.oracle import call_read
from portbench.reference.seedindex import build_index
from portbench.reference.twobit import revcomp_seq, seq_to_codes

# Reads of a run held to the per-read oracle (about 41 reads/s a core;
# a 2-mm rescue's read costs several times that), and the reads drawn
# from the seed to find the rescue's and §2b's reads among.
ORACLE_SAMPLE = 384
ORACLE_POOL = 16 * ORACLE_SAMPLE

_STATE = None


def _call_chunk(items):
    genome, index, cfg, prefilter = _STATE
    return call_reads_multi_batch(genome, index, items, cfg, prefilter)


def _oracle_chunk(items):
    genome, index, cfg, prefilter = _STATE
    return [call_read(genome, index, name, seq, cfg, prefilter)
            for name, seq in items]


def _in_workers(fn, chunks, workers: int) -> list:
    if workers == 1:
        return [fn(c) for c in chunks]
    pool = mp.get_context("fork").Pool(workers)
    try:
        return pool.map(fn, chunks)
    finally:
        pool.close()
        pool.join()


def _chunks(items, workers: int) -> list:
    step = max(1, -(-len(items) // (4 * workers)))
    return [items[i:i + step] for i in range(0, len(items), step)]


def oracle_sample(genome, index, items, cfg, seed: int) -> list[int]:
    """Indices of ORACLE_SAMPLE reads drawn from `seed`: of ORACLE_POOL
    reads drawn first, those whose ≤1-mm anchor search leaves exactly one
    anchor unaligned (the 2-mm rescue's) up to a third, then those with
    an anchor of several best hits (§2b's) up to a third, then the rest
    in the drawn order."""
    rng = np.random.default_rng([seed, 0x0AC1E])
    pool = rng.permutation(len(items))[:ORACLE_POOL]
    a = cfg.anchor_len
    ok = [i for i in pool if 2 * a <= len(items[i][1]) <= cfg.max_read_len]
    if not ok:
        return [int(i) for i in pool[:ORACLE_SAMPLE]]
    codes = [seq_to_codes(items[i][1]) for i in ok]
    q = np.stack([c[:a] for c in codes] + [c[-a:] for c in codes])
    hits, _ = anchor_candidates_batch(genome, index, q, cfg)
    n = len(ok)
    rescue = [i for m, i in enumerate(ok)
              if hits[m].aligned != hits[n + m].aligned]
    multi = [i for m, i in enumerate(ok)
             if hits[m].n_best > 1 or hits[n + m].n_best > 1]
    picked: list[int] = []
    for group, cap in ((rescue, ORACLE_SAMPLE // 3),
                       (multi, 2 * ORACLE_SAMPLE // 3),
                       (list(pool), ORACLE_SAMPLE)):
        for i in group:
            if len(picked) >= cap:
                break
            if i not in picked:
                picked.append(int(i))
    return picked


def read_fastq(path) -> list[tuple[str, str]]:
    """(name, sequence) of every record of a plain four-line FASTQ."""
    with open(path, "rt", encoding="ascii") as fh:
        lines = fh.read().split("\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 3, 4)]


def reference_config(fc: dict) -> Config:
    """The reference's Config for a configuration's `find_circ` settings,
    as the command line makes it."""
    a = int(fc["anchor_len"])
    return Config(anchor_len=a, prefix_len=min(12, a - 8),
                  stranded=bool(fc["stranded"]),
                  batch_size=int(fc["batch_size"]))


def processed_reads(fastq_paths, pe: bool) -> list[tuple[str, str]]:
    """(name, sequence) of every record of the files in turn, each read
    of an odd-indexed file reverse-complemented where `pe`."""
    items = []
    for fi, path in enumerate(fastq_paths):
        recs = read_fastq(path)
        if pe and fi % 2:
            recs = [(name, revcomp_seq(seq)) for name, seq in recs]
        items += recs
    return items


def reference(genome_arrays: dict, fastq_paths, fc: dict, seed: int,
              workers: int | None = None):
    """The plain reference of the library in the files `fastq_paths`
    under the configuration's `find_circ` settings `fc`: its BED and
    stats text (`bed`, `stats`), the plain recount's rows and counts
    (`rows`, `counts`), and how many of the `oracle_sampled` reads the
    per-read oracle calls otherwise than the vectorised caller
    (`oracle_calls_differing`)."""
    global _STATE
    cfg = reference_config(fc)
    genome = Genome(codes=np.asarray(genome_arrays["codes"]),
                    chrom_names=list(genome_arrays["chrom_names"]),
                    chrom_offsets=np.asarray(genome_arrays["chrom_offsets"]),
                    chrom_lengths=np.asarray(genome_arrays["chrom_lengths"]))
    index = build_index(genome, cfg)
    items = processed_reads(fastq_paths, bool(fc.get("pe", False)))
    workers = max(1, min(workers or os.cpu_count() or 1, 8))
    sample = oracle_sample(genome, index, items, cfg, seed)
    _STATE = (genome, index, cfg, bool(fc["prefilter"]))
    try:
        calls = [c for part in _in_workers(_call_chunk,
                                           _chunks(items, workers), workers)
                 for c in part]
        oracle = [c for part in _in_workers(
            _oracle_chunk, _chunks([items[i] for i in sample], workers),
            workers) for c in part]
    finally:
        _STATE = None
    agg = Aggregator(genome, cfg)
    for call in calls:
        agg.add(call)
    rows = agg.rows(sample_name=fc["name"], prefix=fc["prefix"])
    if fc["filter"]:
        rows = [r for r in rows
                if passes_filter(r, fc["max_span"], fc["min_support"],
                                 fc["max_edits"])]
    buf = io.StringIO()
    write_bed(buf, rows)
    table, counts = recount.recount(calls, genome.chrom_names,
                                    genome.chrom_offsets, cfg, fc)
    return types.SimpleNamespace(
        bed=buf.getvalue(), stats="\n".join(agg.stats.lines()) + "\n",
        rows=table, counts=counts, oracle_sampled=len(sample),
        oracle_calls_differing=sum(o != calls[i]
                                   for o, i in zip(oracle, sample)))


def _unnamed(bed: str) -> list[str]:
    """BED rows without their name column (a missing or extra row renames
    every row after it) and without the header."""
    out = []
    for line in bed.splitlines():
        if line and not line.startswith("#"):
            f = line.split("\t")
            out.append("\t".join(f[:3] + f[4:]))
    return out


def _sym_diff(a: list[str], b: list[str]) -> int:
    from collections import Counter
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def differences(bed: str, stats: str, ref) -> dict:
    """How far a pass's outputs lie from the reference `ref`'s: BED rows
    in one and not the other (name column aside), stats lines likewise,
    whether the bytes differ at all, and the same against the plain
    recount (`recount.differences`)."""
    return dict(
        bed_rows_differing=_sym_diff(_unnamed(bed), _unnamed(ref.bed)),
        stats_lines_differing=_sym_diff(stats.splitlines(),
                                        ref.stats.splitlines()),
        **recount.differences(bed, stats, ref.rows, ref.counts),
        bytes_differ=int(bed != ref.bed or stats != ref.stats))
