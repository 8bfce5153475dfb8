"""A plain recount of the junction table and stats from per-read calls,
written from SPEC.md §5 apart from the frozen aggregator and writer
(`aggregate.py`, `bed.py`): the calls of each junction are grouped in a
list, and every column, the category, `--filter` and every stats count
is worked out from those lists alone. It holds a pass's BED and stats,
the program's final table, filter and writers, to the calls.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from portbench.reference.config import (KIND_CIRCULAR, SENSE_CHARS,
                                        ST_JUNCTION, STATUS_NAMES)


def _category(circular: bool, breakpoints: int, uniq_bridges: int,
              signal: str, strandmatch: str) -> str:
    flags = ["CIRCULAR" if circular else "LINEAR"]
    if breakpoints == 1:
        flags.append("UNAMBIGUOUS_BP")
    flags.append("ANCHOR_UNIQUE" if uniq_bridges else "NO_UNIQ_BRIDGES")
    if signal == "GTAG":
        flags.append("CANONICAL")
    if strandmatch == "MATCH":
        flags.append("STRANDMATCH")
    return ",".join(flags)


def _strandmatch(calls, stranded: bool) -> str:
    if not stranded:
        return "NA"
    match = sum(c.align_strand == c.sense for c in calls)
    return ("MATCH" if match == len(calls) else
            "MISMATCH" if match == 0 else "PARTIAL")


def _passes(n_reads: int, uniq_bridges: int, edits: int, breakpoints: int,
            signal: str, circular: bool, span: int, fc: dict) -> bool:
    """SPEC.md §5's --filter: a circular junction with one breakpoint,
    enough reads, few enough edits and a short enough span, whose anchors
    are unique in some read or whose splice signal is canonical."""
    support = n_reads >= fc["min_support"]
    return (circular and breakpoints == 1 and support
            and (uniq_bridges >= 1 or signal == "GTAG")
            and edits <= fc["max_edits"] and span <= fc["max_span"])


def recount(calls, chrom_names, chrom_offsets, cfg, fc: dict):
    """(Counter of BED rows as tuples of their column strings without
    the name, {stats name: count}) of the library's `calls` under the
    configuration's `find_circ` settings `fc`."""
    groups = defaultdict(list)
    stats = Counter(reads_total=len(calls))
    for c in calls:
        stats[STATUS_NAMES[c.status]] += 1
        if c.status == ST_JUNCTION:
            circ = c.kind == KIND_CIRCULAR
            stats["circular_reads" if circ else "linear_reads"] += 1
            groups[(c.kind, c.chrom_idx, c.start, c.end, c.sense)].append(c)
    rows = Counter()
    for (kind, chrom, start, end, sense), cs in groups.items():
        circ = kind == KIND_CIRCULAR
        stats["circular_junctions" if circ else "linear_junctions"] += 1
        uniq = sum(c.qual_left >= cfg.min_uniq_qual
                   and c.qual_right >= cfg.min_uniq_qual for c in cs)
        edits = min(c.edits for c in cs)
        n_bp = min(c.n_bp for c in cs)
        signal = cs[0].signal
        if fc["filter"] and not _passes(len(cs), uniq, edits, n_bp, signal,
                                        circ, end - start, fc):
            continue
        sm = _strandmatch(cs, cfg.stranded)
        off = int(chrom_offsets[chrom])
        rows[tuple(str(v) for v in (
            chrom_names[chrom], start - off, end - off, len(cs),
            SENSE_CHARS[sense], len({c.seq for c in cs}), uniq,
            max(c.qual_left for c in cs), max(c.qual_right for c in cs),
            fc["name"], len(cs), edits, min(c.overlap for c in cs), n_bp,
            signal, sm, _category(circ, n_bp, uniq, signal, sm)))] += 1
    stats.setdefault("circular_junctions", 0)
    stats.setdefault("linear_junctions", 0)
    return rows, dict(stats)


def differences(bed: str, stats: str, rows: Counter, counts: dict) -> dict:
    """BED rows of a pass (name column aside) that are not in the
    recount or that the recount has and the pass lacks, and the stats
    names whose counts differ (a missing name counts 0)."""
    got = Counter()
    for line in bed.splitlines():
        if line and not line.startswith("#"):
            f = line.split("\t")
            got[tuple(f[:3] + f[4:])] += 1
    have = {}
    for line in stats.splitlines():
        if line:
            k, v = line.split("\t")
            have[k] = int(v)
    return dict(
        table_rows_differing=sum(((got - rows) + (rows - got)).values()),
        table_stats_differing=sum(have.get(k, 0) != counts.get(k, 0)
                                  for k in set(have) | set(counts)))
