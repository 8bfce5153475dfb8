"""K-h: junction dedup and merge on the device (reference:
find_circ2_tpu/ops/merge.py).

`merge_junctions` collapses a detect_batch result into a per-junction
table; `merge_tables` re-merges already merged tables, stacked [K, N],
as the sharded engine gathers them across data rows and processes.
Merging is associative and commutative over integer fields, so any
merge tree gives the same valid rows.

Every one of the N output rows equals the reference's, fill rows
included: the sort is stable (the fill rows take their key fields from
the last sorted row), and empty segments keep the reference's
identities (sum 0, min int32 max, max int32 min). start/end are uint32
positions carried in int64, as in the port's detect results.
"""

from __future__ import annotations

import torch

from find_circ2_tpu_torch.config import Config, ST_JUNCTION

BIGDEF = 2 ** 30
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1

KEY_FIELDS = ("kind", "chrom", "start", "end", "sense")
SUM_FIELDS = ("n_reads", "uniq_bridges", "n_strand_match")
MAX_FIELDS = ("best_qual_left", "best_qual_right")
MIN_FIELDS = ("edits", "overlap", "n_bp")
ALL_FIELDS = ("valid",) + KEY_FIELDS + SUM_FIELDS + MAX_FIELDS + MIN_FIELDS


def _lexsort(keys) -> torch.Tensor:
    """Stable lexicographic order, the last key primary (jnp.lexsort):
    one stable sort per key, least significant first."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _sort_combine(t: dict) -> dict:
    """Sort a junction table by key, combine rows with equal keys.

    `t` maps ALL_FIELDS to [N] tensors (valid: bool). Output has the
    same schema: distinct junctions packed at the front in key order."""
    N = t["valid"].shape[0]
    dev = t["valid"].device
    live = t["valid"]
    k_hi = torch.where(live, t["kind"].to(torch.int64) * (1 << 16)
                       + t["chrom"], 1 << 24)
    k_start = torch.where(live, t["start"].to(torch.int64), 0)
    k_end = torch.where(live, t["end"].to(torch.int64), 0)
    k_sense = torch.where(live, t["sense"], 0)
    order = _lexsort((k_sense, k_end, k_start, k_hi))

    s = {name: t[name][order] for name in ALL_FIELDS}
    s_live = s["valid"]
    same = torch.ones(N, dtype=torch.bool, device=dev)
    for name in KEY_FIELDS:
        same[1:] &= s[name][1:] == s[name][:-1]
    same[:1] = False
    same &= s_live & torch.roll(s_live, 1)
    head = s_live & ~same
    seg = torch.where(s_live, torch.cumsum(head, 0) - 1, N - 1)

    def segment(x, dead, init, reduce):
        out = torch.full((N,), init, dtype=torch.int32, device=dev)
        vals = torch.where(s_live, x, dead).to(torch.int32)
        return out.scatter_reduce_(0, seg, vals, reduce, include_self=False)

    # Row of each head in segment order, N - 1 past the last (jnp.nonzero
    # with fill_value); a scatter, so the device is not waited on.
    rows = torch.arange(N, device=dev)
    head_idx = torch.full((N + 1,), N - 1, dtype=torch.int64, device=dev)
    head_idx.scatter_(0, torch.where(head, seg, N), rows)
    head_idx = head_idx[:N]

    out = {"valid": rows < head.sum()}
    for name in KEY_FIELDS:
        out[name] = s[name][head_idx]
    for name in SUM_FIELDS:
        out[name] = segment(s[name], 0, 0, "sum")
    for name in MAX_FIELDS:
        out[name] = segment(s[name], 0, I32_MIN, "amax")
    for name in MIN_FIELDS:
        out[name] = segment(s[name], BIGDEF, I32_MAX, "amin")
    return out


def merge_junctions(res: dict, lens: torch.Tensor, cfg: Config) -> dict:
    """detect_batch result -> deduplicated per-junction table [B].

    Multi-hit-flagged rows (SPEC §2b) are excluded when present: their
    single-best junction is provisional; the host slow path re-calls and
    re-adds them."""
    live = (res["status"] == ST_JUNCTION) & (lens > 0)
    if "multi" in res:
        live = live & (res["multi"] == 0)
    uniq = ((res["qual_left"] >= cfg.min_uniq_qual)
            & (res["qual_right"] >= cfg.min_uniq_qual) & live)
    one = live.to(torch.int32)
    t = dict(
        valid=live,
        kind=res["kind"], chrom=res["chrom"], start=res["start"],
        end=res["end"], sense=res["sense"],
        n_reads=one,
        uniq_bridges=uniq.to(torch.int32),
        n_strand_match=((res["align_strand"] == res["sense"]) & live
                        ).to(torch.int32),
        best_qual_left=res["qual_left"],
        best_qual_right=res["qual_right"],
        edits=res["edits"], overlap=res["overlap"], n_bp=res["n_bp"],
    )
    return _sort_combine(t)


def merge_tables(tables: dict) -> dict:
    """Re-merge a stack of merged tables (fields shaped [K, N]) into one
    table of length K*N."""
    return _sort_combine({name: tables[name].reshape(-1)
                          for name in ALL_FIELDS})
