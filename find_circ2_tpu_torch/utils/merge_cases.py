"""Junction-merge (K-h, ops/merge.py) inputs that pin its edge cases.

`merge_case(name, n, seed)` makes a detect result of n rows as host
arrays (the fields merge_junctions reads, start and end uint32) and its
lengths, from numpy's generator only, so the CPU tests can hand the same
rows to the JAX package and to the port, and chip_smoke.py and the card
tests can hold csrc/merge.cu against the plain version on them:

- "random": few distinct keys, so runs merge, dead rows of every kind
  (other statuses, multi-flagged, length 0), starts and ends on both
  sides of 2^31;
- "all-dead": no row is live, so every segment is empty but N - 1;
- "one-key": every row live with the same key: one segment of N rows;
- "dups": every row live, keys with duplicates, so segment N - 1 is an
  empty one (no dead row feeds it);
- "distinct": every row live and every key distinct: N heads, no fill
  row;
- "big": every start and end at or above 2^31;
- "stable": equal keys at rows far apart and dead rows whose raw fields
  differ, so the fill rows show which row the stable sort put last;
- "long-runs": in key order, runs of equal live keys of lengths T - 1,
  T and T + 1 and one of several tiles (T = ops/merge.TILE_ROWS, the
  kernel's tile), with short runs between them, so runs start at
  offsets on both sides of the tiles' edges; the rows come shuffled,
  with a tenth more rows dead (they sort after the runs);
- "tile-edge": in key order, heads exactly at the tiles' edges (a key a
  tile), then live rows whose masked key equals the dead rows' (kind
  256, chrom 0, the rest 0) with dead rows among them at each tile's
  first, middle and last row, so a head follows each dead row.

N = 1 is any case at n = 1.
"""

from __future__ import annotations

import numpy as np

from find_circ2_tpu_torch.config import ST_JUNCTION
from find_circ2_tpu_torch.ops.merge import TILE_ROWS

CASES = ("random", "all-dead", "one-key", "dups", "distinct", "big",
         "stable", "long-runs", "tile-edge")
BIG = np.array([5, 2 ** 31 - 3, 2 ** 31, 2 ** 31 + 9, 2 ** 32 - 7],
               np.uint32)


def merge_case(name: str, n: int, seed: int) -> tuple[dict, np.ndarray]:
    """(detect result {field: numpy [n]}, lens int32 [n]) of case `name`."""
    if name not in CASES:
        raise ValueError(f"unknown merge case {name!r}; one of {CASES}")
    rng = np.random.default_rng(seed)

    def ints(lo, hi):
        return rng.integers(lo, hi, n).astype(np.int32)

    res = dict(
        status=np.where(rng.random(n) < 0.7, ST_JUNCTION,
                        rng.integers(1, 9, n)).astype(np.int32),
        kind=ints(0, 2), chrom=ints(0, 3), start=rng.choice(BIG, n),
        end=rng.choice(BIG, n), sense=ints(0, 2), align_strand=ints(0, 2),
        qual_left=ints(0, 41), qual_right=ints(0, 41), edits=ints(0, 6),
        overlap=ints(0, 30), n_bp=ints(1, 4),
        multi=(rng.random(n) < 0.1).astype(np.int32))
    lens = np.where(rng.random(n) < 0.9, 100, 0).astype(np.int32)
    live = dict(status=np.full(n, ST_JUNCTION, np.int32),
                multi=np.zeros(n, np.int32))
    if name == "all-dead":
        res["status"] = rng.integers(1, 9, n).astype(np.int32)
    elif name == "one-key":
        res.update(live, kind=np.ones(n, np.int32),
                   chrom=np.full(n, 2, np.int32),
                   start=np.full(n, 2 ** 31 + 9, np.uint32),
                   end=np.full(n, 5, np.uint32), sense=np.ones(n, np.int32))
        lens[:] = 100
    elif name == "dups":
        res.update(live)
        lens[:] = 100
    elif name == "distinct":
        res.update(live, start=(rng.permutation(n).astype(np.uint32)
                                * np.uint32(7919)
                                + np.uint32(2 ** 31 - n)),
                   end=rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                   .astype(np.uint32))
        lens[:] = 100
    elif name == "big":
        res["start"] = rng.integers(2 ** 31, 2 ** 32, n,
                                    dtype=np.uint64).astype(np.uint32)
        res["end"] = rng.choice(BIG[2:], n)
    elif name == "stable":
        # Two live keys alternating down the rows, every fourth row dead
        # with raw fields of its own.
        res.update(live, kind=np.zeros(n, np.int32),
                   chrom=np.ones(n, np.int32),
                   start=np.where(np.arange(n) % 2, BIG[3], BIG[1]),
                   end=np.full(n, BIG[4]), sense=np.zeros(n, np.int32))
        lens[:] = 100
        dead = np.arange(n) % 4 == 3
        res["status"][dead] = 3
        for k in ("kind", "chrom", "sense"):
            res[k][dead] = rng.integers(0, 1000, int(dead.sum()))
        res["start"][dead] = rng.choice(BIG, int(dead.sum()))
    elif name == "long-runs":
        T = TILE_ROWS
        n_live = n - n // 10
        runs, pattern = [], (T - 1, 3, T, 5, T + 1, 7, 3 * T + 11, 2)
        while sum(runs) < n_live:
            runs.extend(pattern)
        key = np.concatenate([np.repeat(np.arange(len(runs)), runs)[:n_live],
                              np.zeros(n - n_live, np.int64)])
        order = rng.permutation(n)
        res.update(live, kind=np.zeros(n, np.int32),
                   chrom=np.ones(n, np.int32),
                   start=(BIG[2] + key[order]).astype(np.uint32),
                   end=np.full(n, BIG[3]), sense=np.ones(n, np.int32))
        lens[:] = 100
        res["status"][order >= n_live] = 3
    elif name == "tile-edge":
        T = TILE_ROWS
        tile, r = np.arange(n) // T, np.arange(n) % T
        even = tile % 2 == 0
        res.update(live, kind=np.where(even, 0, 256).astype(np.int32),
                   chrom=np.where(even, 1, 0).astype(np.int32),
                   start=np.where(even, BIG[1] + tile, 0).astype(np.uint32),
                   end=np.where(even, BIG[4], 0).astype(np.uint32),
                   sense=np.zeros(n, np.int32))
        lens[:] = 100
        edge = ~even & ((r == 0) | (r == T // 2) | (r == T - 1))
        res["status"][edge & (r == 0)] = 3
        res["multi"][edge & (r == T // 2)] = 1
        lens[edge & (r == T - 1)] = 0
        for k in ("kind", "chrom", "sense"):
            res[k][edge] = rng.integers(0, 1000, int(edge.sum()))
    return res, lens
