"""The single-table exact-first probe (ops/anchor_align.exact_anchor_stats,
csrc/exact_stats.cu) built from this checkout and from another checkout's
csrc/, timed in turns on the same inputs in one process, device alone
(CUDA-graph replay), with their outputs held equal.

    python3 scripts/probe_ab.py OTHER_CSRC [--rounds 8] [--anchors 8192]
        [--rows 6671562] [--sets 24] [--seed 0]

The other checkout's ExactArgs must hold this one's fields up to `device`
at the same offsets: its kernel is launched through this checkout's
wrapper and reads only those. The table is random, at the rows of the
16 Mbp filter stack's index (larger than the L2), with every anchor's key
placed in the first slot of its first bucket, so that each anchor is
found, as most are on the stream. A round times both builds, in the order
other, this, this, other on even rounds and the reverse on odd ones.
Prints the card's name and power limit, one line a round and a JSON
summary: each build's median, least and largest ms a call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from find_circ2_tpu_torch import _build  # noqa: E402
from find_circ2_tpu_torch.config import Config  # noqa: E402
from find_circ2_tpu_torch.index.hashtable import mix_hash  # noqa: E402
from find_circ2_tpu_torch.ops import anchor_align as ta  # noqa: E402

REPLAYS = 20


def other_library(csrc: str) -> ctypes.CDLL:
    """The kernel library built from `csrc` (another checkout's csrc/)."""
    here = _build.CSRC
    _build.CSRC = os.path.abspath(csrc)
    try:
        return _build._bind(ctypes.CDLL(_build.build()))
    finally:
        _build.CSRC = here


def inputs(rows: int, n: int, sets: int, seed: int, cfg: Config,
           device: str = "cuda"):
    """(table, ntable, meta, [anchors of each set]) on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    salts = torch.randint(1, 2 ** 31, (2,), generator=g, device=device) | 1
    meta = torch.cat([salts, torch.tensor([rows], device=device)]).to(
        torch.int32)
    table = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 8), generator=g,
                          device=device, dtype=torch.int32)
    ntable = torch.zeros((rows, 8), dtype=torch.int32, device=device)
    sets_ = [torch.randint(0, 4, (n, cfg.anchor_len), generator=g,
                           device=device, dtype=torch.uint8)
             for _ in range(sets)]
    for anchors in sets_:
        _, _, cp, cs = ta._exact_keys(anchors, cfg)
        h = mix_hash(cp, cs, int(salts[0])) % rows
        pos = torch.randint(0, 2 ** 31, (n,), generator=g, device=device)
        table[h, 0] = cp.to(torch.int32)
        table[h, 1] = (cs | 1 << 16).to(torch.int32)
        table[h, 2] = pos.to(torch.int32)
        table[h, 3] = (pos + 1).to(torch.int32)
        ntable[h, :4] = torch.stack([torch.ones_like(pos), pos + 2,
                                     torch.zeros_like(pos), pos + 3],
                                    1).to(torch.int32)
    return table, ntable, meta, sets_


def graph_ms(fn, sets) -> float:
    """Device ms a call: one call a set in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    keep = []
    with torch.cuda.graph(graph):
        for s in sets:
            keep.append(fn(s))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (REPLAYS * len(sets))


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_csrc")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--anchors", type=int, default=8192)
    p.add_argument("--rows", type=int, default=6_671_562)
    p.add_argument("--sets", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cfg = Config()
    libs = {"other": other_library(args.other_csrc), "this": _build.load()}
    table, ntable, meta, sets = inputs(args.rows, args.anchors, args.sets,
                                       args.seed, cfg)

    def run(lib):
        return lambda a: ta._launch_exact((table, ntable, meta, a), cfg, lib)

    for a in sets:
        x, y = (run(libs[k])(a) for k in ("other", "this"))
        if not all(torch.equal(u, v) for u, v in zip((*x[0], x[1]),
                                                      (*y[0], y[1]))):
            print("probe_ab: the two builds differ", file=sys.stderr)
            return 1
    times = {"other": [], "this": []}
    for r in range(args.rounds):
        order = (("this", "other", "other", "this") if r % 2
                 else ("other", "this", "this", "other"))
        got = [(k, graph_ms(run(libs[k]), sets)) for k in order]
        for k, ms in got:
            times[k].append(ms)
        print(f"round {r}: " + ", ".join(f"{k} {ms:.5f} ms" for k, ms in got))
    print(card)
    print(json.dumps({k: {"median_ms": statistics.median(v),
                          "min_ms": min(v), "max_ms": max(v), "runs": v}
                      for k, v in times.items()}
                     | {"anchors": args.anchors, "rows": args.rows,
                        "sets": args.sets}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
