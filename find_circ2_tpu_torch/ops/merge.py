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

On CPU tensors both take the plain version (`_sort_combine`, after
`merge_junctions_ref`'s table build); on CUDA tensors each is one call
of the hand-written kernels of csrc/merge.cu (its header says how they
sort and combine across the SMs), which build merge_junctions' table in
their load pass.
"""

from __future__ import annotations

import torch

from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.config import Config, ST_JUNCTION

BIGDEF = 2 ** 30
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1

KEY_FIELDS = ("kind", "chrom", "start", "end", "sense")
SUM_FIELDS = ("n_reads", "uniq_bridges", "n_strand_match")
MAX_FIELDS = ("best_qual_left", "best_qual_right")
MIN_FIELDS = ("edits", "overlap", "n_bp")
ALL_FIELDS = ("valid",) + KEY_FIELDS + SUM_FIELDS + MAX_FIELDS + MIN_FIELDS
# csrc/merge.cu's kTile: the rows of a tile (a block sorts one, ranks one
# against the other tiles, combines one).
TILE_ROWS = 128
# The stages of csrc/merge.cu between its stage clocks
# (FC2T_MERGE_STAMPS), a tile's: merge_tiles' two, merge_rank's two,
# merge_combine's one.
STAGES = ("load and key build", "tile sort", "rank", "scatter", "combine")
# What merge_junctions reads of a detect result besides lens, with the
# kernel's dtypes ("multi" may be absent).
RESULT_FIELDS = {"status": torch.int32, "kind": torch.int32,
                 "chrom": torch.int32, "start": torch.int64,
                 "end": torch.int64, "sense": torch.int32,
                 "qual_left": torch.int32, "qual_right": torch.int32,
                 "align_strand": torch.int32, "edits": torch.int32,
                 "overlap": torch.int32, "n_bp": torch.int32,
                 "multi": torch.int32}
# The table's dtypes, in and out.
TABLE_DTYPES = {name: (torch.bool if name == "valid" else torch.int64
                       if name in ("start", "end") else torch.int32)
                for name in ALL_FIELDS}

# Kernels launched (csrc/merge.cu, merge_kernels(n) a call) and C calls
# of fc2t_merge made since the last reset (set to 0 to reset).
launches = 0
calls = 0


def merge_kernels(n: int) -> int:
    """The kernels one C call launches on n rows: merge_tiles and
    merge_combine, and merge_rank between them above one tile."""
    return 0 if n <= 0 else 2 if n <= TILE_ROWS else 3


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
    re-adds them. CPU tensors take the plain version; CUDA tensors launch
    csrc/merge.cu on the current stream (no wait) or raise."""
    src = {k: res[k] for k in RESULT_FIELDS if k in res}
    if all(t.is_cpu for t in (lens, *src.values())):
        return merge_junctions_ref(res, lens, cfg)
    return _launch_merge(dict(src, lens=lens), cfg)


def merge_junctions_ref(res: dict, lens: torch.Tensor, cfg: Config) -> dict:
    """Plain version of merge_junctions: the table, then _sort_combine."""
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
    table of length K*N. CPU tensors take the plain version
    (_sort_combine); CUDA tensors launch csrc/merge.cu on the current
    stream (no wait) or raise."""
    flat = {name: tables[name].reshape(-1) for name in ALL_FIELDS}
    if all(t.is_cpu for t in flat.values()):
        return _sort_combine(flat)
    return _launch_merge(flat)


def _check_merge(src: dict) -> int:
    """Raise unless csrc/merge.cu takes these columns; return their
    length."""
    result = "valid" not in src
    want = (dict(RESULT_FIELDS, lens=torch.int32) if result
            else TABLE_DTYPES)
    first = src["lens" if result else "valid"]
    n = first.shape[0] if first.dim() == 1 else -1
    for k, t in src.items():
        if (k not in want or t.dtype != want[k] or t.dim() != 1
                or t.shape[0] != n or not t.is_contiguous()
                or t.device != first.device):
            raise ValueError(
                f"merge: want contiguous 1-d columns of one length on one "
                f"CUDA device, dtypes {want}; got {k} {t.dtype} "
                f"{list(t.shape)} on {t.device}")
    if first.device.type != "cuda":
        raise ValueError(f"merge: columns on {first.device}; the kernel "
                         "takes one CUDA device (CPU tensors take the "
                         "plain version)")
    if n >= 2 ** 31:
        raise ValueError(f"merge: {n} rows, the kernel takes < 2^31")
    return n


def _launch_merge(src: dict, cfg: Config | None = None, lib=None) -> dict:
    """merge_junctions (`src` a detect result's RESULT_FIELDS and lens,
    with `cfg`) or merge_tables (`src` a flat table) on CUDA tensors: one
    C call into `lib` (default: the kernel library), made with the
    columns' device current, with one scratch buffer of the size the
    library asks for."""
    global launches, calls
    n = _check_merge(src)
    result = "valid" not in src
    first = src["lens" if result else "valid"]
    dev = first.device
    out = {k: torch.empty(n, dtype=d, device=dev)
           for k, d in TABLE_DTYPES.items()}
    if n == 0:
        return out
    lib = lib or _build.load()
    nbytes = lib.fc2t_merge_scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def ptr(name):
        t = src.get(name)
        return 0 if t is None else t.data_ptr()

    if result:
        rows = ([0] + [ptr(k) for k in KEY_FIELDS] + [0] * len(SUM_FIELDS)
                + [ptr("qual_left"), ptr("qual_right")]
                + [ptr(k) for k in MIN_FIELDS]
                + [ptr(k) for k in ("status", "lens", "multi",
                                    "align_strand")])
    else:
        rows = [ptr(k) for k in ALL_FIELDS] + [0] * 4
    index = first.get_device()
    with torch.cuda.device(index):
        got = lib.fc2t_merge(_build.MERGE_ARGS.pack(
            *rows, *(out[k].data_ptr() for k in ALL_FIELDS),
            scratch.data_ptr(), torch._C._cuda_getCurrentRawStream(index),
            n, nbytes, ST_JUNCTION, cfg.min_uniq_qual if result else 0,
            index, 0))
    if got < 0:
        _build.check(-got, "merge launch")
    calls += 1
    launches += got
    return out


def merge_stage_cycles(res: dict, lens: torch.Tensor, cfg: Config):
    """merge_junctions on CUDA tensors through the measurement build of
    csrc/merge.cu: (its table, int64 [tiles, len(STAGES)] SM clock cycles
    of each tile's stages, each from its start to its end on one SM's
    clock64; a tile of TILE_ROWS rows; rank and scatter 0 on one tile).
    One C call, counted on `calls` and `launches`."""
    src = dict({k: res[k] for k in RESULT_FIELDS if k in res}, lens=lens)
    tiles = -(-lens.shape[0] // TILE_ROWS)
    got, cyc = _build.stamped("fc2t_merge_stamps", tiles,
                              2 * len(STAGES) - 1, lens,
                              lambda lib: _launch_merge(src, cfg, lib))
    return got, cyc[:, ::2]
