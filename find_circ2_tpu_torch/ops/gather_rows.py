"""The row gather `table[idx]` as a hand-written CUDA kernel.

Replaces `find_circ2_tpu/ops/pallas_k1.py:gather_rows_pallas` (there a
DEPTH-8 chain of per-row DMAs, kept off the TPU's main path); here it is
every table and neighbour-table row fetch of the plain K1 in
`ops/anchor_align` (`_bucket_rows`, the §2b extras), which the sharded
engine's per-shard partials run on the card. On one table K1's kernels
(csrc/exact_stats.cu, csrc/classic_k1.cu) fetch their own rows. Rows are
fetched at hashed or random indices, so each row costs one or a few
random DRAM sectors. The kernel (csrc/gather_rows.cu) loads each row's
index once per warp tile, moves rows in 16-, 8- or 4-byte vectors, issues
all of a thread's row loads before its stores, and gathers two tables
that share their indices in one launch (`gather_rows_multi`).

A CPU tensor takes the plain version (`gather_rows_ref`,
`gather_rows_multi_ref`); a CUDA tensor launches the kernel or raises.
Launches go to PyTorch's current stream, so they can be captured in a
CUDA graph.
"""

from __future__ import annotations

import torch

from find_circ2_tpu_torch import _build

# Kernel launches since the last reset (set to 0 to reset), by wrapper.
launches = 0          # gather_rows
multi_launches = 0    # gather_rows_multi


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: whole rows table[idx]."""
    return table.index_select(0, idx)


def gather_rows_multi_ref(tables, idx: torch.Tensor) -> list[torch.Tensor]:
    """Plain version of gather_rows_multi."""
    return [t.index_select(0, idx) for t in tables]


def _check(tables, idx: torch.Tensor) -> int:
    """The index of the one CUDA device of `tables` and `idx`; raises on
    anything the kernel does not take."""
    dev = idx.get_device()
    if not idx.is_cuda:
        raise ValueError(f"gather_rows: idx on {idx.device}; tables and "
                         "idx must be on one CUDA device")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("gather_rows: idx must be int32/int64 [n]")
    for t in tables:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"gather_rows: a table on {t.device}, idx on "
                             f"{idx.device}; all must be on one CUDA device")
        if (t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous()
                or t.shape[1] < 1):
            raise ValueError("gather_rows: table must be a contiguous int32 "
                             "[T, W >= 1]")
    return dev


def _launch(dev: int, idx, n: int, a, oa, b=None, ob=None) -> int:
    """One C call for table `a` and, unless None, table `b`: the kernels
    it launched (one for the main path's pairs, else one per table). The
    call runs with `dev` current: the default stream's handle is null,
    and a launch on it runs on the current device."""
    rows, wa = a.shape
    if b is None:
        b_ptr = ob_ptr = wb = 0
    else:
        b_rows, wb = b.shape
        rows = min(rows, b_rows)
        b_ptr, ob_ptr = b.data_ptr(), ob.data_ptr()
    lib = _build.load()
    with torch.cuda.device(dev):
        got = lib.fc2t_gather_rows(_build.GATHER_ARGS.pack(
            a.data_ptr(), oa.data_ptr(), b_ptr, ob_ptr, idx.data_ptr(), n,
            rows, torch._C._cuda_getCurrentRawStream(dev), wa, wb,
            idx.dtype == torch.int64, dev))
    if got < 0:
        _build.check(-got, "gather_rows launch")
    return got


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a contiguous int32 `table` [T, W] (any W >= 1) and
    int32/int64 `idx` [n]; returns int32 [n, W]."""
    global launches
    if table.is_cpu and idx.is_cpu:
        return gather_rows_ref(table, idx)
    dev = _check((table,), idx)
    idx = idx.contiguous()
    n = idx.shape[0]
    out = table.new_empty((n, table.shape[1]))
    if n:
        launches += _launch(dev, idx, n, table, out)
    return out


def gather_rows_multi(tables, idx: torch.Tensor) -> list[torch.Tensor]:
    """[t[idx] for t in tables]: the same rows of several contiguous
    int32 tables [T_t, W_t], one [n, W_t] output per table. Each pair of
    tables is one kernel launch, so each index is loaded once per row and
    pair, not once per table."""
    global multi_launches
    tables = tuple(tables)
    if not tables:
        raise ValueError("gather_rows_multi: no tables")
    if idx.is_cpu and all(t.is_cpu for t in tables):
        return gather_rows_multi_ref(tables, idx)
    dev = _check(tables, idx)
    idx = idx.contiguous()
    n = idx.shape[0]
    outs = [t.new_empty((n, t.shape[1])) for t in tables]
    if n:
        for i in range(0, len(tables), 2):
            pair = i + 1 < len(tables)
            multi_launches += _launch(
                dev, idx, n, tables[i], outs[i],
                tables[i + 1] if pair else None, outs[i + 1] if pair else None)
    return outs
