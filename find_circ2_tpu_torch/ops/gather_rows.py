"""The row gather `table[idx]` as a hand-written CUDA kernel.

Replaces `find_circ2_tpu/ops/pallas_k1.py:gather_rows_pallas` (there a
DEPTH-8 chain of per-row DMAs, kept off the TPU's main path); here it is
on the main path, as every table and neighbour-table row fetch of
`ops/anchor_align` and the §2b extras fetches of `ops/explore`. Rows are
fetched at hashed or random indices, so each row costs one random DRAM
sector: the kernel is bound by sector reads in flight, not by bandwidth,
and keeps many independent loads in flight (csrc/gather_rows.cu). Rows
of a multiple of 16 bytes (K1's 32-byte rows) move as 16-byte vectors,
any other width (explore's 8-byte `ext_id` and 120-byte `ext` rows) as
4-byte words.

A CPU tensor takes the plain version, `gather_rows_ref`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from find_circ2_tpu_torch import _build

# Kernel launches since the last reset (set to 0 to reset).
launches = 0


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: whole rows table[idx]."""
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a contiguous int32 `table` [T, W] (any W >= 1) and
    int32/int64 `idx` [n]; returns int32 [n, W]."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device}, idx on "
                         f"{idx.device}; both must be on one CUDA device")
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError("gather_rows: table must be int32 [T, W]")
    if table.shape[1] < 1 or not table.is_contiguous():
        raise ValueError("gather_rows: rows must be contiguous, W >= 1")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("gather_rows: idx must be int32/int64 [n]")
    lib = _build.load()
    idx = idx.contiguous()
    n, W = idx.shape[0], table.shape[1]
    out = torch.empty((n, W), dtype=torch.int32, device=table.device)
    if n == 0:
        return out
    err = lib.fc2t_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
        table.shape[0], W, int(idx.dtype == torch.int64),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(err, "gather_rows launch")
    global launches
    launches += 1
    return out
