"""Multi-process runs (reference: find_circ2_tpu/parallel/distributed.py).

Processes join one torch.distributed group over gloo, given its address,
size and this process's rank; nothing here reads a cluster from the
environment. Detection stays on each process's own devices. What crosses
processes is small and goes over gloo on host copies: one int64 stats
vector (`allreduce_counts`) and, in the sharded engine's merge, one
collapsed junction table per process. gloo is the stated backend, not a
fallback: NCCL refuses two ranks on one card, and the detect step needs
no collective on the card.

The global mesh spans the processes: each one holds its own devices in
its block of the first axis (parallel/mesh.py).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from find_circ2_tpu_torch.parallel.mesh import (Mesh, mesh_over,
                                                visible_devices, world)

# Seconds a process waits for the others, at start-up and in each
# collective, before it fails. `find_circ --nproc` meets the others at
# start-up and after its stream, so this bounds how far the processes'
# streams may drift apart.
TIMEOUT_S = 1800


def init_distributed(coordinator: str | None, nproc: int | None,
                     proc_id: int | None, timeout_s: float = TIMEOUT_S
                     ) -> None:
    """Join the gloo process group of `nproc` processes whose rank 0
    listens on `coordinator` ("host:port"). One process: nothing to do.
    Call once per process, before any collective."""
    if nproc is None or nproc <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=nproc,
        rank=proc_id, timeout=datetime.timedelta(seconds=timeout_s))


def close_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(index_parallel: int | None = None, devices=None) -> Mesh:
    """The global (data, index) mesh over every process's `devices`
    (default: its visible cards). `index_parallel` defaults to the devices
    per process, halved until it divides the total, so the index axis
    stays within a process; the data axis takes the rest."""
    local = list(devices) if devices is not None else visible_devices()
    n = len(local) * world()[0]
    if index_parallel is None:
        index_parallel = max(1, len(local))
        while n % index_parallel:
            index_parallel //= 2
    return mesh_over((n // index_parallel, index_parallel),
                     ("data", "index"), local)


def host_read_slice(path_records: int, host_id: int | None = None,
                    n_hosts: int | None = None) -> tuple[int, int]:
    """[start, stop) record range this process streams from the input
    (contiguous split; the junction merge is order-free)."""
    nproc, rank = world()
    host_id = rank if host_id is None else host_id
    n_hosts = nproc if n_hosts is None else n_hosts
    per = -(-path_records // n_hosts)
    start = min(host_id * per, path_records)
    return start, min(start + per, path_records)


def allreduce_counts(vec) -> np.ndarray:
    """Sum an int64 counter vector over the processes (gloo, host
    memory); one process: the vector as it is."""
    vec = np.asarray(vec, np.int64)
    if world()[0] == 1:
        return vec
    t = torch.from_numpy(vec.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def stats_to_vec(stats, order) -> np.ndarray:
    """Stats counters -> fixed-order vector for allreduce_counts."""
    return np.asarray([stats.counts.get(k, 0) for k in order], np.int64)

