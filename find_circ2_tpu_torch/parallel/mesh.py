"""Device mesh of the sharded engine (reference:
find_circ2_tpu/parallel/mesh.py).

The mesh has two axes, "data" (read batches split across rows) and
"index" (the seed index sharded by k-mer prefix range), or three with
"dhost" in front for the hierarchical junction merge. A mesh is an array
of torch devices, one per slot. One device may fill several slots: one
card holds a 2x2 mesh as four slots on `cuda:0`, and the CPU tests use
`["cpu"] * 8` where the reference uses 8 virtual CPU devices. The
engine keeps one copy of each index shard per (device, shard), so slots
that share a device share its tables.

In a multi-process run (parallel/distributed.py) the first axis is split
among the processes by rank, host-major as `jax.devices()` orders them:
every process holds its own devices in its block and drives only that
block.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Mesh:
    """Slots of torch devices over named axes, split over `nproc`
    processes along the first axis."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 nproc: int = 1, rank: int = 0) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.nproc = nproc
        self.rank = rank

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> np.ndarray:
        """This process's block of the first axis."""
        per = self.devices.shape[0] // self.nproc
        return self.devices[self.rank * per:(self.rank + 1) * per]


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices of one type this process sees: every card, or the
    CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("no CUDA device is available (give the mesh "
                           "CPU devices to run on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def round_robin(n: int, kind: str = "cuda") -> list[torch.device]:
    """n slots over the visible devices of one type, in turn (the CLI's
    --mesh)."""
    devs = visible_devices(kind)
    return [devs[i % len(devs)] for i in range(n)]


def world() -> tuple[int, int]:
    """(process count, rank) of the default process group, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_over(shape: tuple[int, ...], names: tuple[str, ...], devices
              ) -> Mesh:
    """The global mesh of `shape`: each process fills its block with the
    first of its `devices` (default: its visible cards)."""
    nproc, rank = world()
    if shape[0] % nproc:
        raise ValueError(f"mesh axis {names[0]!r} of {shape[0]} does not "
                         f"split over {nproc} processes")
    local = math.prod(shape) // nproc
    devs = list(devices) if devices is not None else visible_devices()
    if len(devs) < local:
        raise ValueError(f"need {local} devices, have {len(devs)}")
    slots = np.empty(local * nproc, dtype=object)
    slots[:] = [torch.device(d) for d in devs[:local]] * nproc
    return Mesh(slots.reshape(shape), names, nproc, rank)


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """(data, index) shape: prefer index parallelism up to 4, rest data."""
    for index in (4, 2, 1):
        if n_devices % index == 0:
            return n_devices // index, index
    return n_devices, 1


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """(data, index) mesh of n_devices slots over all processes (default:
    every device of `devices`, or of the visible cards, on each)."""
    if n_devices is None:
        n_devices = (len(devices) if devices is not None
                     else len(visible_devices())) * world()[0]
    if shape is None:
        shape = factor_mesh(n_devices)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    return mesh_over(tuple(shape), ("data", "index"), devices)


def make_hier_mesh(dhost: int, data: int, index: int, devices=None) -> Mesh:
    """Three-axis (dhost, data, index) mesh for the hierarchical junction
    merge: data rows merge within their dhost group first, then the
    groups' collapsed tables merge; across processes, "dhost" is the axis
    that crosses them."""
    return mesh_over((dhost, data, index), ("dhost", "data", "index"),
                     devices)
