"""Device meshes and the process group (counterpart of
`seismic_tpu/parallel/mesh.py`).

A mesh is a `[n_data, n_docs]` grid of devices with two axes:

- ``"data"``: the query batch is split over it (each row answers its
  slice of the batch);
- ``"docs"``: the documents are split into contiguous shards over it;
  each column holds one shard's index, and the rows' results are merged
  by (score, global id).

An entry may repeat a device: a list of `n` "cpu" entries is how the
tests run several shards on the CPU (the JAX tests force a host device
count for the same purpose), and one card may hold every shard. A mesh
from `make_mesh_global` spans the processes of a `torch.distributed`
group, and records the rank that owns each entry.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class Mesh:
    """`grid[d][s]` is the device of data row d, docs shard s; `ranks`
    (same shape) the process that owns it, None for a mesh of this
    process alone."""

    grid: tuple
    ranks: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "docs": len(self.grid[0])}

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    def is_local(self, d: int, s: int) -> bool:
        """Whether entry (d, s) belongs to this process."""
        if self.ranks is None:
            return True
        import torch.distributed as dist

        return self.ranks[d][s] == dist.get_rank()


def _grid(devices: list, n_docs_shards, n_data: int, what: str):
    if n_docs_shards is None:
        n_docs_shards = len(devices) // n_data
    n = n_data * n_docs_shards
    if n_docs_shards < 1 or n > len(devices):
        raise ValueError(f"{what} ({n_data} x {n_docs_shards}) needs {n} "
                         f"devices, only {len(devices)} available")
    return tuple(tuple(devices[d * n_docs_shards:(d + 1) * n_docs_shards])
                 for d in range(n_data))


def _local_devices(devices) -> list:
    """torch.devices of `devices`, or of every visible card (raises when
    there is none: nothing falls back to the CPU)."""
    import torch

    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=['cpu'] * n "
                           "to shard over the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_docs_shards: Optional[int] = None, n_data: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, docs) mesh of this process over `devices` (None: every
    visible card), the first `n_data * n_docs_shards` of them row by row;
    `n_docs_shards` None takes as many columns as the devices allow.
    Raises ValueError when there are too few. A mesh over the processes
    of a group is `make_mesh_global`'s."""
    return Mesh(_grid(_local_devices(devices), n_docs_shards, n_data,
                      "mesh"))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> bool:
    """`torch.distributed.init_process_group` when a group is configured:
    the arguments first, then the environment (`MASTER_ADDR` /
    `MASTER_PORT`, `WORLD_SIZE`, `RANK`). `coordinator_address` is
    "host:port" (or "tcp://host:port"). The backend is NCCL for the card
    (`device` None or "cuda") and gloo for `device="cpu"`, unless
    `backend` names one; without CUDA the card's backend raises rather
    than turning into gloo. Returns True for a group of more than one
    process, False for a group of one or when nothing is configured."""
    import torch.distributed as dist

    from ..device import resolve_device

    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    nproc = num_processes if num_processes is not None else (
        int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    rank = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else None)
    if addr is None and nproc is None:
        return False
    if addr is None or nproc is None or rank is None:
        raise ValueError("init_distributed needs an address, a number of "
                         "processes and a rank (arguments or MASTER_ADDR / "
                         "MASTER_PORT / WORLD_SIZE / RANK)")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(backend=backend, init_method=addr,
                            world_size=nproc, rank=rank)
    return dist.get_world_size() > 1


def make_mesh_global(n_docs_shards: Optional[int] = None, n_data: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """A (data, docs) mesh over the devices of every process of the group
    (after `init_distributed`; every process calls it with the same
    arguments). `devices` are this process's own (None: its visible
    cards). The global list is rank-major, so along the docs axis each
    process's devices sit next to each other and the merge crosses
    processes once per process."""
    import torch
    import torch.distributed as dist

    local = [str(d) for d in _local_devices(devices)]
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, local)
    flat = [(r, torch.device(d)) for r, ds in enumerate(lists) for d in ds]
    cells = _grid(flat, n_docs_shards, n_data, "global mesh")
    return Mesh(tuple(tuple(dev for _, dev in row) for row in cells),
                tuple(tuple(r for r, _ in row) for row in cells))
