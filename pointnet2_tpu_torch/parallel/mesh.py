"""The data-parallel layout of the port: one process a rank, one device a
rank.

Counterpart of pointnet2_tpu/parallel/mesh.py:20-59. The JAX package runs
one program over a 1-D ``data`` mesh of N devices; the port runs N
processes of ``torch.distributed``, and :class:`Mesh` is what one of them
knows of the rest: the rank count, its rank, its device, the group of its
device-side collectives (the default group: NCCL on the card, gloo on the
CPU) and the gloo group of its host-side ones.

A global host batch of B rows is cut into N contiguous shards of B/N rows,
rank r's being rows [r*B/N, (r+1)*B/N) (:func:`shard_batch`), as JAX's
``P("data")`` sharding lays them out. With ``host_sharded`` each rank's
data set already yields its own rows (``process_shard``, ``--multihost``)
and nothing is cut. Without a process group the mesh is one rank with no
collectives, and everything here is the single-process code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.parallel import multihost

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    size: int  # ranks
    rank: int
    device: torch.device
    group: object | None  # device collectives; None: one process, none
    host_group: object | None  # gloo, for CPU tensors
    host_sharded: bool = False  # each rank's data set yields its own rows

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The average of ``t`` over the ranks (outside autograd): one
        all-reduce sum, then one division by the rank count."""
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out.div_(self.size)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (outside autograd)."""
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def rows(self, b: int) -> tuple[int, int]:
        """(this rank's first row, the global row count) of a batch whose
        every rank holds ``b`` rows."""
        return self.rank * b, self.size * b


def collective(mesh: Mesh | None) -> Mesh | None:
    """The mesh whose collectives a step runs: None without one, or for a
    mesh of one process without a process group."""
    return mesh if mesh is not None and mesh.group is not None else None


def make_mesh(num_devices: int | None = None, device="cuda", *,
              host_sharded: bool = False) -> Mesh:
    """The mesh of this process. Without a process group: one rank on
    ``device`` (``num_devices`` must be None or 1). With one: every rank of
    it (``num_devices`` must be None or its size), on ``device``; a bare
    ``"cuda"`` is this rank's card, ``cuda:multihost.local_rank()`` (the
    global rank modulo the host's cards without ``LOCAL_RANK``), and a
    local rank past the host's cards raises. An explicit ``cuda:i`` is kept:
    ranks that share a card must talk over gloo (NCCL refuses two ranks on
    one GPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        if num_devices not in (None, 1):
            raise ValueError(
                f"num_devices={num_devices} needs a process group of "
                f"{num_devices} ranks: start them with "
                "parallel.launch.spawn, or torchrun and "
                "multihost.initialize()")
        return Mesh(1, 0, config.check_device(device), None, None)
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices}, but the process "
                         f"group has {size} ranks")
    dev = config.check_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = multihost.local_rank(rank)
            if local >= torch.cuda.device_count():
                raise ValueError(
                    f"CUDA rank {local} on a host with "
                    f"{torch.cuda.device_count()} card(s): more CUDA ranks "
                    "than cards")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return Mesh(size, rank, dev, dist.group.WORLD, multihost.host_group(),
                host_sharded)


def local_rows(mesh: Mesh, batch: dict, axis: int = 0) -> dict:
    """A host batch cut to this rank's rows along ``axis`` (numpy in,
    numpy out); the batch itself with one rank or host-sharded data."""
    if mesh.size == 1 or mesh.host_sharded:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        B = v.shape[axis]
        if B % mesh.size:
            raise ValueError(f"global batch {B} not divisible by "
                             f"{mesh.size} ranks")
        b = B // mesh.size
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        out[k] = v[(slice(None),) * axis + (rows,)]
    return out


def shard_batch(mesh: Mesh, batch: dict, *, stacked: bool = False) -> dict:
    """Upload this rank's rows of a host batch (a dict of numpy arrays) to
    its device; with ``stacked`` the arrays carry a leading steps axis (K,
    B, ...) and the batch axis is axis 1."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in local_rows(mesh, batch, 1 if stacked else 0).items()}


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, in
    place, so that every rank starts from the same state."""
    if mesh.group is not None:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, 0, group=mesh.group)
    return module
