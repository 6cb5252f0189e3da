"""Multi-process helpers over ``torch.distributed``.

Port of pointnet2_tpu/parallel/multihost.py:24-188. The JAX package runs
one process a host over an N-device mesh; the port runs one process a
rank, each with one device. These helpers act over every rank of the
default process group, and with no group initialised each gives the
one-process answer (true, 1, 0, the local count, the array itself,
nothing to wait for).

- :func:`initialize` joins this process to a group: from explicit
  arguments (strict: a failure raises), or from torchrun's ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (without them: one process, nothing to join).
- Host-side reductions (batch counts, metric counters, barriers) run on a
  gloo group (:func:`host_group`): the default group is NCCL on the card,
  and NCCL takes no CPU tensors.
- :func:`shard_bounds`, :func:`process_shard` and :func:`local_batch_size`
  say which rows of a data set and of a global batch a rank owns: a
  contiguous slice, the remainder to the last rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP: list = []  # the gloo group beside an NCCL default group
_LOCAL_RANK: list = []  # the local rank given to initialize


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               local_rank: int | None = None) -> None:
    """Join this process to the default process group and make the gloo
    group beside it.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the call is strict. ``num_processes`` counts ranks (one
    process a card), not hosts as JAX's does, and ``process_id`` is this
    rank's global index. Without them it reads torchrun's environment; with
    no ``WORLD_SIZE`` there this is one process and nothing is joined. An
    initialised group is kept. ``backend`` defaults to NCCL when the
    machine has a card, else gloo; on NCCL this rank's card is
    ``cuda:local_rank``: the argument, else torchrun's ``LOCAL_RANK``, else
    the global rank modulo the host's card count (every host the same
    count), which :func:`local_rank` answers from then on."""
    if local_rank is not None:
        _LOCAL_RANK[:] = [local_rank]
    if not _active():
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("initialize needs num_processes and "
                                 "process_id with a coordinator_address")
            init = f"tcp://{coordinator_address}"
            world, rank = num_processes, process_id
        elif "WORLD_SIZE" in os.environ:
            init, world, rank = "env://", None, None
        else:
            return
        backend = backend or ("nccl" if torch.cuda.is_available()
                              else "gloo")
        if "nccl" in backend:
            # no watchdog queries of events a CUDA graph captured
            # (PyTorch's notes on NCCL in CUDA graphs)
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
            torch.cuda.set_device(_local_rank(rank))
        kw = {} if world is None else {"world_size": world, "rank": rank}
        dist.init_process_group(backend, init_method=init, **kw)
    host_group()


def local_rank(rank: int | None = None) -> int:
    """This process's rank on its host: the one given to
    :func:`initialize`, else torchrun's ``LOCAL_RANK``, else the global
    rank (``rank``, or this process's) modulo the host's card count."""
    return _local_rank(rank)


def _local_rank(rank: int | None) -> int:
    if _LOCAL_RANK:
        return _LOCAL_RANK[0]
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def host_group():
    """The group for host-side reductions: the default group when it is
    gloo, else a gloo group made beside it (once, the first time every rank
    asks). None without a group."""
    if not _active():
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def is_primary() -> bool:
    """True on the process that owns shared side effects (checkpoint
    writes, logs): rank 0."""
    return process_index() == 0


def sync_num_batches(local_num_batches: int, reduce: str = "min") -> int:
    """The batch count every process agrees on: the least ("min", train
    epochs skip the surplus tail of the remainder rank) or the most ("max",
    evaluation pads the short ranks with zero batches). Every rank's step
    holds collectives, so the ranks must run the same number."""
    if reduce not in ("min", "max"):
        raise ValueError(f"reduce must be 'min' or 'max', got {reduce!r}")
    if process_count() == 1:
        return local_num_batches
    t = torch.tensor([local_num_batches], dtype=torch.int64)
    op = dist.ReduceOp.MIN if reduce == "min" else dist.ReduceOp.MAX
    dist.all_reduce(t, op=op, group=host_group())
    return int(t[0])


def allreduce_sum(x):
    """Sum a host array over the processes (numpy in, numpy out, its dtype
    kept); one process returns it."""
    if process_count() == 1:
        return x
    arr = np.asarray(x)
    t = torch.from_numpy(np.array(arr, copy=True))
    dist.all_reduce(t, group=host_group())
    return t.numpy().astype(arr.dtype, copy=False)


def barrier(name: str) -> None:
    """Block until every process reaches this point (nothing on one).
    ``name`` says which point, for a reader of a hang."""
    del name
    if process_count() > 1:
        dist.barrier(group=host_group())


def to_local_numpy(x) -> np.ndarray:
    """This rank's output as numpy: each rank's output is already its own
    shard of the batch (JAX fetches a process's shard of a global array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def shard_bounds(num_items: int, rank: int, count: int) -> tuple[int, int]:
    """(start, stop) of ``rank``'s contiguous shard; the remainder goes to
    the last rank. The one sharding policy: data sets slice with it so
    every rank agrees on shard sizes."""
    per = num_items // count
    start = rank * per
    stop = start + per if rank < count - 1 else num_items
    return start, stop


def process_shard(num_items: int) -> tuple[int, int]:
    """(start, stop) of this process's contiguous shard of a data set."""
    return shard_bounds(num_items, process_index(), process_count())


def local_batch_size(global_batch: int) -> int:
    count = process_count()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} not divisible by {count} hosts")
    return global_batch // count
