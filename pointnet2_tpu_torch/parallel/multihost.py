"""The single-process form of the multi-host helpers.

The part of pointnet2_tpu/parallel/multihost.py that the evaluation
protocols and the checkpoints call: ``is_primary``, ``process_count``,
``sync_num_batches``, ``allreduce_sum`` and ``barrier``. With one process
each is what JAX's is on one process (true, 1, the local count, the array
itself, nothing). The multi-process form over ``torch.distributed`` is not
ported yet (ROADMAP.md Queue 1 item 6): when ``torch.distributed`` is
initialised with more than one rank, every function raises instead of
acting as if it were alone.
"""

from __future__ import annotations

import torch.distributed as dist


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _single(what: str) -> None:
    n = _world_size()
    if n > 1:
        raise NotImplementedError(
            f"multihost.{what} with {n} ranks: the multi-process form is not "
            "ported yet (ROADMAP.md Queue 1 item 6, scale-out)")


def process_count() -> int:
    _single("process_count")
    return 1


def is_primary() -> bool:
    """True on the process that owns shared side effects (checkpoint
    writes, logs)."""
    _single("is_primary")
    return True


def sync_num_batches(local_num_batches: int, reduce: str = "min") -> int:
    """The batch count every process agrees on; one process keeps its
    own."""
    _single("sync_num_batches")
    if reduce not in ("min", "max"):
        raise ValueError(f"reduce must be 'min' or 'max', got {reduce!r}")
    return local_num_batches


def allreduce_sum(x):
    """Sum a host array over the processes; one process returns it."""
    _single("allreduce_sum")
    return x


def barrier(name: str) -> None:
    """Wait for every process; nothing to wait for with one."""
    _single("barrier")
