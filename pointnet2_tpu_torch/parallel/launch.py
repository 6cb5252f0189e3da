"""Start N ranks of one job on this host.

The port's counterpart of the JAX package's one-process N-device mesh
(``--num_devices N``): :func:`spawn` starts N processes with the ``spawn``
start method, joins them into one ``torch.distributed`` group over a free
local port, runs ``fn(*args)`` in each, and waits. Rank r owns ``cuda:r``
(NCCL) or, on the CPU, a gloo rank with one intra-op thread. A rank that
exits with a non-zero code ends the job: the launcher kills the others
(which may wait in a collective for a peer that is gone) and returns that
code unchanged, so that the stall watchdog's 75 reaches ``cli.supervise``.
A rank that ends, well or not, leaves without tearing the process group
down (:func:`leave`).
"""

from __future__ import annotations

import os
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from multiprocessing.connection import wait

# intra-op threads of a CPU rank: several ranks share the host's cores
CPU_THREADS = 1
# the exit code of a job cut at its time limit, as timeout(1) gives
EXIT_TIMEOUT = 124


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, size: int, port: int, device: str,
               backend: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(CPU_THREADS)
    if "nccl" in backend:
        # no watchdog queries of events a CUDA graph captured (PyTorch's
        # notes on NCCL in CUDA graphs)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        torch.cuda.set_device(dev if dev.index is not None else rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=size, rank=rank)
    try:
        fn(*args)
    except SystemExit as e:  # a rank's exit code is the job's
        leave(e.code if isinstance(e.code, int) else 1, barrier=False)
    except BaseException:
        traceback.print_exc()
        leave(1, barrier=False)
    leave(0)


def leave(code: int = 0, barrier: bool = True) -> None:
    """End this rank's process with ``code``: after a barrier with every
    rank when ``barrier`` (a peer's last collective may still read this
    rank's buffers), and without tearing the process group down, which
    waits forever on an NCCL communicator that a CUDA graph captured
    (measured on four H100s), and, for a failed rank, on peers that wait
    in a collective for it."""
    if barrier:
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def spawn(fn, num_devices: int, *, device="cuda", backend: str | None = None,
          args: tuple = (), timeout: float | None = None) -> int:
    """Run ``fn(*args)`` on ``num_devices`` ranks and return 0, or the first
    non-zero exit code of a rank (the others are killed then), or
    EXIT_TIMEOUT when the ranks still run after ``timeout`` seconds (all
    are killed: a rank that waits in a collective forever ends the job).
    ``fn`` must be importable by name (a module-level function).
    ``backend`` defaults to NCCL on the card and gloo on the CPU; ranks
    that share one card (``device="cuda:0"``) need gloo."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is None \
            and num_devices > torch.cuda.device_count():
        raise ValueError(f"{num_devices} CUDA ranks on a host with "
                         f"{torch.cuda.device_count()} card(s)")
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, num_devices, port, str(device),
                               backend, tuple(args)))
             for r in range(num_devices)]
    for p in procs:
        p.start()
    rc = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    running = {p.sentinel: p for p in procs}
    try:
        # woken by each exit as it happens, so that the first failure is
        # the one reported, not a peer's that failed because of it
        while running and not rc:
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            ended = wait(list(running), left)
            if not ended:
                rc = EXIT_TIMEOUT
            for s in ended:
                p = running.pop(s)
                p.join()
                rc = rc or p.exitcode
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
    return rc
