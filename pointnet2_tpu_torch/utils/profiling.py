"""Profiling and timing utilities of the port.

Port of pointnet2_tpu/utils/profiling.py (the reference has no tracing
beyond ad-hoc time.time() loops, tf_ops/grouping/tf_grouping.py:98-101):

- :func:`trace`: ``torch.profiler`` around a block, writing a Chrome trace
  (``trace.json``, loadable in Perfetto or chrome://tracing) with the
  device's kernels when a card is present;
- :class:`StepTimer`: rolling per-step wall-time stats for train loops;
- :func:`time_fn`: median wall time of a call, fenced by
  ``torch.cuda.synchronize`` when the result is on the card;
- :func:`time_op_loop`: the per-iteration device time of back-to-back
  launches between CUDA events (wall time on the CPU);
- :func:`compiled_cost`: the flop count of a call, from
  ``torch.utils.flop_counter.FlopCounterMode``.

The peak rates name the card the port targets (H100 SXM, NVIDIA data
sheet): the figures ``PERF.md`` uses for its bounds.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch

# H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor cores,
# TFLOP/s, and HBM3, TB/s. The single source for utilization figures.
H100_BF16_TFLOPS = 989.0
H100_HBM_TBPS = 3.35


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write ``<logdir>/trace.json``, a Chrome
    trace. Yields the profiler (``key_averages()`` and the rest).

    On the card a profiler window can lose its first kernels, so one
    warm-up step (a one-element kernel) runs inside the profiler's
    schedule and is discarded before the block is recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.step()  # the warm-up step ends, the recorded one begins
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
            prof.step()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling window of step durations -> steps/sec, examples/sec."""

    def __init__(self, window: int = 50):
        self._times = deque(maxlen=window)
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def steps_per_sec(self) -> float:
        m = self.mean_step_time
        return 1.0 / m if m > 0 else 0.0


def _on_card(out) -> bool:
    """Whether any tensor in ``out`` (a tensor, or nested tuples, lists
    and dicts of them) lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_card(o) for o in out)
    return False


def _fence(out) -> None:
    """Wait for the work behind ``out`` when it lies on the card."""
    if _on_card(out):
        torch.cuda.synchronize()


def time_fn(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall time in seconds per call of fn(*args), each call fenced
    by ``torch.cuda.synchronize`` when its result is on the card. Includes
    the host's launch overhead; for a kernel's own time use
    :func:`time_op_loop`."""
    for _ in range(warmup):
        _fence(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def compiled_cost(fn, *args, **kwargs) -> dict | None:
    """{"flops": n} of one call fn(*args, **kwargs), counted by
    ``FlopCounterMode`` (matrix products and convolutions, the operators it
    knows), or None where it counted nothing. The call runs once, and its
    exceptions reach the caller. The port's hand-written kernels are
    launched through ctypes, outside PyTorch's dispatcher, so their work
    is not counted, and no bytes are counted: the JAX package's XLA cost
    model has no counterpart here."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return {"flops": flops} if flops > 0 else None


def time_op_loop(op, x, iters: int = 50, warmup: bool = True,
                 repeats: int = 3) -> float:
    """Per-iteration time in seconds of ``op(x)``: ``iters`` back-to-back
    calls between two CUDA events on the current stream when ``x`` is on
    the card (the device time, launch gaps included where the host cannot
    keep up), host wall time on the CPU; the median of ``repeats`` such
    loops. The input is the same each iteration: a CUDA kernel caches no
    result."""
    cuda = x.is_cuda
    if warmup:
        op(x)
        _fence(x)
    measured = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                op(x)
            end.record()
            end.synchronize()
            measured.append(start.elapsed_time(end) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                op(x)
            measured.append((time.perf_counter() - t0) / iters)
    measured.sort()
    return measured[len(measured) // 2]
