"""Profiling and timing utilities of the port.

Port of pointnet2_tpu/utils/profiling.py (the reference has no tracing
beyond ad-hoc time.time() loops, tf_ops/grouping/tf_grouping.py:98-101):

- :func:`trace`: ``torch.profiler`` around a block, writing a Chrome trace
  (``trace.json``, loadable in Perfetto or chrome://tracing) with the
  device's kernels when a card is present;
- :func:`span`: the program's own spans (``Trainer``, ``TrainMultiStep``,
  ``Predictor``), recorded only while a torch profiler records: each
  lands in the Chrome trace as a ``user_annotation``, on the clock of the
  device's kernels, and in an in-memory record that :func:`spans` and
  :func:`span_stats` read;
- :func:`time_fn`: median wall time of a call, fenced by
  ``torch.cuda.synchronize`` when the result is on the card;
- :func:`time_op_loop`: the per-iteration device time of back-to-back
  launches between CUDA events (wall time on the CPU).

The peak rates name the card the port targets (H100 SXM, NVIDIA data
sheet): the figures ``PERF.md`` uses for its bounds.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

# H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor cores,
# TFLOP/s, and HBM3, TB/s. The single source for utilization figures.
H100_BF16_TFLOPS = 989.0
H100_HBM_TBPS = 3.35


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write ``<logdir>/trace.json``, a Chrome
    trace. Yields the profiler (``key_averages()`` and the rest). The
    span record (:func:`spans`) is cleared first, so it holds the block's
    spans alone.

    On the card a profiler window can lose its first kernels, so one
    warm-up step (a one-element kernel) runs inside the profiler's
    schedule and is discarded before the block is recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(logdir, exist_ok=True)
    clear_spans()
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


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the name of the span open around it
    on the same thread (None at the top); ``counts`` the counts it carried."""

    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    thread: int
    counts: dict


_RECORD: list[SpanRecord] = []
_OPEN = threading.local()  # .stack: the spans open on this thread
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The one context every span returns while no profiler records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "parent", "start", "fn")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def add(self, **counts) -> None:
        """Counts known only inside the span, summed into its own."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        _RECORD.append(SpanRecord(self.name, self.start, end, self.parent,
                                  threading.get_ident(), self.counts))
        self.fn.__exit__(*exc)
        return False


def span(name: str, **counts):
    """``with span("predictor.upload", rows=64) as s: ...``: a span of the
    program, and the counts of the work it did (``s.add(steps=5)`` adds
    counts known only inside it).

    While no torch profiler records it costs one flag read and returns a
    shared no-op context. While one records (:func:`trace`, or any
    ``torch.profiler.profile`` in its recorded step) the span enters
    ``record_function(name)``, so it lands in the Chrome trace beside the
    device's work, and its host times go into the record that
    :func:`spans` returns. It never synchronises the card."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, counts)


def spans() -> list[SpanRecord]:
    """Every span closed since the record was last cleared, in the order
    they closed."""
    return list(_RECORD)


def clear_spans() -> None:
    _RECORD.clear()


def span_stats() -> dict:
    """{name: {"count", "total_s", "self_s", "counts"}} over the record:
    how often the span ran, its summed duration, that less the part its
    child spans cover, and its summed counts."""
    record, out = spans(), {}
    for r in record:
        st = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                     "self_s": 0.0, "counts": {}})
        dur = (r.end_ns - r.start_ns) * 1e-9
        st["count"] += 1
        st["total_s"] += dur
        st["self_s"] += dur
        for k, v in r.counts.items():
            st["counts"][k] = st["counts"].get(k, 0) + v
    for r in record:
        if r.parent in out:
            out[r.parent]["self_s"] -= (r.end_ns - r.start_ns) * 1e-9
    return out



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
