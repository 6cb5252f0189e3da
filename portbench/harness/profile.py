"""The traced window: ``torch.profiler`` over a block of the cell's work,
reduced to what the per-layer readers take.

The profiler runs one warm-up step first (a one-element kernel, discarded:
a process's first profiler window can lose its first kernels), then
records the block, which ends in a synchronise. The Chrome trace is
written to ``TMPDIR``, read, and deleted. From it:

- ``window_s``: the recorded step, on the trace's host clock;
- ``busy_s``: the union of the card's kernel, copy and memset intervals
  inside the window; the rest is idle;
- device time by kernel name, the device-to-host copies, the NCCL kernels;
- ``gaps``: each idle stretch of the card, named by the innermost host
  operation (or benchmark span) running on the launching thread at its
  middle;
- the trace's launches of the port's kernels, to hold against the
  wrappers' counters.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_US = 20.0


class Traced:
    """``with Traced(torch) as t: <block>``; afterwards ``t.summary``."""

    def __init__(self, torch):
        self.torch = torch
        self.summary: dict | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        torch = self.torch
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.__enter__()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.prof.step()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self.t0
        self.prof.step()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = summarize(events)
        del self.prof
        return False


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host):
    """Sorted (start, end, name) segments of the innermost host event at
    each instant, from properly nested events."""
    segs, stack, t = [], [], None
    for s, e, name in sorted(host, key=lambda ev: (ev[0], -ev[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            if top[1] > t:
                segs.append((t, top[1], top[2]))
                t = top[1]
        if stack and s > t:
            segs.append((t, s, stack[-1][2]))
        if stack:
            e = min(e, stack[-1][1])
        stack.append((s, e, name))
        t = s
    while stack:
        top = stack.pop()
        if top[1] > t:
            segs.append((t, top[1], top[2]))
            t = top[1]
    return segs


def summarize(events: list) -> dict:
    steps = [e for e in events if e.get("name", "").startswith(
        "ProfilerStep") and "dur" in e]
    if not steps:
        raise RuntimeError("the trace has no recorded profiler step")
    step = max(steps, key=lambda e: e["ts"])
    w0, w1 = step["ts"], step["ts"] + step["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    busy = _union([(s, e) for s, e in clipped if e > s])
    by_name = defaultdict(float)
    dtoh = nccl = 0.0
    for e in dev:
        by_name[e["name"]] += e["dur"]
        if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]:
            dtoh += e["dur"]
        if "nccl" in e["name"].lower():
            nccl += e["dur"]
    # the launching thread: the one with the most CUDA runtime calls
    runtime = defaultdict(int)
    for e in events:
        if e.get("cat") == "cuda_runtime":
            runtime[e.get("tid")] += 1
    tid = max(runtime, key=runtime.get) if runtime else None
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("tid") == tid and "dur" in e
            and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
            and not e["name"].startswith("ProfilerStep")]
    segs = _innermost(host)
    starts = [s[0] for s in segs]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            gaps["_gaps_under_20_us_"] += b - a
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = (segs[i][2] if i >= 0 and segs[i][1] > mid
                else "_no_host_op_")
        gaps[name] += b - a
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_s_by_name": {k: v * 1e-6 for k, v in by_name.items()},
        "dtoh_s": dtoh * 1e-6,
        "nccl_s": nccl * 1e-6,
        "gaps_s": {k: v * 1e-6 for k, v in gaps.items()},
        "kernel_names": [e["name"] for e in dev if e["cat"] == "kernel"],
    }


# kernels a wrapper of the port's ``ops.KERNELS`` launches, by the names
# the trace gives them (rows 2 and 3 are two instances of one template)
TRACE_NAMES = {"ball_query": ("ball_query_kernel<false>",),
               "ball_query_group_xyz": ("ball_query_kernel<true>",),
               "fps": ("fps_kernel", "fps_cluster_kernel")}


def traced_launches(summary: dict, wrapper: str) -> int:
    names = TRACE_NAMES.get(wrapper, (f"{wrapper}_kernel",
                                      f"{wrapper}_mma_kernel"))
    return sum(1 for k in summary["kernel_names"]
               if any(n in k for n in names))


def top(mapping: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(mapping.items(), key=lambda kv: -kv[1])
            [:n]]
