#!/usr/bin/env python3
"""How many kernel launches ``torch.profiler`` records, in a fresh process
and in one that has run a while.

Each case runs in its own process (all but ``loaded`` started together,
``loaded`` alone after them; one card): a history, then profiler windows
(``torch.profiler.profile`` with one warm-up step, as
``utils.profiling.trace`` opens them) around PROBE launches of the row
gather at a small shape, each window counting the launches it recorded
as kernel events (``key_averages``). Windows are plain, padded (the host
sleeps PAD_S inside the window before and after the launches, the card
idle) or spread (PAD_S between launches). Cases:

- ``fresh``: no history;
- ``windows``: WINDOWS plain windows back to back (does a process that has
  opened many windows record fewer kernels?);
- ``aged``: AGE_S seconds of small launches without the profiler first
  (does a process that has run a while?);
- ``loaded``: AGE_S seconds of back-to-back bf16 matrix products (8192
  cubed) first (does a process that has kept the card busy?);
- ``graph``: a CUDA graph of the gathers captured and replayed, and
  ``torch.cuda.set_sync_debug_mode("error")`` set and put back first;
- ``child``: a child process that uses the card runs to its end first.

Prints one JSON object a case: {"case", "windows": [[kind, recorded],
...], "seconds"} and, with ``--out``, writes them all to a file.

Usage, from the repository root, on one CUDA card (every case, or one):

    python3 pointnet2_tpu_torch/tools/profiler_probe.py [--out FILE.json]
    python3 pointnet2_tpu_torch/tools/profiler_probe.py --case loaded
"""

import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROBE = 10  # launches a window
PAD_S = 0.05
WINDOWS = 60
AGE_S = 240.0
CASES = ("fresh", "windows", "aged", "graph", "child")
LOADED = "loaded"  # run alone, after CASES


def window(torch, fn, kind: str) -> int:
    """One profiler window around PROBE calls of ``fn``; the launches it
    recorded as ``gather_rows_kernel`` events."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        if kind == "padded":
            time.sleep(PAD_S)
        for _ in range(PROBE):
            fn()
            if kind == "spread":
                torch.cuda.synchronize()
                time.sleep(PAD_S / PROBE)
        torch.cuda.synchronize()
        if kind == "padded":
            time.sleep(PAD_S)
        prof.step()
    return sum(e.count for e in prof.key_averages()
               if "gather_rows_kernel" in e.key)


def run_case(case: str) -> dict:
    import torch

    sys.path.insert(0, _ROOT)
    from pointnet2_tpu_torch.ops import grouping

    pts = torch.ones((2, 64, 8), device="cuda")
    ix = torch.zeros((2, 16), dtype=torch.int32, device="cuda")

    def fn():
        grouping.gather_rows_kernel(pts, ix)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    if case == "windows":
        out += [["plain", window(torch, fn, "plain")]
                for _ in range(WINDOWS)]
    elif case == "aged":
        while time.perf_counter() - t0 < AGE_S:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
    elif case == LOADED:
        a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
        while time.perf_counter() - t0 < AGE_S:
            for _ in range(20):
                b = a @ a
            torch.cuda.synchronize()
        del b
    elif case == "graph":
        torch.cuda.set_sync_debug_mode("error")
        torch.cuda.set_sync_debug_mode("default")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(PROBE):
                fn()
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
    elif case == "child":
        subprocess.run([sys.executable, "-c",
                        "import torch; x = torch.ones(1000, device='cuda');"
                        " [x.add_(1) for _ in range(1000)];"
                        " torch.cuda.synchronize()"], check=True)
    for kind in ("plain", "padded", "spread", "plain"):
        out.append([kind, window(torch, fn, kind)])
    return {"case": case, "windows": out,
            "seconds": round(time.perf_counter() - t0, 1)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--case"]:
        print(json.dumps(run_case(argv[1])), flush=True)
        return 0
    results = []
    for wave in (CASES, (LOADED,)):
        procs = {c: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--case", c],
            stdout=subprocess.PIPE, text=True) for c in wave}
        for c, p in procs.items():
            out, _ = p.communicate()
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            results.append(json.loads(lines[-1])
                           if p.returncode == 0 and lines
                           else {"case": c, "rc": p.returncode})
            print(json.dumps(results[-1]), flush=True)
    if argv[:1] == ["--out"]:
        with open(argv[1], "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all("windows" in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
