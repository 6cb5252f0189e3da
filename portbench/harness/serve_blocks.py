"""The block-serving kind (traffic ``"kind": "serve_blocks"``): one client
in a closed loop sending fixed-shape requests of ``blocks_per_request``
blocks of ``points_per_block`` points through ``Predictor.__call__``.

Set-up draws the weights from the seed (harness/weights.py) and hands them
to ``Predictor(variables=...)``; then it makes a pool of
``pool_requests`` requests from the blocks that the configuration's data
kind makes from the seed (``inputs/<kind>.py``). The requests are cycled;
every request has the same shape whatever the seed, and no input is made
inside the window. Every pool request runs once before the window.

Each request is timed from the call to its numpy logits in hand; the
window runs requests back to back until ``seconds`` have passed.
``served_points_per_s``: the points of every request of the window over
the window; ``request_p95_ms``: the 95th percentile of all of them.
``sampled_requests`` of the window's requests, drawn from the seed
(reservoir sampling), are kept, and after the window, with the predictor
freed, the reference scores the same blocks (configs/<config>.ref.py, in
chunks of ``reference_chunk`` blocks) and the check compares the logits
(harness/check.py).

With ``trace`` the window runs as well, then ``trace_requests`` more
requests run under the profiler, each inside a ``portbench.request`` span.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np

from portbench.harness import check, counts, device as devmod, spec, weights
from portbench.harness.profile import Traced, top, traced_launches

REFERENCE_CHUNK = 8


def make_pool(cfg: dict, mix: dict, seed: int) -> list[np.ndarray]:
    """``pool_requests`` requests of ``blocks_per_request`` blocks of
    ``points_per_block`` points, from the configuration's data kind
    (``inputs/<kind>.py`` ``blocks``)."""
    per, n = mix["blocks_per_request"], mix["pool_requests"]
    arr = spec.inputs(cfg["data"]["kind"]).blocks(
        cfg, per * n, mix["points_per_block"], seed)
    return [np.ascontiguousarray(arr[i * per:(i + 1) * per])
            for i in range(n)]


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, clock: devmod.Clock, device_name: str = "cuda",
        plant: str | None = None) -> dict:
    import torch

    from pointnet2_tpu_torch import config as pconfig
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.serving import Predictor

    spec.plant(plant)
    dev = torch.device(device_name)
    cuda = dev.type == "cuda"
    pconfig.set_fused_mlp(cfg["fused_mlp"])
    w = weights.make(torch, cfg, seed, dev)
    pred = Predictor(cfg["model"], variables=w, dtype=getattr(
        torch, cfg["dtype"]), device=dev, num_classes=cfg["num_classes"])
    pool = make_pool(cfg, mix, seed)
    for req in pool:
        pred(req)
    if cuda:
        torch.cuda.synchronize(dev)
    rng = np.random.default_rng(seed)
    keep_n = mix["sampled_requests"]
    kept: list[tuple[int, np.ndarray]] = []

    setup_s = clock.now()
    lat, i, t0 = [], 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        req = pool[i % len(pool)]
        t = time.perf_counter()
        out = pred(req)
        lat.append(time.perf_counter() - t)
        if len(kept) < keep_n:
            kept.append((i % len(pool), out))
        else:
            j = int(rng.integers(i + 1))
            if j < keep_n:
                kept[j] = (i % len(pool), out)
        i += 1
    window_s = time.perf_counter() - t0
    points = i * mix["blocks_per_request"] * mix["points_per_block"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    summary = launch_check = None
    if trace:
        before = {k: f.launches for k, f in ops.KERNELS.items()}
        with Traced(torch) as traced:
            for r in range(mix["trace_requests"]):
                with torch.profiler.record_function("portbench.request"):
                    pred(pool[r % len(pool)])
        summary = traced.summary
        summary["requests"] = mix["trace_requests"]
        launched = {k: f.launches - before[k] for k, f in ops.KERNELS.items()}
        launch_check = {k: [traced_launches(summary, k), n]
                        for k, n in launched.items() if n}
    run_ns = types.SimpleNamespace(
        torch=torch, cfg=cfg, mix=mix, cell=cell, device=dev, trace=summary,
        window_s=window_s, requests=i, counts=counts,
        ref=spec.reference(cfg["name"]),
        fps_input=torch.from_numpy(pool[0]).to(dev) if trace else None)
    per_layer = spec.read_per_layer(cell, run_ns) if trace else {}
    del pred, run_ns
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(torch, cfg, w, pool, kept, dev)
    correct, checks = check.verdict(numbers, spec.limits(cell["name"]))
    return {
        "end_to_end": {
            "served_points_per_s": points / window_s if i else None,
            "request_p95_ms": float(np.percentile(lat, 95)) * 1e3
            if lat else None,
            "setup_s": setup_s},
        "per_layer": per_layer,
        "attempted": i, "failed": 0, "memory_peak_bytes": peak,
        "busy_s": summary["busy_s"] if trace else None,
        "window_s": summary["window_s"] if trace else None,
        "breakdown": ({"device_ops": top(summary["device_s_by_name"]),
                       "idle_gaps": top(summary["gaps_s"])}
                      if trace else None),
        "launch_check": launch_check,
        "banned": devmod.banned_modules(),
        "correct": correct, "checks": checks,
        "window": {"requests": i, "window_s": window_s,
                   "p50_ms": float(np.percentile(lat, 50)) * 1e3
                   if lat else None},
    }


def reference_logits(torch, cfg: dict, w: dict, blocks: np.ndarray, dev,
                     linear=None) -> torch.Tensor:
    """The reference's float32 logits of (B, N, 3) blocks, in chunks."""
    from portbench.reference.model import Ctx

    ref_mod = spec.reference(cfg["name"])
    ctx = Ctx(train=False, eps=cfg["bn_epsilon"])
    if linear is not None:
        ctx.linear = linear
    p = {k: v.to(dev, torch.float32) for k, v in w.items()}
    outs = []
    with torch.no_grad():
        for s in range(0, len(blocks), REFERENCE_CHUNK):
            x = torch.from_numpy(blocks[s:s + REFERENCE_CHUNK]).to(dev)
            outs.append(ref_mod.forward(ctx, p, cfg, x))
    return torch.cat(outs)


def compare(torch, cfg: dict, w: dict, pool: list, kept: list,
            dev) -> dict:
    """The check's numbers over the kept (pool index, logits) requests: the
    largest of each."""
    numbers: dict[str, float] = {}
    for idx, out in kept:
        ref = reference_logits(torch, cfg, w, pool[idx], dev)
        got = check.serve_numbers(torch, torch.from_numpy(out).to(dev), ref)
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, v), v)
        del ref
    return numbers


def calibrate(cell: dict, cfg: dict, mix: dict, seeds: list, controls: int,
              plant: str | None = None) -> list:
    """calibrate.py's rows: for each seed the program's numbers over
    ``sampled_requests`` requests of its pool, and for the first
    ``controls`` seeds the control's (the reference with its dense
    products in float8 in the program's place)."""
    import json

    import torch

    from pointnet2_tpu_torch import config as pconfig
    from pointnet2_tpu_torch.serving import Predictor

    from portbench.reference.model import fp8

    spec.plant(plant)
    dev = torch.device("cuda")
    pconfig.set_fused_mlp(cfg["fused_mlp"])
    mix = dict(mix, pool_requests=mix["sampled_requests"])
    rows = []
    for n, seed in enumerate(seeds):
        w = weights.make(torch, cfg, seed, dev)
        pred = Predictor(cfg["model"], variables=w,
                         dtype=getattr(torch, cfg["dtype"]), device=dev,
                         num_classes=cfg["num_classes"])
        pool = make_pool(cfg, mix, seed)
        kept = [(i, pred(req)) for i, req in enumerate(pool)]
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "program": compare(torch, cfg, w, pool, kept,
                                                dev)}
        if n < controls:
            ctrl = [(i, reference_logits(torch, cfg, w, req, dev,
                                         linear=fp8).cpu().numpy())
                    for i, req in enumerate(pool)]
            row["control"] = compare(torch, cfg, w, pool, ctrl, dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows
