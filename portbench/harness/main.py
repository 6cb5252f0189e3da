"""One run of one cell: ``python3 portbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``.

Prints the run's numbers on standard error, then, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit. Exits non-zero and
prints no result when the cell's cards are missing, when a run holds a
module of JAX or of the JAX package, or when anything fails.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.harness import device as devmod, spec


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell: dict, bench: dict, res: dict, trace: bool,
                dev: dict) -> dict:
    metrics = {}
    for m in spec.cell_metrics(bench, cell, trace):
        if trace:
            if m["name"] in res["per_layer"]:
                metrics[m["name"]] = res["per_layer"][m["name"]]
        elif res["end_to_end"].get(m["name"]) is not None:
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    device = dict(dev, memory_peak_bytes=res["memory_peak_bytes"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    clock = devmod.Clock()
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    res = spec.runner(mix["kind"]).run(cell, cfg, mix, args.seed,
                                       args.seconds, bool(args.trace), clock)
    banned = sorted(set(res["banned"]) | set(devmod.banned_modules()))
    if banned:
        print(f"portbench: the run loaded {', '.join(banned)}; a run of the "
              "port may load no JAX and nothing of the JAX package",
              file=sys.stderr)
        return 3
    dev = devmod.describe(torch, cell["chips"])
    line = result_line(cell, bench, res, bool(args.trace), dev)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "window": res["window"],
                      "launch_check": res["launch_check"],
                      "power": devmod.power_limit()}))
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
