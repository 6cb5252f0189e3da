"""Readings the check's limits are set from, at a cell's own sizes (see
portbench/README.md):

    python3 portbench/calibrate.py --workload <name> --seeds <first> \
        --count 12 --controls 3 --out <file.json>

For each of ``count`` seeds from ``first`` on, the program's numbers
against the reference, as a run of the cell compares them, and for the
first ``controls`` seeds those of the control and of the faults its kind
reads: the cell's traffic kind decides how (``harness/<kind>.py``
``calibrate``). Writes one JSON row a seed, and prints each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, required=True)
    ap.add_argument("--count", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--plant", default=None,
                    help="module:function planting a fault first, in every "
                         "rank (portbench/tests/faults.py)")
    args = ap.parse_args(argv)
    from portbench.harness import spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    seeds = [args.seeds + i for i in range(args.count)]
    rows = spec.runner(mix["kind"]).calibrate(cell, cfg, mix, seeds,
                                               args.controls, args.plant)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [ROOT]
    sys.exit(main())
