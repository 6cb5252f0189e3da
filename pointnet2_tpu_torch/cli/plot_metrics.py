"""Learning-curve plots from a run directory's metrics.jsonl.

Port of pointnet2_tpu/cli/plot_metrics.py. ``load_metrics`` is plain json;
``plot_runs`` imports matplotlib at the call, so a machine without it
(the card's) can still load the curves. It closes the reference's
live-scalar visualization gap (train.py:118,125-131 writes TensorBoard
FileWriters for loss/accuracy/lr/bn_decay): the Trainer logs the same
scalars to metrics.jsonl (pointnet2_tpu_torch/train/trainer.py), and this
tool renders them to a PNG grid, one panel per metric, one line per split
(and per run dir when several are given, for A/B comparison).

Usage:
  python -m pointnet2_tpu_torch.cli.plot_metrics runs/procmn40_ssg_bf16
  python -m pointnet2_tpu_torch.cli.plot_metrics run_a run_b --out compare.png
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

# metadata columns, never plotted; everything else numeric is a metric
_NON_METRICS = {"epoch", "step", "split"}


def load_metrics(run_dir: str) -> dict[tuple[str, str], list[tuple[float, float]]]:
    """{(split, metric): [(epoch, value), ...]} from metrics.jsonl."""
    path = os.path.join(run_dir, "metrics.jsonl")
    series: dict[tuple[str, str], list[tuple[float, float]]] = defaultdict(list)
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from a killed run
            split = row.get("split", "train")
            epoch = row.get("epoch")
            if epoch is None:
                continue
            for key, val in row.items():
                if key in _NON_METRICS or not isinstance(val, (int, float)):
                    continue
                series[(split, key)].append((float(epoch), float(val)))
    return dict(series)


def plot_runs(run_dirs: list[str], out: str, title: str | None = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = [os.path.basename(os.path.normpath(d)) or d for d in run_dirs]
    if len(set(names)) != len(names):
        # same basename (e.g. runs/a/exp vs runs/b/exp): keep full paths
        names = [os.path.normpath(d) for d in run_dirs]
    runs = {name: load_metrics(d) for name, d in zip(names, run_dirs)}
    metrics = sorted({m for s in runs.values() for (_, m) in s})
    if not metrics:
        raise SystemExit("no plottable metrics found")

    ncols = min(3, len(metrics))
    nrows = -(-len(metrics) // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(5.2 * ncols, 3.6 * nrows),
                             squeeze=False)
    for i, metric in enumerate(metrics):
        ax = axes[i // ncols][i % ncols]
        for run_name, series in runs.items():
            for (split, m), points in sorted(series.items()):
                if m != metric:
                    continue
                points = sorted(points)
                label = split if len(runs) == 1 else f"{run_name}:{split}"
                ax.plot([p[0] for p in points], [p[1] for p in points],
                        label=label, linewidth=1.2)
        ax.set_title(metric)
        ax.set_xlabel("epoch")
        ax.grid(True, alpha=0.3)
        if metric in ("learning_rate",):
            ax.set_yscale("log")
        ax.legend(fontsize=7)
    for j in range(len(metrics), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.suptitle(title or ", ".join(runs))
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dirs", nargs="+",
                   help="run directories containing metrics.jsonl")
    p.add_argument("--out", default=None,
                   help="output PNG (default: <first run dir>/curves.png)")
    p.add_argument("--title", default=None)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    out = args.out or os.path.join(args.run_dirs[0], "curves.png")
    path = plot_runs(args.run_dirs, out, title=args.title)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
