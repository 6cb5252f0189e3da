"""Visualization CLI of the port: render clouds and model predictions to
PNG.

Port of pointnet2_tpu/cli/visualize.py (headless counterpart of the
reference's interactive viewers, part_seg/test.py:71-85,
utils/show3d_balls.py): renders point clouds with the native C++ ball
rasterizer (viz/viewer.py), colored by the predicted part or class labels
when a model is given, and writes PNGs, plus the canonical three-view gray
image of pc_util for a cloud file. The model runs on the card unless
``--device cpu``; its checkpoint is restored when one is found in
``--log_dir`` (else the predictions are the untrained model's, as in the
JAX package). The PNGs are written by the standard library
(utils/png.py), where the JAX package uses PIL.

Usage:
  # part-seg predictions of a checkpoint on the synthetic set
  python -m pointnet2_tpu_torch.cli.visualize \\
      --model pointnet2_part_seg_msg_one_hot --synthetic --log_dir log \\
      --out viz_out
  # just render a cloud file (ply or txt) without a model
  python -m pointnet2_tpu_torch.cli.visualize --cloud path/to/cloud.ply \\
      --out viz_out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pointnet2_tpu_torch.models import MODEL_REGISTRY
from pointnet2_tpu_torch.utils.png import write_png

_PALETTE = None


def _palette(n: int) -> np.ndarray:
    global _PALETTE
    if _PALETTE is None or len(_PALETTE) < n:
        rng = np.random.default_rng(7)
        _PALETTE = (rng.random((max(n, 64), 3)) * 205 + 50).astype(np.uint8)
    return _PALETTE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default=None, choices=sorted(MODEL_REGISTRY))
    p.add_argument("--cloud", default=None, help="ply/txt cloud to render")
    p.add_argument("--data", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=2)
    p.add_argument("--normal", action="store_true")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--ckpt", default="ckpt")
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--out", default="viz_out")
    p.add_argument("--canvas", type=int, default=800)
    p.add_argument("--ballradius", type=int, default=6)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--model_kwargs", type=str, default=None,
                   help="JSON dict of model overrides; must match the "
                        "trained config for checkpoint restore")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the plain PyTorch "
                        "versions of the kernels)")
    return p


def read_cloud(path: str) -> np.ndarray:
    """A cloud file's points: PLY, comma-separated txt
    (modelnet40_normal_resampled) or whitespace txt (ShapeNet-part)."""
    from pointnet2_tpu_torch.utils import pc_util

    if path.endswith(".ply"):
        return pc_util.read_ply(path)
    try:
        return np.loadtxt(path, delimiter=",")[:, :3]
    except ValueError:
        return np.loadtxt(path)[:, :3]


def main(argv=None) -> list[str]:
    """Render and write the PNGs; returns their paths."""
    from pointnet2_tpu_torch.utils import pc_util
    from pointnet2_tpu_torch.viz import render

    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    written = []

    def save(image, name):
        written.append(write_png(image, os.path.join(args.out, name)))

    if args.cloud is not None:
        pts = read_cloud(args.cloud)
        save(render(pts, canvas=args.canvas, ballradius=args.ballradius),
             "cloud.png")
        save(pc_util.point_cloud_three_views(pts[:, :3]),
             "cloud_three_views.png")
        print(f"wrote {args.out}/cloud.png")
        return written

    if args.model is None:
        raise SystemExit("need --model (with optional checkpoint) or --cloud")

    from pointnet2_tpu_torch.cli.train import make_datasets, parse_model_kwargs
    from pointnet2_tpu_torch.train import TrainConfig, Trainer
    from pointnet2_tpu_torch.train import checkpoint as ckpt

    task = MODEL_REGISTRY[args.model].task
    _, test_ds, _ = make_datasets(args, test_only=True)
    config = TrainConfig(model=args.model, num_point=args.num_point,
                         batch_size=args.batch_size, log_dir=args.log_dir,
                         model_kwargs=parse_model_kwargs(args, task))
    with Trainer(config, device=args.device) as trainer:
        state = trainer.init_state()
        if ckpt.latest_step(args.log_dir, args.ckpt) is not None:
            state = ckpt.restore_checkpoint(args.log_dir, state,
                                            name=args.ckpt)
            trainer.log(f"restored {args.ckpt} at step {state.step}")
        else:
            trainer.log("no checkpoint found; rendering untrained "
                        "predictions")
        batch = next(iter(test_ds.epoch()))
        logits = trainer.eval_logits_fn(state)(batch)
    n = min(args.num_samples, batch["nvalid"])
    for i in range(n):
        pts = batch["points"][i, :, :3]
        if task == "cls":
            pred = int(logits[i].argmax())
            colors = None
            name = f"sample{i}_pred{pred}.png"
        else:
            pred = logits[i].argmax(-1)
            colors = _palette(int(pred.max()) + 1)[pred]
            name = f"sample{i}_seg.png"
            truth = batch["seg"][i]
            save(render(pts, _palette(int(truth.max()) + 1)[truth],
                        canvas=args.canvas, ballradius=args.ballradius),
                 f"sample{i}_gt.png")
        save(render(pts, colors, canvas=args.canvas,
                    ballradius=args.ballradius), name)
        print(f"wrote {args.out}/{name}")
    return written


if __name__ == "__main__":
    main()
