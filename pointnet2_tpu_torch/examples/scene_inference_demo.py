"""Whole-scene semantic segmentation as a serving call.

Port of examples/scene_inference_demo.py. The reference can only segment
scenes inside its eval loop (scannet/train.py:326-427); here a trained
checkpoint becomes an endpoint and ``Predictor.predict_scene`` labels an
arbitrary-size scene through the fixed-shape bucketed path: 1.5 m tiling
with 0.2 m overlap, every member of every block scored, summed-logit
ensembling in the overlap bands. On the card each block batch runs the
port's FPS, ball query, gather and three-NN kernels.

Run:
  python -m pointnet2_tpu_torch.examples.scene_inference_demo \\
      --ckpt runs/procscannet_semseg_bf16 [--out scene_pred.png]
Without --ckpt the demo drives the same pipeline with random weights
(Xavier-uniform from a seed) and says so; train a model first
(pointnet2_tpu_torch/artifacts/ACCURACY.md, the ScanNet recipe) for real
labels. The room is the port's generated ScanNet stand-in
(``data.procedural_scannet.make_scene``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

MODEL = "pointnet2_sem_seg"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default=None,
                    help="run dir with a checkpoint (e.g. "
                         "runs/procscannet_semseg_bf16); omitted = random "
                         "weights, pipeline demo only")
    ap.add_argument("--ckpt_name", default="best")
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--min_points", type=int, default=80_000)
    ap.add_argument("--max_points", type=int, default=100_000)
    ap.add_argument("--npoints", type=int, default=8192,
                    help="points a block (the model's input size)")
    ap.add_argument("--out", default=None,
                    help="optional PNG of ground truth vs prediction")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    """Label a generated room; returns the scene, the prediction, the
    annotated-point accuracy and the wall time of ``predict_scene``."""
    args = build_parser().parse_args(argv)
    from pointnet2_tpu_torch.data.procedural_scannet import make_scene
    from pointnet2_tpu_torch.serving import Predictor

    if args.ckpt:
        pred = Predictor.from_checkpoint(
            MODEL, args.ckpt, num_point=args.npoints, name=args.ckpt_name,
            buckets=(16,), device=args.device)
    else:
        pred = Predictor(MODEL, buckets=(16,), device=args.device, seed=0)
        print("no --ckpt: running with RANDOM weights (pipeline demo; "
              "labels will be noise)")
    rng = np.random.default_rng(args.seed)
    pts, lbl = make_scene(rng, min_points=args.min_points,
                          max_points=args.max_points)
    t0 = time.perf_counter()
    out = pred.predict_scene(pts, npoints=args.npoints, seed=0)
    wall = time.perf_counter() - t0
    ann = lbl > 0
    acc = float((out["labels"][ann] == lbl[ann]).mean())
    print(f"scene points={len(pts)} annotated acc={acc:.4f} "
          f"votes min/max={out['votes'].min()}/{out['votes'].max()} "
          f"predict_scene {wall:.3f} s")

    if args.out:
        from pointnet2_tpu_torch.utils.png import write_png
        from pointnet2_tpu_torch.viz import render

        pal = np.asarray(
            [[60, 60, 60]] + [((37 * i) % 200 + 55, (91 * i) % 200 + 55,
                               (151 * i) % 200 + 55)
                              for i in range(1, 21)], np.uint8)
        keep = pts[:, 2] < pts[:, 2].max() * 0.8
        tiles = [render(pts[keep], pal[c[keep]], canvas=600, ballradius=3)
                 for c in (lbl, out["labels"])]
        write_png(np.concatenate(tiles, 1), args.out)
        print(f"wrote {args.out} (left: ground truth, right: prediction)")
    return {"points": pts, "labels": lbl, "pred": out, "accuracy": acc,
            "seconds": wall}


if __name__ == "__main__":
    main()
