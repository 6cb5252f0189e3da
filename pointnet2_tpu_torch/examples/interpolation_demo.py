"""Feature-propagation interpolation demo.

Port of examples/interpolation_demo.py (headless counterpart of the
reference's tf_ops/3d_interpolation/visu_interpolation.py): scatters a
sparse set of colored control points, upsamples their colors to a dense
grid with ``three_nn`` + inverse-distance weights (the FP layer's math,
utils/pointnet_util.py:211-216; on the card the port's three-NN kernel and
row gather), and renders both as PNGs.

    python -m pointnet2_tpu_torch.examples.interpolation_demo --out interp_demo
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import three_interpolate, three_nn
from pointnet2_tpu_torch.utils.png import write_png
from pointnet2_tpu_torch.viz import render


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="interp_demo")
    ap.add_argument("--sparse", type=int, default=32)
    ap.add_argument("--dense", type=int, default=4096)
    ap.add_argument("--canvas", type=int, default=600)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def interpolate(sparse_xyz, sparse_color, dense_xyz):
    """Inverse-distance 3-NN interpolation of (B, M, C) sparse features
    onto (B, N, 3) dense points (tensors on one device)."""
    dist, idx = three_nn(dense_xyz, sparse_xyz)
    dist = torch.clamp_min(dist, 1e-10)
    inv = 1.0 / dist
    weight = inv / torch.sum(inv, dim=2, keepdim=True)
    return three_interpolate(sparse_color, idx, weight)


def main(argv=None) -> dict:
    """Interpolate and render; returns the arrays and the PNG paths."""
    args = build_parser().parse_args(argv)
    dev = config.check_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    rng = np.random.default_rng(0)
    sparse_xyz = rng.uniform(-1, 1, (1, args.sparse, 3)).astype(np.float32)
    sparse_color = rng.uniform(0, 1, (1, args.sparse, 3)).astype(np.float32)
    g = int(round(args.dense ** (1 / 3)))
    if g ** 3 != args.dense:
        print(f"--dense {args.dense} rounded to the nearest cube: {g ** 3}")
    lin = np.linspace(-1, 1, g, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin)
    dense_xyz = np.stack([gx, gy, gz], -1).reshape(1, -1, 3)

    dense_color = interpolate(*(torch.from_numpy(a).to(dev) for a in (
        sparse_xyz, sparse_color, dense_xyz))).cpu().numpy()
    paths = [
        write_png(render(sparse_xyz[0],
                         (sparse_color[0] * 255).astype(np.uint8),
                         canvas=args.canvas, ballradius=12),
                  os.path.join(args.out, "sparse.png")),
        write_png(render(dense_xyz[0],
                         (np.clip(dense_color[0], 0, 1) * 255).astype(
                             np.uint8),
                         canvas=args.canvas, ballradius=4),
                  os.path.join(args.out, "dense_interpolated.png"))]
    print(f"wrote {args.out}/sparse.png and dense_interpolated.png")
    return {"sparse_xyz": sparse_xyz, "sparse_color": sparse_color,
            "dense_xyz": dense_xyz, "dense_color": dense_color,
            "paths": paths}


if __name__ == "__main__":
    main()
