"""Area-weighted mesh sampling demo.

Port of examples/mesh_sampling_demo.py (headless counterpart of the
reference's __main__ demo in tf_ops/sampling/tf_sampling.py:60-89): draw
surface points on an icosahedron with probability proportional to triangle
area, then reduce them to a uniform subset by farthest point sampling
(``ops.sample_mesh``): on the card the corner gather and the reduction run
the port's row-gather and FPS kernels. Renders the oversampled and reduced
clouds as PNGs.

    python -m pointnet2_tpu_torch.examples.mesh_sampling_demo --out mesh_demo
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import sample_mesh
from pointnet2_tpu_torch.utils.png import write_png
from pointnet2_tpu_torch.viz import render


def icosahedron(scale: float = 1.0) -> np.ndarray:
    """(1, 20, 3, 3) triangle corners of a unit icosahedron."""
    phi = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float32)
    v *= scale / np.linalg.norm(v[0])
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    return v[f][None]  # (1, 20, 3, 3)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="mesh_demo")
    ap.add_argument("--oversample", type=int, default=8192)
    ap.add_argument("--npoint", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--canvas", type=int, default=800)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    """Sample, reduce, render; returns the clouds and the PNG paths."""
    args = build_parser().parse_args(argv)
    dev = config.check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    tris = torch.from_numpy(icosahedron()).to(dev)
    # the same seed for both calls: the reduced cloud is FPS of the dense
    dense = sample_mesh(tris, args.oversample,
                        torch.Generator(dev).manual_seed(args.seed))
    reduced = sample_mesh(tris, args.oversample,
                          torch.Generator(dev).manual_seed(args.seed),
                          npoint=args.npoint)
    dense, reduced = dense.cpu().numpy(), reduced.cpu().numpy()
    print("dense:", dense.shape, "reduced:", reduced.shape)
    paths = []
    for name, pts in (("dense", dense[0]), ("reduced", reduced[0])):
        paths.append(write_png(render(pts, canvas=args.canvas),
                               os.path.join(args.out, f"{name}.png")))
        print("wrote", paths[-1])
    return {"dense": dense, "reduced": reduced, "paths": paths}


if __name__ == "__main__":
    main()
