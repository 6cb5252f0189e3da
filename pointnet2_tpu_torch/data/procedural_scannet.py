"""Procedural stand-in for ScanNet scenes, in the reference's pickle
format, numpy only.

Port of pointnet2_tpu/data/procedural_scannet.py, draw for draw: the same
seed gives the same pickles. Furnished rooms: floor, walls and sometimes a
ceiling, doors, windows and pictures on the walls, and furniture built by
the procedural ModelNet builders (:mod:`procedural_modelnet`), each surface
labelled with its object's class from the reference's 21-label list
(unannotated, wall, floor, chair, table, desk, bed, bookshelf, sofa, sink,
bathtub, toilet, curtain, counter, door, window, shower curtain,
refridgerator, picture, cabinet, otherfurniture). A share of the points is
relabelled 0 (unannotated), as real scans have annotation gaps: what the
crop sampler's >= 70%-annotated test and the weighted loss exercise.

Scenes are z-up metric rooms like the real pickles: x/y extents about
3.5-8 m, 2.5-3 m tall, 60-180k points allocated by surface area.

CLI (writes scannet_train.pickle / scannet_test.pickle, read by
``ScannetDataset(root=...)``):
  python -m pointnet2_tpu_torch.data.procedural_scannet \
      --out data/procedural_scannet --train 80 --test 24 --seed 0
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from pointnet2_tpu_torch.data.procedural_modelnet import (
    CLASS_NAMES,
    _rot,
    _u,
    box,
    make_shape,
    quad,
    sample_parts,
)

LABEL_NAMES = [
    "unannotated", "wall", "floor", "chair", "table", "desk", "bed",
    "bookshelf", "sofa", "sink", "bathtub", "toilet", "curtain", "counter",
    "door", "window", "shower curtain", "refridgerator", "picture",
    "cabinet", "otherfurniture",
]
LABELS = {n: i for i, n in enumerate(LABEL_NAMES)}

# furniture: procedural_modelnet builder class -> scannet label, with a
# rough footprint (dx, dy) and height used for placement; builders emit
# z-up shapes in roughly unit proportions, rescaled to metric size here.
FURNITURE = [
    # (modelnet class, scannet label, target height m, weight)
    ("chair", "chair", 0.9, 3.0),
    ("stool", "chair", 0.5, 1.0),
    ("table", "table", 0.75, 2.0),
    ("desk", "desk", 0.76, 1.5),
    ("bed", "bed", 0.6, 1.2),
    ("bookshelf", "bookshelf", 1.8, 1.2),
    ("sofa", "sofa", 0.85, 1.5),
    ("sink", "sink", 0.85, 0.6),
    ("bathtub", "bathtub", 0.55, 0.5),
    ("toilet", "toilet", 0.75, 0.5),
    ("curtain", "curtain", 2.2, 0.8),
    ("dresser", "cabinet", 1.0, 1.2),
    ("wardrobe", "cabinet", 1.9, 0.8),
    ("night_stand", "otherfurniture", 0.55, 1.0),
    ("lamp", "otherfurniture", 1.4, 0.8),
    ("plant", "otherfurniture", 0.9, 0.8),
    ("piano", "otherfurniture", 1.1, 0.4),
    ("radio", "otherfurniture", 0.3, 0.4),
    ("tv_stand", "otherfurniture", 0.5, 0.8),
]
_MN_INDEX = {n: i for i, n in enumerate(CLASS_NAMES)}


def _surface_points(rng, parts, n):
    pts, _ = sample_parts(parts, rng, n)
    return pts


def _room_shell(rng, W, D, H, density):
    """Floor, walls, ceiling (sometimes), plus doors/windows/pictures ON
    the walls. Returns list of (points, label) arrays."""
    out = []

    def emit(parts, label, boost=1.0):
        area = sum(p.area for p in parts)
        n = max(8, int(area * density * boost))
        out.append((_surface_points(rng, parts, n), LABELS[label]))

    emit(quad((0, 0, 0), (W, 0, 0), (0, D, 0)), "floor")
    if rng.random() < 0.5:  # many real scans lack ceiling coverage
        # nyu40 "ceiling" is not in the 21-label list, so the reference
        # preprocessing maps it to unannotated (scannet_util.py:12-14)
        emit(quad((0, 0, H), (W, 0, 0), (0, D, 0)), "unannotated",
             boost=0.3)
    walls = [
        ((0, 0, 0), (W, 0, 0), (0, 0, H)),
        ((0, D, 0), (W, 0, 0), (0, 0, H)),
        ((0, 0, 0), (0, D, 0), (0, 0, H)),
        ((W, 0, 0), (0, D, 0), (0, 0, H)),
    ]
    for o, u, v in walls:
        emit(quad(o, u, v), "wall")
    # door on one wall
    dw, dh = _u(rng, 0.8, 1.1), _u(rng, 1.9, 2.15)
    dx = _u(rng, 0.2, max(0.25, W - dw - 0.2))
    emit(quad((dx, 0.012, 0), (dw, 0, 0), (0, 0, dh)), "door", boost=1.2)
    # 1-2 windows
    for _ in range(int(rng.integers(1, 3))):
        ww, wh = _u(rng, 0.7, 1.6), _u(rng, 0.8, 1.3)
        wx = _u(rng, 0.2, max(0.25, D - ww - 0.2))
        emit(quad((0.012, wx, _u(rng, 0.8, 1.2)), (0, ww, 0), (0, 0, wh)),
             "window", boost=1.2)
    # pictures
    for _ in range(int(rng.integers(0, 3))):
        pw, ph = _u(rng, 0.3, 0.8), _u(rng, 0.3, 0.6)
        px = _u(rng, 0.3, max(0.35, W - pw - 0.3))
        emit(quad((px, D - 0.012, _u(rng, 1.2, 1.7)), (pw, 0, 0),
                  (0, 0, ph)), "picture", boost=1.5)
    # counter along a wall sometimes
    if rng.random() < 0.4:
        cw = _u(rng, 1.2, min(2.5, W - 0.5))
        emit(quad((0.05, 0.05, 0.9), (cw, 0, 0), (0, 0.6, 0)), "counter")
        emit(quad((0.05, 0.05, 0), (cw, 0, 0), (0, 0, 0.9)), "counter",
             boost=0.5)
    # shower curtain / refrigerator occasionally (bathroom/kitchen rooms)
    if rng.random() < 0.25:
        sw = _u(rng, 0.9, 1.4)
        emit(quad((W - 0.1, 0.3, 0.1), (0, sw, 0), (0, 0, 1.9)),
             "shower curtain")
    if rng.random() < 0.3:
        fw, fd, fh = 0.7, 0.7, _u(rng, 1.6, 1.9)
        fx, fy = _u(rng, 0.2, W - 1.0), 0.1
        emit(box((fw, fd, fh), (fx + fw / 2, fy + fd / 2, fh / 2),
                 faces="no_bottom"), "refridgerator")
    return out


def make_scene(rng, min_points: int = 60_000, max_points: int = 180_000):
    """One furnished room: (points (N, 3) f32 z-up metric, labels (N,)
    int32 in [0, 20])."""
    W, D = _u(rng, 3.5, 8.0), _u(rng, 3.0, 6.5)
    H = _u(rng, 2.5, 3.0)
    target = int(rng.integers(min_points, max_points))
    # shell area ~ 2*(W*D) + 2*H*(W+D); density chosen so shell+furniture
    # approximately hits the target count
    shell_area = 2 * W * D + 2 * H * (W + D)
    density = target * 0.55 / shell_area
    pieces = _room_shell(rng, W, D, H, density)

    # furniture: 4-10 pieces placed on the floor, scaled to metric height
    weights = np.array([f[3] for f in FURNITURE])
    weights = weights / weights.sum()
    n_furn = int(rng.integers(4, 11))
    for k in rng.choice(len(FURNITURE), size=n_furn, p=weights):
        mn_name, label, height_m, _w = FURNITURE[k]
        cloud = make_shape(_MN_INDEX[mn_name], rng,
                           npoints=max(400, int(target * 0.45 / n_furn)))
        # make_shape returns unit-sphere Y-UP clouds; back to z-up metric
        # (up (0,1,0) -> (0,0,1): new_y = -z, new_z = +y)
        pts = cloud[:, [0, 2, 1]] * np.array([1.0, -1.0, 1.0])
        pts -= pts.min(axis=0, keepdims=True)
        ext = pts.max(axis=0)
        s = height_m / max(ext[2], 1e-6)
        s *= _u(rng, 0.85, 1.15)
        pts *= s
        # random yaw + placement inside the room
        R = _rot("z", float(rng.uniform(0, 360)))
        pts = pts @ R.T
        pts -= pts.min(axis=0, keepdims=True)
        fx = _u(rng, 0.15, max(0.2, W - pts[:, 0].max() - 0.15))
        fy = _u(rng, 0.15, max(0.2, D - pts[:, 1].max() - 0.15))
        pts += np.array([fx, fy, 0.0])
        pieces.append((pts.astype(np.float32), LABELS[label]))

    pts = np.concatenate([p for p, _ in pieces], 0).astype(np.float32)
    lbl = np.concatenate([np.full(len(p), l, np.int32)
                          for p, l in pieces])
    # scan noise + annotation gaps: real scans have unannotated regions
    pts += rng.normal(0, 0.005, pts.shape).astype(np.float32)
    drop = rng.random(len(lbl)) < _u(rng, 0.06, 0.18)
    lbl[drop] = 0
    perm = rng.permutation(len(lbl))
    return pts[perm], lbl[perm]


def generate_scenes(num: int, seed: int = 0, **kw):
    rng = np.random.default_rng(seed)
    return [make_scene(rng, **kw) for _ in range(num)]


def generate(out_dir: str, train: int = 80, test: int = 24,
             seed: int = 0, **kw) -> None:
    """Write scannet_train.pickle / scannet_test.pickle in the reference's
    format (two pickled lists; scannet/scannet_dataset.py:13-16)."""
    os.makedirs(out_dir, exist_ok=True)
    for split, num, s in (("train", train, seed), ("test", test, seed + 1)):
        scenes = generate_scenes(num, seed=s, **kw)
        with open(os.path.join(out_dir, f"scannet_{split}.pickle"),
                  "wb") as fp:
            pickle.dump([p for p, _ in scenes], fp)
            pickle.dump([l for _, l in scenes], fp)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="data/procedural_scannet")
    ap.add_argument("--train", type=int, default=80)
    ap.add_argument("--test", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(args.out, args.train, args.test, args.seed)
    print(f"wrote procedural ScanNet pickles to {args.out}")


if __name__ == "__main__":
    main()
