"""Procedural stand-in for ShapeNet-part, written in the
``shapenetcore_partanno_segmentation_benchmark_v0_normal`` layout, numpy
only.

Port of pointnet2_tpu/data/procedural_shapenet_part.py, draw for draw: the
same seed gives the same files. The 16 real categories as parametric part
assemblies, every sampled point carrying the global part label (the
reference's ``SEG_CLASSES``, data/shapenet_part.py) of the surface it came
from. The files are synsetoffset2category.txt with the real synset ids,
per-shape 7-column ``x y z nx ny nz seg`` txt files and the
shuffled_*_file_list.json splits, so ``PartNormalDataset``, the one-hot MSG
model and the part-mIoU protocol run on them unmodified.

Part regions are geometrically meaningful (an airplane's wing points lie
on its wings); proportions, counts and poses vary per instance, and some
categories have optional parts (chair arms, earphone wire, table drawer,
motorbike light), so the protocol's absent-part-scores-IoU-1 rule is
exercised.

Geometry: built Z-up, written Y-up; centering and unit-sphere scaling are
the loader's (``pc_normalize``), as with the real files.

CLI:
  python -m pointnet2_tpu_torch.data.procedural_shapenet_part \
      --out data/procedural_shapenet_part --train_per_class 110 \
      --val_per_class 20 --test_per_class 33 --seed 0
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

from pointnet2_tpu_torch.data.procedural_modelnet import (
    _Part,
    _rot,
    _u,
    ball,
    box,
    disk,
    quad,
    torus,
    tube,
)
from pointnet2_tpu_torch.data.shapenet_part import SEG_CLASSES

__all__ = ["CATEGORY_SYNSETS", "make_part_shape", "generate"]

# Real ShapeNet synset offsets (public metadata; the loader only needs the
# category -> directory mapping to be consistent with the split files).
CATEGORY_SYNSETS = {
    "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340",
    "Car": "02958343", "Chair": "03001627", "Earphone": "03261776",
    "Guitar": "03467517", "Knife": "03624134", "Lamp": "03636649",
    "Laptop": "03642806", "Motorbike": "03790512", "Mug": "03797390",
    "Pistol": "03948459", "Rocket": "04099429", "Skateboard": "04225987",
    "Table": "04379243",
}


# ---------------------------------------------------------------------------
# labeled sampling: a builder returns [(parts, local_part_idx), ...] and
# sample_labeled draws area-weighted over the union, tagging each point
# with its group's part index.
# ---------------------------------------------------------------------------


def sample_labeled(groups: list[tuple[list[_Part], int]], rng,
                   n: int):
    """(points, normals, local_part_ids) with area-weighted allocation
    across ALL parts of ALL groups (uniform-by-area over the union)."""
    flat = [(p, lbl) for parts, lbl in groups for p in parts]
    areas = np.array([p.area for p, _ in flat])
    counts = rng.multinomial(n, areas / areas.sum())
    pts, nrm, lab = [], [], []
    for (p, lbl), k in zip(flat, counts):
        if k == 0:
            continue
        xyz, nn = p.fn(rng, k)
        pts.append(xyz)
        nrm.append(nn)
        lab.append(np.full(k, lbl, np.int32))
    return (np.concatenate(pts, 0), np.concatenate(nrm, 0),
            np.concatenate(lab, 0))


# ---------------------------------------------------------------------------
# 16 category builders. Local part index order maps onto the category's
# SEG_CLASSES label range (e.g. Airplane parts 0..3 -> global labels 0..3).
# ---------------------------------------------------------------------------


def _p_airplane(rng):
    # 0 body, 1 wing, 2 tail, 3 engine
    L = _u(rng, 1.6, 2.2)
    r = _u(rng, 0.09, 0.14)
    body = tube(r, L, (0, 0, 0), axis="x", caps="none")
    body += ball(r, (L / 2, 0, 0), squash=(2.2, 1, 1), top_frac=0.5)
    span, chord = _u(rng, 1.6, 2.4), _u(rng, 0.3, 0.5)
    sweep = _u(rng, 0.0, 0.25)
    wing = quad((-chord / 2, 0, 0), (chord, 0, 0), (-sweep, span / 2, 0))
    wing += quad((-chord / 2, 0, 0), (chord, 0, 0), (-sweep, -span / 2, 0))
    t = span * _u(rng, 0.3, 0.42)
    tail = quad((-L / 2, 0, 0), (chord * 0.6, 0, 0), (-0.1, t / 2, 0))
    tail += quad((-L / 2, 0, 0), (chord * 0.6, 0, 0), (-0.1, -t / 2, 0))
    tail += quad((-L / 2, 0, 0), (chord * 0.55, 0, 0), (-0.12, 0, t * 0.6))
    er = r * _u(rng, 0.45, 0.7)
    ex = _u(rng, -0.2, 0.15)
    eng = []
    for sy in (1, -1):
        eng += tube(er, chord * 0.9, (ex, sy * span * 0.22, -r * 1.1),
                    axis="x", caps="both")
    return [(body, 0), (wing, 1), (tail, 2), (eng, 3)]


def _p_bag(rng):
    # 0 handle, 1 body
    w, d, h = _u(rng, 0.8, 1.2), _u(rng, 0.25, 0.45), _u(rng, 0.7, 1.0)
    body = box((w, d, h), (0, 0, h / 2))
    hr = _u(rng, 0.18, 0.3) * w
    handle = torus(hr, 0.03, (0, 0, h + hr * 0.35), axis="y")
    if rng.random() < 0.5:  # shoulder strap variant: long thin arc
        handle += tube(0.02, w * 0.8, (0, 0, h + hr * 0.9), axis="x",
                       caps="none")
    return [(handle, 0), (body, 1)]


def _p_cap(rng):
    # 0 crown panels, 1 peak (brim)
    r = _u(rng, 0.45, 0.6)
    crown = ball(r, (0, 0, 0), squash=(1, 1, _u(rng, 0.55, 0.8)),
                 top_frac=0.5)
    pl = r * _u(rng, 0.9, 1.4)
    peak = quad((-r * 0.6, r * 0.2, 0.0), (r * 1.2, 0, 0),
                (0, pl, _u(rng, -0.15, 0.05)))
    return [(crown, 0), (peak, 1)]


def _p_car(rng):
    # 0 roof, 1 hood, 2 wheel, 3 body
    L, W = _u(rng, 1.7, 2.3), _u(rng, 0.8, 1.1)
    bh = _u(rng, 0.35, 0.5)
    body = box((L, W, bh), (0, 0, bh / 2 + 0.12), faces="sides")
    cab_l = L * _u(rng, 0.4, 0.55)
    ch = _u(rng, 0.28, 0.4)
    roof = box((cab_l, W * 0.9, ch), (-L * 0.05, 0, bh + 0.12 + ch / 2),
               faces="no_bottom")
    hood = quad((L * 0.5 - L * 0.28, -W / 2, bh + 0.12), (L * 0.28, 0, 0),
                (0, W, 0))
    hood += quad((-L / 2, -W / 2, bh + 0.12), (L * 0.22, 0, 0), (0, W, 0))
    wr = _u(rng, 0.16, 0.22)
    wheel = []
    for sx in (1, -1):
        for sy in (1, -1):
            wheel += tube(wr, 0.1, (sx * L * 0.32, sy * W / 2, wr),
                          axis="y", caps="both")
    return [(roof, 0), (hood, 1), (wheel, 2), (body, 3)]


def _p_chair(rng):
    # 0 back, 1 seat, 2 leg, 3 arm (optional)
    w, d = _u(rng, 0.45, 0.6), _u(rng, 0.45, 0.6)
    sh = _u(rng, 0.4, 0.5)
    seat = box((w, d, 0.06), (0, 0, sh))
    bh = _u(rng, 0.45, 0.7)
    back = box((w, 0.06, bh), (0, -d / 2 + 0.03, sh + bh / 2))
    t = _u(rng, 0.03, 0.06)
    leg = []
    for sx in (1, -1):
        for sy in (1, -1):
            leg += box((t, t, sh), (sx * (w / 2 - t), sy * (d / 2 - t),
                                    sh / 2), faces="sides")
    groups = [(back, 0), (seat, 1), (leg, 2)]
    if rng.random() < 0.55:
        arm = []
        ah = _u(rng, 0.18, 0.26)
        for sx in (1, -1):
            arm += box((0.05, d * 0.8, 0.05),
                       (sx * w / 2, -d * 0.05, sh + ah))
            arm += box((0.05, 0.05, ah), (sx * w / 2, d * 0.3,
                                          sh + ah / 2), faces="sides")
        groups.append((arm, 3))
    return groups


def _p_earphone(rng):
    # 0 headband, 1 earphone (cups), 2 wire (optional)
    R = _u(rng, 0.45, 0.6)
    band = torus(R, 0.035, (0, 0, 0), axis="y")  # full ring reads as band
    cr = _u(rng, 0.14, 0.22)
    cup = ball(cr, (-R, 0, 0), squash=(0.55, 1, 1))
    cup += ball(cr, (R, 0, 0), squash=(0.55, 1, 1))
    groups = [(band, 0), (cup, 1)]
    if rng.random() < 0.6:
        wire = tube(0.015, R * 1.6, (R, 0, -R * 0.9), axis="z", caps="none")
        groups.append((wire, 2))
    return groups


def _p_guitar(rng):
    # 0 head, 1 neck, 2 body
    bl, bw = _u(rng, 0.85, 1.1), _u(rng, 0.6, 0.8)
    th = _u(rng, 0.1, 0.14)
    body = ball(bw / 2, (0, 0, 0), squash=(1, bl / bw, th / bw))
    body += ball(bw / 2 * 0.72, (0, bl * 0.42, 0),
                 squash=(1, bl / bw, th / bw * 0.9))
    nl = _u(rng, 0.8, 1.1)
    neck = box((0.09, nl, 0.05), (0, bl * 0.45 + nl / 2, 0))
    head = box((0.12, nl * 0.22, 0.04),
               (0, bl * 0.45 + nl + nl * 0.11, 0))
    return [(head, 0), (neck, 1), (body, 2)]


def _p_knife(rng):
    # 0 blade, 1 handle
    bl = _u(rng, 0.9, 1.3)
    bw = _u(rng, 0.12, 0.2)
    blade = quad((-bw / 2, 0, 0), (bw, 0, 0), (0, bl, 0))
    blade += quad((-bw / 2, 0, 0.012), (bw, 0, 0), (0, bl, 0))
    blade += quad((-bw / 2, 0, 0), (0, bl * 0.98, 0.012), (bw, 0, 0))
    hl = _u(rng, 0.35, 0.55)
    handle = box((bw * 0.8, hl, 0.07), (0, -hl / 2, 0))
    return [(blade, 0), (handle, 1)]


def _p_lamp(rng):
    # 0 base, 1 shade, 2 pole, 3 bulb/canopy (optional)
    br = _u(rng, 0.25, 0.4)
    base = tube(br, 0.06, (0, 0, 0.03), caps="both")
    ph = _u(rng, 0.9, 1.5)
    pole = tube(0.03, ph, (0, 0, 0.06 + ph / 2), caps="none")
    sr0, sr1 = _u(rng, 0.12, 0.2), _u(rng, 0.3, 0.5)
    sh = _u(rng, 0.25, 0.4)
    shade = tube(sr1, sh, (0, 0, 0.06 + ph + sh / 2 - 0.05), r1=sr0,
                 caps="none")
    groups = [(base, 0), (shade, 1), (pole, 2)]
    if rng.random() < 0.6:
        bulb = ball(_u(rng, 0.06, 0.1), (0, 0, 0.06 + ph - 0.02))
        groups.append((bulb, 3))
    return groups


def _shifted(parts: list[_Part], off) -> list[_Part]:
    """Translate every part by `off` (single rng draw per sample)."""
    out = []
    for p in parts:
        def fn(rng2, n, fn0=p.fn):
            xyz, nn = fn0(rng2, n)
            return xyz + off, nn
        out.append(_Part(p.area, fn))
    return out


def _p_laptop(rng):
    # 0 keyboard (base), 1 screen
    w, d = _u(rng, 0.9, 1.2), _u(rng, 0.6, 0.8)
    base = box((w, d, 0.04), (0, 0, 0.02))
    ang = _u(rng, 95, 125)
    R = _rot("x", ang - 90)
    screen = box((w, d, 0.03), (0, 0, 0), rot=R)
    # move screen so its hinge edge sits at the base's back edge
    off = np.array([0, -d / 2, 0.04]) - R @ np.array([0, -d / 2, 0])
    return [(base, 0), (_shifted(screen, off), 1)]


def _p_motorbike(rng):
    # 0 gas tank, 1 seat, 2 wheel, 3 handle, 4 light (optional), 5 frame
    wb = _u(rng, 1.1, 1.5)
    wr = _u(rng, 0.22, 0.3)
    wheel = []
    for sx in (1, -1):
        wheel += torus(wr, 0.05, (sx * wb / 2, 0, wr), axis="y")
    frame = tube(0.035, wb, (0, 0, wr * 1.35), axis="x", caps="none")
    frame += tube(0.035, wr * 1.5, (wb * 0.42, 0, wr * 1.5),
                  axis="z", caps="none")
    tank = ball(_u(rng, 0.14, 0.2), (wb * 0.1, 0, wr * 1.6),
                squash=(1.6, 0.8, 0.8))
    seat = box((wb * 0.35, 0.16, 0.06), (-wb * 0.2, 0, wr * 1.75))
    handle = tube(0.02, _u(rng, 0.5, 0.7), (wb * 0.42, 0, wr * 2.3),
                  axis="y", caps="none")
    groups = [(tank, 0), (seat, 1), (wheel, 2), (handle, 3)]
    if rng.random() < 0.6:
        light = ball(0.07, (wb * 0.52, 0, wr * 2.0))
        groups.append((light, 4))
    groups.append((frame, 5))
    return groups


def _p_mug(rng):
    # 0 handle, 1 body
    r = _u(rng, 0.3, 0.42)
    h = _u(rng, 0.7, 1.0)
    body = tube(r, h, (0, 0, h / 2), caps="bottom")
    body += tube(r * 0.88, h * 0.96, (0, 0, h / 2 + h * 0.03),
                 caps="none")  # inner wall
    hr = h * _u(rng, 0.22, 0.3)
    handle = torus(hr, 0.035, (r + hr * 0.55, 0, h / 2), axis="y")
    return [(handle, 0), (body, 1)]


def _p_pistol(rng):
    # 0 barrel, 1 handle (grip), 2 trigger
    bl = _u(rng, 0.8, 1.1)
    barrel = box((bl, 0.12, 0.16), (0, 0, 0.3))
    barrel += tube(0.045, bl * 0.25, (bl / 2 + bl * 0.1, 0, 0.3),
                   axis="x", caps="top")
    gl = _u(rng, 0.35, 0.5)
    R = _rot("y", _u(rng, 12, 25))
    grip = box((0.16, 0.11, gl), (-bl * 0.35, 0, 0.3 - 0.08 - gl / 2),
               rot=R)
    trig = torus(0.06, 0.018, (-bl * 0.12, 0, 0.15), axis="y")
    return [(barrel, 0), (grip, 1), (trig, 2)]


def _p_rocket(rng):
    # 0 body, 1 fin, 2 nose
    L = _u(rng, 1.6, 2.2)
    r = _u(rng, 0.12, 0.2)
    body = tube(r, L, (0, 0, L / 2), caps="bottom")
    nose = tube(r, L * 0.25, (0, 0, L + L * 0.125), r1=0.0, caps="none")
    fin = []
    nfin = int(rng.integers(3, 5))
    fl, fw = L * 0.25, r * _u(rng, 1.5, 2.4)
    for k in range(nfin):
        R = _rot("z", 360 * k / nfin)
        o = R @ np.array([r * 0.9, 0, 0])
        u = R @ np.array([fw, 0, 0])
        fin += quad(o, u, (0, 0, fl))
    return [(body, 0), (fin, 1), (nose, 2)]


def _p_skateboard(rng):
    # 0 wheel, 1 deck, 2 truck
    L, W = _u(rng, 1.4, 1.8), _u(rng, 0.32, 0.42)
    deck = box((L, W, 0.03), (0, 0, 0.18))
    wr = 0.05
    wheel, truck = [], []
    for sx in (1, -1):
        truck += box((0.08, W * 0.7, 0.06), (sx * L * 0.32, 0, 0.12))
        for sy in (1, -1):
            wheel += tube(wr, 0.05, (sx * L * 0.32, sy * W * 0.42, wr),
                          axis="y", caps="both")
    return [(wheel, 0), (deck, 1), (truck, 2)]


def _p_table(rng):
    # 0 top, 1 leg, 2 support/drawer (optional)
    w, d = _u(rng, 1.0, 1.6), _u(rng, 0.6, 1.0)
    h = _u(rng, 0.65, 0.8)
    tt = _u(rng, 0.04, 0.08)
    top = box((w, d, tt), (0, 0, h - tt / 2))
    t = _u(rng, 0.04, 0.08)
    leg = []
    for sx in (1, -1):
        for sy in (1, -1):
            leg += box((t, t, h - tt), (sx * (w / 2 - t), sy * (d / 2 - t),
                                        (h - tt) / 2), faces="sides")
    groups = [(top, 0), (leg, 1)]
    if rng.random() < 0.55:
        sup = box((w * 0.55, d * 0.8, 0.16), (0, 0, h - tt - 0.1),
                  faces="no_top")
        groups.append((sup, 2))
    return groups


CATEGORY_BUILDERS = {
    "Airplane": _p_airplane, "Bag": _p_bag, "Cap": _p_cap, "Car": _p_car,
    "Chair": _p_chair, "Earphone": _p_earphone, "Guitar": _p_guitar,
    "Knife": _p_knife, "Lamp": _p_lamp, "Laptop": _p_laptop,
    "Motorbike": _p_motorbike, "Mug": _p_mug, "Pistol": _p_pistol,
    "Rocket": _p_rocket, "Skateboard": _p_skateboard, "Table": _p_table,
}

assert set(CATEGORY_BUILDERS) == set(SEG_CLASSES)


def make_part_shape(category: str, rng, npoints: int = 2048):
    """One labeled cloud: (pts (n,3) Y-up, normals (n,3), seg (n,) int32
    GLOBAL part labels). Surface noise and a small random pose jitter are
    applied; centering/unit-sphere scaling is left to the loader
    (pc_normalize), as with the real files."""
    groups = CATEGORY_BUILDERS[category](rng)
    pts, nrm, local = sample_labeled(groups, rng, npoints)
    # small pose jitter about the up axis + surface noise
    R = _rot("z", _u(rng, -8, 8)) @ _rot("x", _u(rng, -3, 3))
    pts = pts @ R.T
    nrm = nrm @ R.T
    pts = pts + rng.normal(0, 0.004, pts.shape)
    # z-up -> y-up
    pts = pts[:, [0, 2, 1]] * np.array([1.0, 1.0, -1.0])
    nrm = nrm[:, [0, 2, 1]] * np.array([1.0, 1.0, -1.0])
    seg = np.asarray(SEG_CLASSES[category], np.int32)[local]
    perm = rng.permutation(npoints)
    return (pts[perm].astype(np.float32), nrm[perm].astype(np.float32),
            seg[perm])


def generate(out_dir: str, train_per_class: int = 110,
             val_per_class: int = 20, test_per_class: int = 33,
             npoints: int = 2048, seed: int = 0) -> None:
    """Write the full v0_normal layout: synsetoffset2category.txt, one
    ``<synset>/<id>.txt`` (7 cols: x y z nx ny nz seg) per shape, and the
    three shuffled_*_file_list.json split files (entries
    ``shape_data/<synset>/<id>``, the path shape PartNormalDataset parses
    at part_dataset_all_normal.py:40-43)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "synsetoffset2category.txt"), "w") as f:
        f.write("".join(f"{c}\t{s}\n" for c, s in CATEGORY_SYNSETS.items()))
    splits = {"train": [], "val": [], "test": []}
    plan = (("train", train_per_class), ("val", val_per_class),
            ("test", test_per_class))
    for cat, synset in CATEGORY_SYNSETS.items():
        cdir = os.path.join(out_dir, synset)
        os.makedirs(cdir, exist_ok=True)
        k = 0
        for split, count in plan:
            for _ in range(count):
                sid = (f"p{seed:x}"
                       f"{zlib.crc32(f'{cat}/{k}'.encode()) % (16 ** 6):06x}"
                       f"{k:05d}")
                k += 1
                pts, nrm, seg = make_part_shape(cat, rng, npoints)
                arr = np.concatenate(
                    [pts, nrm, seg[:, None].astype(np.float32)], 1)
                np.savetxt(os.path.join(cdir, sid + ".txt"), arr,
                           fmt="%.4f")
                splits[split].append(f"shape_data/{synset}/{sid}")
    sdir = os.path.join(out_dir, "train_test_split")
    os.makedirs(sdir, exist_ok=True)
    for split, lst in splits.items():
        rng.shuffle(lst)
        with open(os.path.join(sdir,
                               f"shuffled_{split}_file_list.json"),
                  "w") as f:
            json.dump(lst, f)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="data/procedural_shapenet_part")
    ap.add_argument("--train_per_class", type=int, default=110)
    ap.add_argument("--val_per_class", type=int, default=20)
    ap.add_argument("--test_per_class", type=int, default=33)
    ap.add_argument("--npoints", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(args.out, args.train_per_class, args.val_per_class,
             args.test_per_class, args.npoints, args.seed)
    print(f"wrote procedural ShapeNetPart to {args.out}")


if __name__ == "__main__":
    main()
