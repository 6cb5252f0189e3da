"""Procedural stand-in for ModelNet40, written in the real data sets'
on-disk layouts, numpy only.

Port of pointnet2_tpu/data/procedural_modelnet.py, function for function
and draw for draw: the same seed gives the same files, bit for bit. 40
procedurally generated shape categories (compositions of parametric
primitives with heavy per-instance variation in proportions, counts, pose
and noise), written in the ``modelnet40_ply_hdf5_2048`` HDF5 layout
(:func:`generate`, read by ``ModelNetH5Dataset``) or the
``modelnet40_normal_resampled`` txt layout with normals
(:func:`generate_txt`, read by ``ModelNetDataset``). With no real
ModelNet40 at hand, the port's whole classifier pipeline (loader, on-device
augmentation, the recipe's schedules, the 12-vote protocol) runs on them
unmodified: a wrong schedule constant, a loss-scale slip or an
augmentation-order fault shows here as on real data.

The categories mirror ModelNet40's class list and are confusable in
families (table/desk/bench, dresser/night_stand/wardrobe,
cup/vase/flower_pot, chair/stool/sofa ...), so classifiers must use shape
composition, not bounding boxes.

Geometry: shapes are built Z-up then swapped to Y-up as in ModelNet40
(training rotates about Y); every cloud is centered and scaled to the unit
sphere like the reference's files, its rows shuffled.

CLI:
  python -m pointnet2_tpu_torch.data.procedural_modelnet \
      --out data/procedural_modelnet40 --train_per_class 246 \
      --test_per_class 62 --seed 0
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["CLASS_NAMES", "make_shape", "generate"]


# ---------------------------------------------------------------------------
# primitive surface samplers
# Each part is (area, sampler(rng, n) -> (n, 3) points), composed by
# area-weighted multinomial allocation — i.e. uniform-by-area over the
# union of surfaces, the same distribution mesh sampling (ops/mesh.py)
# produces on a triangulation.
# ---------------------------------------------------------------------------


def _rot(axis: str, deg: float) -> np.ndarray:
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class _Part:
    """One surface patch: area weight + sampler(rng, n) -> (points,
    outward unit normals), both (n, 3). Normals ride along so the txt
    (xyz+normal) dataset variant costs nothing extra."""

    __slots__ = ("area", "fn")

    def __init__(self, area, fn):
        self.area = float(area)
        self.fn = fn


def _perm(axis: str, x, y, z):
    """Canonical z-frame components -> the sampler's axis frame (same
    permutation the point samplers use)."""
    return np.stack({"z": (x, y, z), "x": (z, x, y), "y": (x, z, y)}[axis], 1)


def quad(origin, u, v) -> list[_Part]:
    """Rectangle origin + a*u + b*v, a,b in [0,1]."""
    origin, u, v = (np.asarray(x, np.float64) for x in (origin, u, v))
    cr = np.cross(u, v)
    area = np.linalg.norm(cr)
    normal = cr / max(area, 1e-12)

    def fn(rng, n):
        a = rng.random((n, 1))
        b = rng.random((n, 1))
        return origin + a * u + b * v, np.broadcast_to(normal, (n, 3)).copy()

    return [_Part(area, fn)]


def box(size, center=(0, 0, 0), rot=None, faces="all") -> list[_Part]:
    """Axis-aligned box surface; faces: 'all' | 'no_top' | 'no_bottom' |
    'sides'. Optionally rotated by matrix `rot` about `center`."""
    sx, sy, sz = np.asarray(size, np.float64) / 2
    c = np.asarray(center, np.float64)
    quads = []
    if faces in ("all", "no_bottom"):
        quads.append(((-sx, -sy, sz), (2 * sx, 0, 0), (0, 2 * sy, 0)))
    if faces in ("all", "no_top"):
        quads.append(((-sx, -sy, -sz), (2 * sx, 0, 0), (0, 2 * sy, 0)))
    quads += [
        ((-sx, -sy, -sz), (2 * sx, 0, 0), (0, 0, 2 * sz)),
        ((-sx, sy, -sz), (2 * sx, 0, 0), (0, 0, 2 * sz)),
        ((-sx, -sy, -sz), (0, 2 * sy, 0), (0, 0, 2 * sz)),
        ((sx, -sy, -sz), (0, 2 * sy, 0), (0, 0, 2 * sz)),
    ]
    parts = []
    for o, u, v in quads:
        if rot is None:
            parts += quad(np.asarray(o) + c, u, v)
        else:
            R = np.asarray(rot)
            parts += quad(R @ np.asarray(o, np.float64) + c,
                          R @ np.asarray(u, np.float64),
                          R @ np.asarray(v, np.float64))
    return parts


def disk(r, center=(0, 0, 0), axis="z", r_inner=0.0) -> list[_Part]:
    c = np.asarray(center, np.float64)
    area = np.pi * (r * r - r_inner * r_inner)

    def fn(rng, n):
        rad = np.sqrt(rng.uniform(r_inner ** 2, r * r, n))
        th = rng.uniform(0, 2 * np.pi, n)
        x, y = rad * np.cos(th), rad * np.sin(th)
        z = np.zeros(n)
        nrm = _perm(axis, z, z, np.ones(n))
        return c + _perm(axis, x, y, z), nrm

    return [_Part(area, fn)]


def tube(r0, h, center=(0, 0, 0), r1=None, axis="z", caps="both") -> list[_Part]:
    """Cylinder / cone-frustum lateral surface along `axis`, height h
    centered at `center`; r1 (top radius) defaults to r0. caps:
    'both' | 'top' | 'bottom' | 'none'."""
    r1 = r0 if r1 is None else r1
    c = np.asarray(center, np.float64)
    slant = np.hypot(h, r1 - r0)
    area = np.pi * (r0 + r1) * slant

    def fn(rng, n):
        # density along t is proportional to r(t); invert the quadratic CDF
        u = rng.random(n)
        if abs(r1 - r0) < 1e-12:
            t = u
        else:
            t = (np.sqrt(r0 * r0 + u * (r1 * r1 - r0 * r0)) - r0) / (r1 - r0)
        rad = r0 + (r1 - r0) * t
        th = rng.uniform(0, 2 * np.pi, n)
        x, y = rad * np.cos(th), rad * np.sin(th)
        z = (t - 0.5) * h
        # frustum lateral normal: ([h cos, h sin, r0-r1]) / slant
        s = max(slant, 1e-12)
        nrm = _perm(axis, h / s * np.cos(th), h / s * np.sin(th),
                    np.full(n, (r0 - r1) / s))
        return c + _perm(axis, x, y, z), nrm

    parts = [_Part(area, fn)]
    half = np.eye(3)[{"x": 0, "y": 1, "z": 2}[axis]] * (h / 2)
    if caps in ("both", "top") and r1 > 1e-9:
        parts += disk(r1, c + half, axis)
    if caps in ("both", "bottom") and r0 > 1e-9:
        parts += disk(r0, c - half, axis)
    return parts


def ball(r, center=(0, 0, 0), squash=(1, 1, 1), top_frac=1.0) -> list[_Part]:
    """(Squashed) sphere surface; top_frac < 1 keeps only the portion with
    z >= (1 - 2*top_frac)*r (e.g. 0.5 = hemisphere bowl)."""
    c = np.asarray(center, np.float64)
    sq = np.asarray(squash, np.float64)
    area = 4 * np.pi * r * r * float(np.mean(sq) ** 2) * top_frac

    def fn(rng, n):
        zmin = (1 - 2 * top_frac)
        z = rng.uniform(zmin, 1.0, n)  # uniform in z == uniform on sphere
        th = rng.uniform(0, 2 * np.pi, n)
        s = np.sqrt(np.maximum(0.0, 1 - z * z))
        u = np.stack([s * np.cos(th), s * np.sin(th), z], 1)
        # ellipsoid x = c + r*u*sq has normal ∝ u / sq (inverse scale)
        nrm = u / np.maximum(sq, 1e-12)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-12
        return c + u * r * sq, nrm

    return [_Part(area, fn)]


def torus(R, r, center=(0, 0, 0), axis="z") -> list[_Part]:
    c = np.asarray(center, np.float64)
    area = 4 * np.pi ** 2 * R * r

    def fn(rng, n):
        th = rng.uniform(0, 2 * np.pi, n)
        # minor angle with density (R + r cos phi) via rejection
        phi = np.empty(0)
        while phi.size < n:
            cand = rng.uniform(0, 2 * np.pi, 2 * n)
            keep = rng.random(2 * n) < (R + r * np.cos(cand)) / (R + r)
            phi = np.concatenate([phi, cand[keep]])
        phi = phi[:n]
        rad = R + r * np.cos(phi)
        x, y = rad * np.cos(th), rad * np.sin(th)
        z = r * np.sin(phi)
        nrm = _perm(axis, np.cos(th) * np.cos(phi),
                    np.sin(th) * np.cos(phi), np.sin(phi))
        return c + _perm(axis, x, y, z), nrm

    return [_Part(area, fn)]


def sample_parts(parts: list[_Part], rng, n: int):
    """(points, normals), each (n, 3), area-weighted over the part union."""
    areas = np.array([p.area for p in parts])
    counts = rng.multinomial(n, areas / areas.sum())
    out = [p.fn(rng, k) for p, k in zip(parts, counts) if k > 0]
    return (np.concatenate([o[0] for o in out], 0),
            np.concatenate([o[1] for o in out], 0))


# ---------------------------------------------------------------------------
# shared sub-assemblies
# ---------------------------------------------------------------------------


def _legs(rng, w, d, h, thick=None, n=4) -> list[_Part]:
    """n legs under a (w x d) footprint from z=0 to z=h."""
    t = thick if thick is not None else rng.uniform(0.03, 0.07)
    xs, ys = w / 2 - t, d / 2 - t
    spots = [(-xs, -ys), (xs, -ys), (-xs, ys), (xs, ys)][:n]
    parts = []
    for x, y in spots:
        parts += box((t, t, h), (x, y, h / 2), faces="sides")
    return parts


def _slab_on_legs(rng, w, d, h, top_t) -> list[_Part]:
    return (box((w, d, top_t), (0, 0, h - top_t / 2))
            + _legs(rng, w, d, h - top_t))


def _u(rng, lo, hi):
    return float(rng.uniform(lo, hi))


# ---------------------------------------------------------------------------
# 40 class builders (ModelNet40 class list order)
# Each takes rng and returns a list of parts in Z-up coordinates.
# ---------------------------------------------------------------------------


def _airplane(rng):
    L = _u(rng, 1.6, 2.2)
    fus_r = _u(rng, 0.09, 0.14)
    parts = tube(fus_r, L, (0, 0, 0), axis="x", caps="none")
    parts += ball(fus_r, (L / 2, 0, 0), squash=(2.2, 1, 1), top_frac=0.5)
    parts += tube(fus_r, L * 0.25, (-L / 2 - L * 0.12, 0, 0),
                  r1=fus_r * 0.3, axis="x", caps="none")
    span = _u(rng, 1.6, 2.4)
    chord = _u(rng, 0.3, 0.5)
    sweep = _u(rng, 0.0, 0.25)
    parts += quad((-chord / 2, 0, 0), (chord, 0, 0), (-sweep, span / 2, 0))
    parts += quad((-chord / 2, 0, 0), (chord, 0, 0), (-sweep, -span / 2, 0))
    tail = span * _u(rng, 0.3, 0.42)
    parts += quad((-L / 2, 0, 0), (chord * 0.6, 0, 0), (-0.1, tail / 2, 0))
    parts += quad((-L / 2, 0, 0), (chord * 0.6, 0, 0), (-0.1, -tail / 2, 0))
    parts += quad((-L / 2, 0, 0), (chord * 0.55, 0, 0), (-0.12, 0, tail * 0.6))
    return parts


def _bathtub(rng):
    w, d, h = _u(rng, 1.5, 2.0), _u(rng, 0.8, 1.1), _u(rng, 0.45, 0.6)
    t = 0.08
    parts = box((w, d, h), faces="no_top")
    parts += box((w - 2 * t, d - 2 * t, h * 0.8), (0, 0, h * 0.12),
                 faces="no_top")
    return parts


def _bed(rng):
    w, d = _u(rng, 1.6, 2.1), _u(rng, 1.1, 1.7)
    base_h = _u(rng, 0.3, 0.45)
    parts = box((w, d, base_h), (0, 0, base_h / 2))
    parts += box((w * 0.96, d * 0.96, 0.18), (0, 0, base_h + 0.09))
    head_h = _u(rng, 0.5, 0.9)
    parts += box((0.08, d, head_h), (-w / 2, 0, head_h / 2))
    if rng.random() < 0.5:
        parts += box((0.08, d, head_h * 0.55), (w / 2, 0, head_h * 0.27))
    parts += box((w * 0.5, d * 0.85, 0.06),
                 (-w * 0.2, 0, base_h + 0.2))  # folded blanket
    return parts


def _bench(rng):
    w, d = _u(rng, 1.5, 2.2), _u(rng, 0.35, 0.5)
    h = _u(rng, 0.4, 0.55)
    parts = _slab_on_legs(rng, w, d, h, 0.07)
    if rng.random() < 0.6:  # slatted back
        bh = _u(rng, 0.35, 0.55)
        parts += box((w, 0.05, bh), (0, -d / 2, h + bh / 2))
    return parts


def _bookshelf(rng):
    w, d, h = _u(rng, 0.8, 1.3), _u(rng, 0.28, 0.4), _u(rng, 1.5, 2.1)
    n_shelves = rng.integers(3, 6)
    parts = box((0.05, d, h), (-w / 2, 0, h / 2))
    parts += box((0.05, d, h), (w / 2, 0, h / 2))
    parts += box((w, d, 0.04), (0, 0, h - 0.02))
    parts += quad((-w / 2, d / 2, 0), (w, 0, 0), (0, 0, h))  # back panel
    for i in range(n_shelves):
        z = h * (i + 0.5) / n_shelves
        parts += box((w, d, 0.04), (0, 0, z))
        # books: a few upright boxes on the shelf
        x = -w / 2 + 0.1
        while x < w / 2 - 0.15 and i < n_shelves - 1:
            bw = _u(rng, 0.03, 0.07)
            bh = _u(rng, 0.18, 0.3)
            parts += box((bw, d * 0.7, bh), (x + bw / 2, 0, z + bh / 2),
                         faces="sides")
            x += bw + 0.015
    return parts


def _bottle(rng):
    r = _u(rng, 0.16, 0.24)
    h = _u(rng, 0.9, 1.3)
    neck_r = r * _u(rng, 0.3, 0.45)
    neck_h = h * _u(rng, 0.25, 0.4)
    parts = tube(r, h, (0, 0, h / 2), caps="bottom")
    parts += tube(r, neck_h * 0.4, (0, 0, h + neck_h * 0.2), r1=neck_r,
                  caps="none")
    parts += tube(neck_r, neck_h * 0.6, (0, 0, h + neck_h * 0.7),
                  caps="top")
    return parts


def _bowl(rng):
    r = _u(rng, 0.5, 0.8)
    sq = _u(rng, 0.45, 0.7)
    parts = ball(r, (0, 0, r * sq), squash=(1, 1, sq), top_frac=0.5)
    parts += ball(r * 0.92, (0, 0, r * sq * 1.02), squash=(1, 1, sq),
                  top_frac=0.5)
    parts += disk(r * 0.35, (0, 0, 0.01))
    return parts


def _car(rng):
    L, W = _u(rng, 1.8, 2.4), _u(rng, 0.8, 1.1)
    body_h = _u(rng, 0.35, 0.5)
    parts = box((L, W, body_h), (0, 0, 0.2 + body_h / 2))
    cab_l = L * _u(rng, 0.4, 0.55)
    cab_h = _u(rng, 0.3, 0.4)
    parts += box((cab_l, W * 0.9, cab_h),
                 (_u(rng, -0.2, 0.1), 0, 0.2 + body_h + cab_h / 2))
    wr = _u(rng, 0.16, 0.22)
    for x in (-L * 0.32, L * 0.32):
        for y in (-W / 2, W / 2):
            parts += tube(wr, 0.1, (x, y, wr), axis="y")
    return parts


def _chair(rng):
    w = _u(rng, 0.45, 0.6)
    seat_h = _u(rng, 0.42, 0.5)
    parts = _slab_on_legs(rng, w, w, seat_h, 0.06)
    bh = _u(rng, 0.45, 0.65)
    parts += box((w, 0.05, bh), (0, -w / 2 + 0.025, seat_h + bh / 2))
    if rng.random() < 0.4:  # armrests
        for s in (-1, 1):
            parts += box((w * 0.8, 0.05, 0.05),
                         (0, s * (w / 2 - 0.02), seat_h + 0.22))
            parts += box((0.05, 0.05, 0.22),
                         (w * 0.3, s * (w / 2 - 0.02), seat_h + 0.11))
    return parts


def _cone_shape(rng):
    r = _u(rng, 0.45, 0.7)
    h = _u(rng, 0.9, 1.4)
    return tube(r, h, (0, 0, h / 2), r1=0.001, caps="bottom")


def _cup(rng):
    r = _u(rng, 0.3, 0.45)
    h = _u(rng, 0.6, 0.9)
    r_top = r * _u(rng, 1.0, 1.25)
    parts = tube(r, h, (0, 0, h / 2), r1=r_top, caps="bottom")
    parts += tube(r * 0.96, h * 0.96, (0, 0, h * 0.52), r1=r_top * 0.96,
                  caps="none")
    if rng.random() < 0.7:  # handle
        parts += torus(h * 0.22, 0.04, (r_top * 1.05, 0, h * 0.55), axis="y")
    return parts


def _curtain(rng):
    w, h = _u(rng, 1.0, 1.8), _u(rng, 1.8, 2.4)
    folds = rng.integers(5, 9)
    parts = []
    amp = _u(rng, 0.05, 0.1)
    # vertical ruffled sheet: narrow vertical quads alternating in depth
    xs = np.linspace(-w / 2, w / 2, folds + 1)
    for i in range(folds):
        y = amp * (1 if i % 2 == 0 else -1)
        parts += quad((xs[i], y, 0), (xs[i + 1] - xs[i], -2 * y, 0),
                      (0, 0, h))
    parts += tube(0.03, w * 1.1, (0, 0, h + 0.03), axis="x")  # rod
    return parts


def _desk(rng):
    w, d, h = _u(rng, 1.2, 1.7), _u(rng, 0.6, 0.8), _u(rng, 0.72, 0.8)
    parts = box((w, d, 0.06), (0, 0, h - 0.03))
    # pedestal of drawers on one side + legs on the other
    pw = w * _u(rng, 0.25, 0.35)
    parts += box((pw, d * 0.95, h - 0.06), (w / 2 - pw / 2, 0, (h - 0.06) / 2))
    parts += _legs(rng, w * 0.5, d, h - 0.06, n=2)
    if rng.random() < 0.5:  # modesty panel
        parts += quad((-w / 2, -d / 2 + 0.05, h * 0.25), (w * 0.6, 0, 0),
                      (0, 0, h * 0.55))
    return parts


def _door(rng):
    w, h = _u(rng, 0.8, 1.0), _u(rng, 1.9, 2.3)
    parts = box((w, 0.05, h), (0, 0, h / 2))
    parts += ball(0.04, (w / 2 - 0.08, 0.07, h * 0.48))  # knob
    if rng.random() < 0.5:  # recessed panels as raised quads
        for zc in (h * 0.3, h * 0.7):
            parts += box((w * 0.7, 0.02, h * 0.3), (0, 0.035, zc),
                         faces="sides")
    return parts


def _dresser(rng):
    w, d, h = _u(rng, 0.9, 1.3), _u(rng, 0.45, 0.55), _u(rng, 0.8, 1.1)
    parts = box((w, d, h), (0, 0, h / 2))
    n_dr = rng.integers(3, 5)
    for i in range(n_dr):
        z = h * (i + 0.5) / n_dr
        parts += ball(0.025, (0, -d / 2 - 0.03, z))  # knob
        parts += box((w * 0.9, 0.02, h / n_dr * 0.8), (0, -d / 2, z),
                     faces="sides")
    return parts


def _flower_pot(rng):
    r = _u(rng, 0.3, 0.45)
    h = _u(rng, 0.5, 0.7)
    parts = tube(r * 0.7, h, (0, 0, h / 2), r1=r, caps="bottom")
    parts += disk(r * 0.95, (0, 0, h * 0.98))  # soil
    # plant: a few elliptic leaves on stems
    for _ in range(rng.integers(3, 7)):
        ang = rng.uniform(0, 2 * np.pi)
        lean = rng.uniform(0.1, 0.35)
        lh = _u(rng, 0.4, 0.8)
        top = (lean * np.cos(ang), lean * np.sin(ang), h + lh)
        parts += tube(0.015, lh, (top[0] / 2, top[1] / 2, h + lh / 2),
                      caps="none")
        parts += ball(0.12, top, squash=(1, 0.4, 1.6))
    return parts


def _glass_box(rng):
    w, d, h = (_u(rng, 0.7, 1.2) for _ in range(3))
    parts = box((w, d, h), (0, 0, h / 2))
    parts += box((w * 0.96, d * 0.96, h * 0.96), (0, 0, h / 2))  # double wall
    return parts


def _guitar(rng):
    body_l = _u(rng, 0.8, 1.0)
    t = _u(rng, 0.12, 0.18)
    parts = ball(body_l * 0.32, (0, 0, 0), squash=(1, 1.25, t))
    parts += ball(body_l * 0.26, (0, body_l * 0.28, 0), squash=(1, 1.1, t))
    neck_l = body_l * _u(rng, 0.9, 1.1)
    parts += box((0.07, neck_l, 0.04), (0, body_l * 0.45 + neck_l / 2, 0))
    parts += box((0.09, 0.18, 0.035), (0, body_l * 0.45 + neck_l + 0.09, 0))
    return parts


def _keyboard(rng):
    w, d = _u(rng, 1.2, 1.6), _u(rng, 0.4, 0.55)
    parts = box((w, d, 0.06), (0, 0, 0.03))
    nx, ny = rng.integers(12, 16), rng.integers(4, 6)
    for i in range(nx):
        for j in range(ny):
            x = -w / 2 + (i + 0.5) * w / nx
            y = -d / 2 + (j + 0.5) * d / ny
            parts += box((w / nx * 0.7, d / ny * 0.7, 0.025),
                         (x, y, 0.072), faces="no_bottom")
    return parts


def _lamp(rng):
    base_r = _u(rng, 0.25, 0.4)
    pole_h = _u(rng, 1.0, 1.6)
    parts = tube(base_r, 0.05, (0, 0, 0.025))
    parts += tube(0.03, pole_h, (0, 0, 0.05 + pole_h / 2), caps="none")
    shade_r = _u(rng, 0.3, 0.45)
    shade_h = _u(rng, 0.25, 0.4)
    parts += tube(shade_r, shade_h, (0, 0, 0.05 + pole_h + shade_h / 2),
                  r1=shade_r * _u(rng, 0.55, 0.75), caps="none")
    return parts


def _laptop(rng):
    w, d = _u(rng, 0.9, 1.2), _u(rng, 0.6, 0.8)
    parts = box((w, d, 0.04), (0, 0, 0.02))
    ang = _u(rng, 95, 125)
    R = _rot("x", ang - 90)
    parts += box((w, d, 0.03), tuple(R @ np.array([0, d / 2, 0])
                                     + np.array([0, -d / 2, 0.04])), rot=R)
    return parts


def _mantel(rng):
    w, d, h = _u(rng, 1.4, 1.9), _u(rng, 0.3, 0.45), _u(rng, 1.0, 1.3)
    leg_w = w * _u(rng, 0.15, 0.2)
    parts = box((leg_w, d, h), (-(w - leg_w) / 2, 0, h / 2))
    parts += box((leg_w, d, h), ((w - leg_w) / 2, 0, h / 2))
    parts += box((w, d, 0.18), (0, 0, h + 0.09))
    parts += box((w * 1.1, d * 1.15, 0.06), (0, 0, h + 0.21))
    parts += quad((-w / 2 + leg_w, d / 2, 0), (w - 2 * leg_w, 0, 0),
                  (0, 0, h))  # back of the opening
    return parts


def _monitor(rng):
    w = _u(rng, 1.0, 1.4)
    hh = w * _u(rng, 0.55, 0.62)
    parts = box((w, 0.06, hh), (0, 0, 0.5 + hh / 2))
    parts += box((w * 0.92, 0.02, hh * 0.88), (0, -0.04, 0.5 + hh / 2),
                 faces="sides")
    parts += tube(0.04, 0.45, (0, 0, 0.27), caps="none")
    parts += box((w * 0.35, 0.25, 0.04), (0, 0, 0.02))
    return parts


def _night_stand(rng):
    w = _u(rng, 0.45, 0.6)
    h = _u(rng, 0.5, 0.65)
    d = w * _u(rng, 0.85, 1.0)
    leg_h = 0.08
    parts = box((w, d, h - leg_h), (0, 0, leg_h + (h - leg_h) / 2))
    parts += _legs(rng, w, d, leg_h, thick=0.04)
    for i in range(2):
        z = leg_h + (h - leg_h) * (i + 0.5) / 2
        parts += ball(0.02, (0, -d / 2 - 0.025, z))
    return parts


def _person(rng):
    H = _u(rng, 1.7, 1.95)
    torso_h = H * 0.32
    parts = ball(H * 0.07, (0, 0, H * 0.93))  # head
    parts += tube(H * 0.025, H * 0.05, (0, 0, H * 0.855), caps="none")
    parts += tube(H * 0.1, torso_h, (0, 0, H * 0.66),
                  r1=H * 0.085, caps="none")  # torso
    for s in (-1, 1):  # arms
        ang = rng.uniform(5, 30)
        R = _rot("y", s * ang)
        top = np.array([s * H * 0.13, 0, H * 0.8])
        mid = top + R @ np.array([0, 0, -H * 0.32])
        parts += tube(H * 0.028, H * 0.32,
                      tuple((top + mid) / 2), caps="none")
    for s in (-1, 1):  # legs
        parts += tube(H * 0.045, H * 0.48, (s * H * 0.06, 0, H * 0.24),
                      caps="none")
        parts += box((H * 0.06, H * 0.14, H * 0.03),
                     (s * H * 0.06, -H * 0.03, H * 0.015))
    return parts


def _piano(rng):
    w, d, h = _u(rng, 1.4, 1.7), _u(rng, 0.55, 0.7), _u(rng, 1.1, 1.35)
    parts = box((w, d * 0.6, h), (0, d * 0.2, h / 2))  # upright body
    parts += box((w, d * 0.45, 0.08), (0, -d * 0.28, 0.75))  # key bed
    nk = 24
    for i in range(nk):
        x = -w / 2 + (i + 0.5) * w / nk
        parts += box((w / nk * 0.8, d * 0.4, 0.02), (x, -d * 0.28, 0.8),
                     faces="no_bottom")
    parts += _legs(rng, w, d, 0.7, n=2)
    if rng.random() < 0.5:  # pedal box
        parts += box((0.3, 0.15, 0.1), (0, -d * 0.2, 0.1))
    return parts


def _plant(rng):
    r = _u(rng, 0.2, 0.3)
    h = _u(rng, 0.25, 0.4)
    parts = tube(r * 0.75, h, (0, 0, h / 2), r1=r, caps="bottom")
    for _ in range(rng.integers(8, 16)):  # bushy foliage blobs
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0, 0.35)
        z = h + rng.uniform(0.1, 0.8)
        parts += ball(_u(rng, 0.1, 0.22),
                      (rad * np.cos(ang), rad * np.sin(ang), z))
    return parts


def _radio(rng):
    w, d, h = _u(rng, 0.8, 1.1), _u(rng, 0.3, 0.4), _u(rng, 0.5, 0.7)
    parts = box((w, d, h), (0, 0, h / 2))
    parts += tube(h * 0.28, 0.03, (w * 0.2, -d / 2, h * 0.5), axis="y")
    parts += ball(0.03, (-w * 0.25, -d / 2 - 0.02, h * 0.3))
    parts += ball(0.03, (-w * 0.1, -d / 2 - 0.02, h * 0.3))
    if rng.random() < 0.6:  # antenna
        parts += tube(0.012, _u(rng, 0.5, 0.9), (-w * 0.4, 0, h + 0.3),
                      caps="none")
    return parts


def _range_hood(rng):
    w, d = _u(rng, 0.8, 1.1), _u(rng, 0.5, 0.65)
    parts = box((w, d, 0.12), (0, 0, 0.06))
    duct_w = w * _u(rng, 0.3, 0.4)
    duct_h = _u(rng, 0.7, 1.1)
    # tapered hood section
    taper_h = _u(rng, 0.3, 0.45)
    for frac in np.linspace(0, 1, 6):
        ww = w + (duct_w - w) * frac
        dd = d + (duct_w * 0.8 - d) * frac
        parts += box((ww, dd, taper_h / 6),
                     (0, 0, 0.12 + taper_h * (frac + 0.08)), faces="sides")
    parts += box((duct_w, duct_w * 0.8, duct_h),
                 (0, 0, 0.12 + taper_h + duct_h / 2))
    return parts


def _sink(rng):
    w, d = _u(rng, 0.8, 1.1), _u(rng, 0.5, 0.65)
    h = _u(rng, 0.75, 0.9)
    parts = box((w, d, 0.08), (0, 0, h - 0.04))
    basin_w = w * 0.6
    parts += box((basin_w, d * 0.7, 0.3), (0, 0, h - 0.2), faces="no_top")
    parts += tube(0.05, h - 0.3, (0, 0, (h - 0.3) / 2), caps="none")  # pedestal
    # faucet
    parts += tube(0.025, 0.25, (0, d * 0.28, h + 0.12), caps="none")
    parts += tube(0.02, 0.18, (0, d * 0.2, h + 0.25), axis="y", caps="none")
    return parts


def _sofa(rng):
    w, d = _u(rng, 1.6, 2.2), _u(rng, 0.8, 1.0)
    seat_h = _u(rng, 0.35, 0.45)
    back_h = _u(rng, 0.4, 0.6)
    parts = box((w, d, seat_h), (0, 0, seat_h / 2))
    parts += box((w, 0.22, back_h), (0, -d / 2 + 0.11, seat_h + back_h / 2))
    for s in (-1, 1):
        parts += box((0.2, d, back_h * 0.6),
                     (s * (w / 2 - 0.1), 0, seat_h + back_h * 0.3))
    # seat cushions
    nc = rng.integers(2, 4)
    for i in range(nc):
        x = -w / 2 + (i + 0.5) * w / nc
        parts += box((w / nc * 0.92, d * 0.6, 0.1),
                     (x, d * 0.1, seat_h + 0.05))
    return parts


def _stairs(rng):
    n = rng.integers(5, 9)
    w = _u(rng, 0.9, 1.3)
    run = _u(rng, 0.25, 0.33)
    rise = _u(rng, 0.16, 0.22)
    parts = []
    for i in range(n):
        parts += box((w, run, rise),
                     (0, (i + 0.5) * run, (i + 0.5) * rise), faces="all")
    return parts


def _stool(rng):
    r = _u(rng, 0.18, 0.26)
    h = _u(rng, 0.55, 0.8)
    parts = tube(r, 0.05, (0, 0, h - 0.025))
    # splayed round legs, evenly spaced around the seat
    n_legs = int(rng.integers(3, 5))
    for k in range(n_legs):
        ang = 2 * np.pi * k / n_legs + 0.4
        top = np.array([0.6 * r * np.cos(ang), 0.6 * r * np.sin(ang), h])
        bot = np.array([1.4 * r * np.cos(ang), 1.4 * r * np.sin(ang), 0])
        parts += tube(0.025, h, tuple((top + bot) / 2), caps="none")
    return parts


def _table(rng):
    w = _u(rng, 1.0, 1.6)
    d = w * _u(rng, 0.55, 1.0)
    h = _u(rng, 0.7, 0.78)
    return _slab_on_legs(rng, w, d, h, 0.05)


def _tent(rng):
    w, d = _u(rng, 1.4, 2.0), _u(rng, 1.2, 1.8)
    h = _u(rng, 0.9, 1.3)
    parts = quad((-w / 2, -d / 2, 0), (0, d, 0), (w / 2, 0, h))
    parts += quad((w / 2, -d / 2, 0), (0, d, 0), (-w / 2, 0, h))
    parts += quad((-w / 2, -d / 2, 0), (w, 0, 0), (0, d, 0))  # floor
    # triangular ends as two slanted quads each (approximate with quads)
    parts += quad((-w / 2, -d / 2, 0), (w / 2, 0, h), (w, 0, 0))
    parts += quad((-w / 2, d / 2, 0), (w / 2, 0, h), (w, 0, 0))
    return parts


def _toilet(rng):
    parts = box((0.5, 0.25, 0.75), (0, -0.3, 0.375))  # tank
    parts += tube(0.26, 0.4, (0, 0.05, 0.2), r1=0.3, caps="bottom")  # base
    parts += torus(0.26, 0.05, (0, 0.08, 0.43))  # seat rim
    parts += disk(0.24, (0, 0.08, 0.41))
    return parts


def _tv_stand(rng):
    w, d, h = _u(rng, 1.4, 1.9), _u(rng, 0.4, 0.55), _u(rng, 0.45, 0.6)
    parts = box((w, d, h), (0, 0, h / 2))
    parts += box((w, d, 0.05), (0, 0, h + 0.025))
    # open shelf cavity
    parts += box((w * 0.55, d * 0.9, h * 0.4), (0, 0, h * 0.55),
                 faces="sides")
    for s in (-1, 1):
        parts += ball(0.02, (s * w * 0.35, -d / 2 - 0.02, h * 0.3))
    return parts


def _vase(rng):
    h = _u(rng, 0.9, 1.4)
    rb = _u(rng, 0.25, 0.4)
    rn = rb * _u(rng, 0.35, 0.55)
    rt = rn * _u(rng, 1.2, 1.8)
    parts = tube(rb * 0.5, h * 0.1, (0, 0, h * 0.05), r1=rb, caps="bottom")
    parts += tube(rb, h * 0.45, (0, 0, h * 0.325), r1=rb * 0.9, caps="none")
    parts += tube(rb * 0.9, h * 0.25, (0, 0, h * 0.675), r1=rn, caps="none")
    parts += tube(rn, h * 0.2, (0, 0, h * 0.9), r1=rt, caps="none")
    return parts


def _wardrobe(rng):
    w, d, h = _u(rng, 1.0, 1.4), _u(rng, 0.55, 0.7), _u(rng, 1.8, 2.2)
    parts = box((w, d, h), (0, 0, h / 2))
    parts += box((0.015, 0.015, h * 0.35), (-w * 0.05, -d / 2 - 0.02, h * 0.5),
                 faces="sides")
    parts += box((0.015, 0.015, h * 0.35), (w * 0.05, -d / 2 - 0.02, h * 0.5),
                 faces="sides")
    return parts


def _xbox(rng):
    w, d, h = _u(rng, 0.75, 0.95), _u(rng, 0.55, 0.75), _u(rng, 0.16, 0.24)
    parts = box((w, d, h), (0, 0, h / 2))
    parts += tube(h * 0.6, 0.02, (w * 0.18, -d / 2, h / 2), axis="y")  # disc slot bulge
    parts += ball(h * 0.35, (0, 0, h), squash=(1, 1, 0.35), top_frac=0.5)
    return parts


CLASS_BUILDERS = {
    "airplane": _airplane, "bathtub": _bathtub, "bed": _bed,
    "bench": _bench, "bookshelf": _bookshelf, "bottle": _bottle,
    "bowl": _bowl, "car": _car, "chair": _chair, "cone": _cone_shape,
    "cup": _cup, "curtain": _curtain, "desk": _desk, "door": _door,
    "dresser": _dresser, "flower_pot": _flower_pot, "glass_box": _glass_box,
    "guitar": _guitar, "keyboard": _keyboard, "lamp": _lamp,
    "laptop": _laptop, "mantel": _mantel, "monitor": _monitor,
    "night_stand": _night_stand, "person": _person, "piano": _piano,
    "plant": _plant, "radio": _radio, "range_hood": _range_hood,
    "sink": _sink, "sofa": _sofa, "stairs": _stairs, "stool": _stool,
    "table": _table, "tent": _tent, "toilet": _toilet,
    "tv_stand": _tv_stand, "vase": _vase, "wardrobe": _wardrobe,
    "xbox": _xbox,
}
CLASS_NAMES = list(CLASS_BUILDERS)
assert len(CLASS_NAMES) == 40


def make_shape(class_idx: int, rng, npoints: int = 2048,
               with_normals: bool = False) -> np.ndarray:
    """One unit-sphere Y-up cloud of the given class: (npoints, 3), or
    (npoints, 6) with outward unit normals when with_normals (the
    modelnet40_normal_resampled txt variant)."""
    parts = CLASS_BUILDERS[CLASS_NAMES[class_idx]](rng)
    pts, nrm = sample_parts(parts, rng, npoints)
    # z-up -> y-up (ModelNet40 convention; train-time rotation is about Y)
    pts = pts[:, [0, 2, 1]].astype(np.float64)
    pts[:, 2] = -pts[:, 2]  # keep right-handedness
    nrm = nrm[:, [0, 2, 1]].astype(np.float64)
    nrm[:, 2] = -nrm[:, 2]
    # per-instance anisotropic jitter of proportions + noise
    scale = rng.uniform(0.85, 1.15, (1, 3))
    pts *= scale
    pts += rng.normal(0, 0.004, pts.shape)
    # center + unit sphere, like the reference's files (isotropic; normals
    # only need the inverse-transpose of the anisotropic part)
    pts -= pts.mean(0, keepdims=True)
    pts /= np.max(np.linalg.norm(pts, axis=1)) + 1e-12
    # Shuffle row order: points as sampled are grouped by part, and the
    # loaders (like the reference's) take the FIRST npoints rows — a
    # part-ordered file makes that slice drop whole parts. Real ModelNet40
    # files are order-unbiased; measured on the 251-epoch r3 run, the
    # part-ordered v1 layout depressed unshuffled single-view eval to
    # 0.81 while any point-shuffled eval (the vote protocol) scored 0.99+.
    perm = rng.permutation(len(pts))
    pts = pts[perm]
    nrm = nrm[perm]
    if not with_normals:
        return pts.astype(np.float32)
    nrm /= scale
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-12
    return np.concatenate([pts, nrm], 1).astype(np.float32)


def generate(out_dir: str, train_per_class: int = 246,
             test_per_class: int = 62, npoints: int = 2048,
             seed: int = 0, file_cap: int = 2048) -> None:
    """Write the dataset in the modelnet40_ply_hdf5_2048 layout:
    ply_data_{split}N.h5 (data (M,2048,3) f32, label (M,1) u8) plus
    {split}_files.txt list files and shape_names.txt."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, per_class in (("train", train_per_class),
                             ("test", test_per_class)):
        labels = np.repeat(np.arange(40), per_class)
        rng.shuffle(labels)
        files = []
        for fi, start in enumerate(range(0, len(labels), file_cap)):
            chunk = labels[start:start + file_cap]
            data = np.stack([make_shape(c, rng, npoints) for c in chunk])
            fn = f"ply_data_{split}{fi}.h5"
            with h5py.File(os.path.join(out_dir, fn), "w") as h5:
                h5.create_dataset("data", data=data, compression="gzip")
                h5.create_dataset(
                    "label", data=chunk.astype(np.uint8)[:, None],
                    compression="gzip")
            files.append(fn)
        with open(os.path.join(out_dir, f"{split}_files.txt"), "w") as f:
            f.write("".join(fn + "\n" for fn in files))
    with open(os.path.join(out_dir, "shape_names.txt"), "w") as f:
        f.write("".join(n + "\n" for n in CLASS_NAMES))


def generate_txt(out_dir: str, train_per_class: int = 60,
                 test_per_class: int = 15, npoints: int = 2500,
                 seed: int = 0) -> None:
    """Write the modelnet40_normal_resampled txt layout consumed by
    ModelNetDataset (modelnet_dataset.py:23-128): shape_names /
    train / test id lists plus one x,y,z,nx,ny,nz CSV per shape.
    Enables the --normal pipeline (normal-aware augmentation, the MSG
    5000-pt recipe at npoints >= 5000) on procedural data."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(os.path.join(out_dir, "modelnet40_shape_names.txt"), "w") as f:
        f.write("".join(n + "\n" for n in CLASS_NAMES))
    ids = {"train": [], "test": []}
    for ci, name in enumerate(CLASS_NAMES):
        cdir = os.path.join(out_dir, name)
        os.makedirs(cdir, exist_ok=True)
        for k in range(train_per_class + test_per_class):
            split = "train" if k < train_per_class else "test"
            sid = f"{name}_{k + 1:04d}"
            ids[split].append(sid)
            cloud = make_shape(ci, rng, npoints, with_normals=True)
            np.savetxt(os.path.join(cdir, sid + ".txt"), cloud,
                       fmt="%.6f", delimiter=",")
    for split, lst in ids.items():
        with open(os.path.join(out_dir, f"modelnet40_{split}.txt"), "w") as f:
            f.write("".join(s + "\n" for s in lst))


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--format", default="h5", choices=["h5", "txt"],
                    help="h5 = modelnet40_ply_hdf5_2048 layout (xyz); "
                         "txt = modelnet40_normal_resampled layout "
                         "(xyz+normal, --normal pipeline)")
    ap.add_argument("--train_per_class", type=int, default=None)
    ap.add_argument("--test_per_class", type=int, default=None)
    ap.add_argument("--npoints", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.format == "h5":
        tr, te = args.train_per_class or 246, args.test_per_class or 62
        generate(args.out, tr, te, args.npoints or 2048, args.seed)
    else:
        tr, te = args.train_per_class or 60, args.test_per_class or 15
        generate_txt(args.out, tr, te, args.npoints or 2500, args.seed)
    print(f"wrote {args.out} [{args.format}]: {tr * 40} train / "
          f"{te * 40} test shapes")


if __name__ == "__main__":
    main()
