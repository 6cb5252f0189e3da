"""Virtual scans: the points of a scene a camera would see, numpy only.

Port of pointnet2_tpu/utils/scene_util.py (the reference's
scene_util.py:20-63): a virtual camera at human height casts a 200 x 150
ray grid, each scene point goes to its nearest ray in spherical (azimuth,
elevation) coordinates, and only the closest point a ray is kept. The ray
grid is a regular lattice in the camera frame, so the point-to-ray
assignment inverts it analytically (O(N), no k-d tree), then refines over
a 3 x 3 window with the angular metric, as JAX's does.
"""

from __future__ import annotations

import numpy as np

_NX, _NY = 200, 150
_XLIM, _YLIM = 0.6, 0.45


def cart2sph(xyz: np.ndarray) -> np.ndarray:
    """(N,3) cartesian -> (azimuth, elevation, range)."""
    xy = xyz[:, 0] ** 2 + xyz[:, 1] ** 2
    aer = np.zeros_like(xyz)
    aer[:, 2] = np.sqrt(xy + xyz[:, 2] ** 2)
    aer[:, 1] = np.arctan2(xyz[:, 2], np.sqrt(xy))
    aer[:, 0] = np.arctan2(xyz[:, 1], xyz[:, 0])
    return aer


def virtual_scan(xyz: np.ndarray, mode: int = -1,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """Return indices of points visible from a virtual camera.

    mode in 0..7 selects one of 8 fixed view directions (pi/4 steps);
    mode=-1 draws a random view and REQUIRES rng (an explicit generator
    keeps the scan reproducible; erroring beats silently unseeded draws).
    """
    if mode == -1 and rng is None:
        raise TypeError("virtual_scan(mode=-1) requires an explicit rng "
                        "(pass np.random.default_rng(seed))")
    camloc = xyz.mean(axis=0)
    camloc[2] = 1.5  # human height
    if mode == -1:
        view_dr = np.array([2 * np.pi * rng.random(),
                            np.pi / 10 * (rng.random() - 0.75)])
        camloc[:2] -= (0.8 + 0.7 * rng.random()) * np.array(
            [np.cos(view_dr[0]), np.sin(view_dr[0])])
    else:
        view_dr = np.array([np.pi / 4 * mode, 0.0])
        camloc[:2] -= np.array([np.cos(view_dr[0]), np.sin(view_dr[0])])

    ct = np.array([np.cos(view_dr[1]) * np.cos(view_dr[0]),
                   np.cos(view_dr[1]) * np.sin(view_dr[0]),
                   np.sin(view_dr[1])])
    hr = np.cross(ct, [0.0, 0.0, 1.0])
    hr /= np.linalg.norm(hr)
    vt = np.cross(hr, ct)
    vt /= np.linalg.norm(vt)

    # Ray lattice: a regular (gx, gy) grid in the camera's tangent plane.
    xs = np.linspace(-_XLIM, _XLIM, _NX)
    ys = np.linspace(-_YLIM, _YLIM, _NY)
    gx, gy = np.meshgrid(xs, ys)
    rays = (gx.reshape(-1, 1) * hr + gy.reshape(-1, 1) * vt + ct)
    rays_aer = cart2sph(rays)
    ray_az = rays_aer[:, 0].reshape(_NY, _NX)
    ray_el = rays_aer[:, 1].reshape(_NY, _NX)

    local = xyz - camloc
    local_aer = cart2sph(local)

    # Nearest ray per point in (az, el) — brute force is O(N*R); instead
    # invert the lattice exactly in the CAMERA FRAME (u/w, v/w are the
    # point's tangent-plane coordinates; azimuth/elevation sorting breaks
    # down for cameras looking near the ±pi seam, the tangent plane never
    # does), then refine over a 3x3 window with the true angular metric.
    u = local @ hr
    v = local @ vt
    w = local @ ct
    in_front = w > 1e-9
    wsafe = np.where(in_front, w, 1.0)
    ci = np.clip(np.round((u / wsafe + _XLIM) / (2 * _XLIM / (_NX - 1))),
                 0, _NX - 1).astype(np.int64)
    ri = np.clip(np.round((v / wsafe + _YLIM) / (2 * _YLIM / (_NY - 1))),
                 0, _NY - 1).astype(np.int64)

    def ang_diff(a, b):  # wraps the azimuth seam
        return (a - b + np.pi) % (2 * np.pi) - np.pi

    best_d = np.full(len(xyz), np.inf)
    best_idx = np.zeros(len(xyz), np.int64)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r = np.clip(ri + dr, 0, _NY - 1)
            c = np.clip(ci + dc, 0, _NX - 1)
            d = (ang_diff(local_aer[:, 0], ray_az[r, c]) ** 2
                 + (local_aer[:, 1] - ray_el[r, c]) ** 2)
            upd = in_front & (d < best_d)
            best_d[upd] = d[upd]
            best_idx[upd] = (r * _NX + c)[upd]

    mindd = np.sqrt(best_d)
    sub = mindd < 0.01
    if sub.sum() < 100:
        return np.zeros(0, np.int64)
    sub_r = local_aer[sub, 2]
    sub_ray = best_idx[sub]
    # keep only the nearest point per ray (z-buffer)
    min_r = np.full(sub_ray.max() + 1, np.inf)
    np.minimum.at(min_r, sub_ray, sub_r)
    visible = sub_r <= min_r[sub_ray]
    smpidx = np.where(sub)[0]
    return smpidx[visible]
