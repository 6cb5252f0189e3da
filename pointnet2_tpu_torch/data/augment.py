"""Host-side point-cloud augmentations (numpy).

The port's copy of pointnet2_tpu/data/augment.py:17-41,63-69,96-106,
141-150: the deterministic y-rotation by a fixed angle for vote
ensembling and the random z-rotation of the chopped ScanNet evaluation,
row-vector convention (points @ R), normal-aware for 6-channel clouds; and
the per-point jitter of the synthetic dataset's host augmentation.
"""

from __future__ import annotations

import numpy as np


def _rot_y(angles: np.ndarray) -> np.ndarray:
    """(B,) angles -> (B, 3, 3) y-axis rotation matrices (row-vector
    convention: points @ R, matching provider.py:45-49)."""
    c, s = np.cos(angles), np.sin(angles)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, z, s], -1),
        np.stack([z, o, z], -1),
        np.stack([-s, z, c], -1),
    ], axis=-2).astype(np.float32)


def _rot_z(angles: np.ndarray) -> np.ndarray:
    c, s = np.cos(angles), np.sin(angles)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, s, z], -1),
        np.stack([-s, c, z], -1),
        np.stack([z, z, o], -1),
    ], axis=-2).astype(np.float32)


def _apply_rot(batch: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Rotate xyz (and normals if 6 channels) by per-cloud matrices."""
    out = batch.astype(np.float32).copy()
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch[:, :, 0:3], R)
    if batch.shape[-1] >= 6:
        out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch[:, :, 3:6], R)
    return out


def rotate_point_cloud_z(batch: np.ndarray, rng) -> np.ndarray:
    """Per-cloud random rotation about the z axis (ScanNet convention): one
    ``rng.uniform(0, 2pi, B)`` draw, as JAX's."""
    rng = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(rng)
    angles = rng.uniform(0, 2 * np.pi, batch.shape[0])
    return _apply_rot(batch, _rot_z(angles))


def rotate_point_cloud_by_angle(batch: np.ndarray, angle: float) -> np.ndarray:
    """Deterministic y-rotation by a fixed angle (vote ensembling)."""
    angles = np.full(batch.shape[0], angle)
    return _apply_rot(batch, _rot_y(angles))


def jitter_point_cloud(batch: np.ndarray, rng: np.random.Generator,
                       sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    """Per-point Gaussian jitter, clipped (xyz channels only)."""
    if clip <= 0:
        raise ValueError(f"clip must be positive, got {clip}")
    out = batch.astype(np.float32).copy()
    noise = np.clip(sigma * rng.standard_normal(out[:, :, 0:3].shape),
                    -clip, clip).astype(np.float32)
    out[:, :, 0:3] += noise
    return out
