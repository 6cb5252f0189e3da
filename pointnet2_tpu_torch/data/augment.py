"""Host-side point-cloud augmentations (numpy).

The port's copy of pointnet2_tpu/data/augment.py:17-215, operation for
operation, so the same ``np.random.Generator`` seed gives the same bits:
rotations (random about y, about z for ScanNet, by a fixed angle for vote
ensembling, small perturbations about all three axes; row-vector
convention, points @ R, normal-aware for 6-channel clouds), scaling,
shifting, jitter, point shuffling, random input dropout, and the two
ModelNet training chains: ``augment_cls_batch`` (the HDF5 data,
modelnet_h5_dataset.py:72-79) and ``augment_cls_batch_with_normals`` (the
txt data with normals, modelnet_dataset.py:60-72, then the input dropout).
Every function takes the generator (or a seed) explicitly and never
mutates its input.
"""

from __future__ import annotations

import numpy as np


def _as_rng(rng) -> np.random.Generator:
    return (rng if isinstance(rng, np.random.Generator)
            else np.random.default_rng(rng))


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


def _rot_xyz(angles: np.ndarray) -> np.ndarray:
    """(B, 3) Euler angles -> (B, 3, 3) R = Rz @ Ry @ Rx applied as
    points @ R (provider.py:102-111 row-vector convention)."""
    ax, ay, az = angles[:, 0], angles[:, 1], angles[:, 2]
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    z, o = np.zeros_like(ax), np.ones_like(ax)
    Rx = np.stack([np.stack([o, z, z], -1),
                   np.stack([z, cx, -sx], -1),
                   np.stack([z, sx, cx], -1)], axis=-2)
    Ry = np.stack([np.stack([cy, z, sy], -1),
                   np.stack([z, o, z], -1),
                   np.stack([-sy, z, cy], -1)], axis=-2)
    Rz = np.stack([np.stack([cz, -sz, z], -1),
                   np.stack([sz, cz, z], -1),
                   np.stack([z, z, o], -1)], axis=-2)
    return (Rz @ (Ry @ Rx)).astype(np.float32)


def _apply_rot(batch: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Rotate xyz (and normals if 6 channels) by per-cloud matrices."""
    out = batch.astype(np.float32).copy()
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch[:, :, 0:3], R)
    if batch.shape[-1] >= 6:
        out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch[:, :, 3:6], R)
    return out


def shuffle_data(data: np.ndarray, labels: np.ndarray, rng):
    """Shuffle examples and their labels in unison (provider.py:8-18).

    Returns (shuffled_data, shuffled_labels, permutation)."""
    rng = _as_rng(rng)
    idx = rng.permutation(data.shape[0])
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch: np.ndarray, rng) -> np.ndarray:
    """Shuffle point order, one permutation for the whole batch
    (provider.py:20-30)."""
    rng = _as_rng(rng)
    idx = rng.permutation(batch.shape[1])
    return batch[:, idx, :]


def rotate_point_cloud(batch: np.ndarray, rng) -> np.ndarray:
    """Per-cloud random rotation about the up (y) axis."""
    rng = _as_rng(rng)
    angles = rng.uniform(0, 2 * np.pi, batch.shape[0])
    return _apply_rot(batch, _rot_y(angles))


def rotate_point_cloud_z(batch: np.ndarray, rng) -> np.ndarray:
    """Per-cloud random rotation about the z axis (ScanNet convention): one
    ``rng.uniform(0, 2pi, B)`` draw, as JAX's."""
    rng = _as_rng(rng)
    angles = rng.uniform(0, 2 * np.pi, batch.shape[0])
    return _apply_rot(batch, _rot_z(angles))


def rotate_point_cloud_by_angle(batch: np.ndarray, angle: float) -> np.ndarray:
    """Deterministic y-rotation by a fixed angle (vote ensembling)."""
    angles = np.full(batch.shape[0], angle)
    return _apply_rot(batch, _rot_y(angles))


def rotate_point_cloud_with_normal(batch: np.ndarray, rng) -> np.ndarray:
    """Random y-rotation of xyz and normals (provider.py:72-90): every
    rotation here is 6-channel aware, so this is rotate_point_cloud under
    the reference's name."""
    return rotate_point_cloud(batch, rng)


def rotate_point_cloud_by_angle_with_normal(batch: np.ndarray,
                                            angle: float) -> np.ndarray:
    """Deterministic y-rotation with normals (provider.py:138-160)."""
    return rotate_point_cloud_by_angle(batch, angle)


def rotate_perturbation_point_cloud_with_normal(
        batch: np.ndarray, rng, angle_sigma: float = 0.06,
        angle_clip: float = 0.18) -> np.ndarray:
    """Small 3-axis perturbation with normals (provider.py:92-117)."""
    return rotate_perturbation_point_cloud(batch, rng, angle_sigma,
                                           angle_clip)


def rotate_perturbation_point_cloud(batch: np.ndarray, rng,
                                    angle_sigma: float = 0.06,
                                    angle_clip: float = 0.18) -> np.ndarray:
    """Small random rotations about all three axes."""
    rng = _as_rng(rng)
    angles = np.clip(angle_sigma * rng.standard_normal((batch.shape[0], 3)),
                     -angle_clip, angle_clip)
    return _apply_rot(batch, _rot_xyz(angles))


def jitter_point_cloud(batch: np.ndarray, rng, sigma: float = 0.01,
                       clip: float = 0.05) -> np.ndarray:
    """Per-point Gaussian jitter, clipped (xyz channels only)."""
    if clip <= 0:
        raise ValueError(f"clip must be positive, got {clip}")
    rng = _as_rng(rng)
    out = batch.astype(np.float32).copy()
    noise = np.clip(sigma * rng.standard_normal(out[:, :, 0:3].shape),
                    -clip, clip).astype(np.float32)
    out[:, :, 0:3] += noise
    return out


def shift_point_cloud(batch: np.ndarray, rng,
                      shift_range: float = 0.1) -> np.ndarray:
    """Per-cloud uniform translation."""
    rng = _as_rng(rng)
    out = batch.astype(np.float32).copy()
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch.shape[0], 1, 3)).astype(np.float32)
    out[:, :, 0:3] += shifts
    return out


def random_scale_point_cloud(batch: np.ndarray, rng, scale_low: float = 0.8,
                             scale_high: float = 1.25) -> np.ndarray:
    """Per-cloud uniform scaling."""
    rng = _as_rng(rng)
    out = batch.astype(np.float32).copy()
    scales = rng.uniform(scale_low, scale_high,
                         (batch.shape[0], 1, 1)).astype(np.float32)
    out[:, :, 0:3] *= scales
    return out


def random_point_dropout(batch: np.ndarray, rng,
                         max_dropout_ratio: float = 0.875) -> np.ndarray:
    """Replace a random fraction of each cloud's points with its first point
    (density augmentation, provider.py:227-234): a point is dropped where
    u <= ratio, ratio ~ U(0, max) a cloud."""
    rng = _as_rng(rng)
    out = batch.astype(np.float32).copy()
    B, N = batch.shape[:2]
    ratios = rng.random((B, 1)) * max_dropout_ratio
    drop = rng.random((B, N)) <= ratios
    out[drop] = np.repeat(out[:, 0:1, :], N, axis=1)[drop]
    return out


def augment_cls_batch(batch: np.ndarray, rng) -> np.ndarray:
    """The ModelNet40 classification training chain: rotate -> perturb ->
    scale -> shift -> jitter -> shuffle (modelnet_h5_dataset.py:72-79)."""
    rng = _as_rng(rng)
    out = rotate_point_cloud(batch, rng)
    out = rotate_perturbation_point_cloud(out, rng)
    out = random_scale_point_cloud(out, rng)
    out = shift_point_cloud(out, rng)
    out = jitter_point_cloud(out, rng)
    return shuffle_points(out, rng)


def augment_cls_batch_with_normals(batch: np.ndarray, rng) -> np.ndarray:
    """The chain for clouds with normals: rotate (normals too) -> perturb
    -> scale -> shift -> jitter (xyz only) -> shuffle -> random input
    dropout (modelnet_dataset.py:60-72, then the dropout the reference's
    train.py:201-202 leaves commented out)."""
    rng = _as_rng(rng)
    out = rotate_point_cloud(batch, rng)
    out = rotate_perturbation_point_cloud(out, rng)
    out = random_scale_point_cloud(out, rng)
    out = shift_point_cloud(out, rng)
    out = jitter_point_cloud(out, rng)
    out = shuffle_points(out, rng)
    return random_point_dropout(out, rng)
