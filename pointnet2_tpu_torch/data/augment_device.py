"""On-device point-cloud augmentation for training.

Counterpart of pointnet2_tpu/data/augment_jax.py:19-154, run on the batch's
device inside the train step: the ModelNet40 chain rotate_y ->
rotate_perturbation -> random_scale -> shift -> jitter -> shuffle_points
(modelnet_h5_dataset.py:72-79, ``augment_cls``); the same chain with
random input dropout last, for clouds with normals
(``augment_cls_normals``); and the ScanNet rotation about z
(``augment_scannet``, scannet/train.py:230).

Each transform is split in two: ``draw_<name>(generator, batch)`` draws its
parameters from a ``torch.Generator`` on the batch's device, and
``<name>(batch, params)`` applies given parameters. ``torch`` and
``jax.random`` give different numbers from one seed, so tests hand both
sides the same parameters. In a cross-replica train step (several ranks,
nn/layers.py's ``cross_replica``) each draw is made for the global batch
and the rank applies its own rows of it, so every rank's generator stays
in step with the others' and with one process's on the same global batch.
Rotations are float32 matmuls in full float32
(TF32 off, ``config.disable_tf32``), row-vector convention (points @ R),
normal-aware for 6-channel clouds.
"""

from __future__ import annotations

import math

import torch

from pointnet2_tpu_torch.nn.layers import replica_rows


def _rot_y(angles: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


def _rot_z(angles: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1),
                        torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def _rot_xyz(angles: torch.Tensor) -> torch.Tensor:
    ax, ay, az = angles[:, 0], angles[:, 1], angles[:, 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    z, o = torch.zeros_like(ax), torch.ones_like(ax)
    Rx = torch.stack([torch.stack([o, z, z], -1),
                      torch.stack([z, cx, -sx], -1),
                      torch.stack([z, sx, cx], -1)], dim=-2)
    Ry = torch.stack([torch.stack([cy, z, sy], -1),
                      torch.stack([z, o, z], -1),
                      torch.stack([-sy, z, cy], -1)], dim=-2)
    Rz = torch.stack([torch.stack([cz, -sz, z], -1),
                      torch.stack([sz, cz, z], -1),
                      torch.stack([z, z, o], -1)], dim=-2)
    return Rz @ (Ry @ Rx)


def _apply_rot(batch: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    R = R.to(batch.dtype)  # float32 draws rotate a float64 batch too
    parts = [batch[..., 0:3] @ R]
    if batch.shape[-1] >= 6:
        parts += [batch[..., 3:6] @ R, batch[..., 6:]]
    else:
        parts.append(batch[..., 3:])
    return torch.cat(parts, dim=-1)


def _uniform(generator, shape, device, low, high) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (high - low) + low


def draw_rotate_y(generator, batch):
    return _uniform(generator, (batch.shape[0],), batch.device, 0.0,
                    2 * math.pi)


def rotate_y(batch, angles):
    """Rotate each cloud about the up axis by its angle (B,)."""
    return _apply_rot(batch, _rot_y(angles))


draw_rotate_z = draw_rotate_y  # one angle a cloud in [0, 2 pi)


def rotate_z(batch, angles):
    """Rotate each cloud about the z axis by its angle (B,)."""
    return _apply_rot(batch, _rot_z(angles))


def draw_rotate_perturbation(generator, batch, angle_sigma=0.06,
                             angle_clip=0.18):
    a = torch.randn((batch.shape[0], 3), generator=generator,
                    device=batch.device)
    return torch.clamp(angle_sigma * a, -angle_clip, angle_clip)


def rotate_perturbation(batch, angles):
    """Small rotation about x, then y, then z, by angles (B, 3)."""
    return _apply_rot(batch, _rot_xyz(angles))


def draw_random_scale(generator, batch, scale_low=0.8, scale_high=1.25):
    return _uniform(generator, (batch.shape[0], 1, 1), batch.device,
                    scale_low, scale_high)


def random_scale(batch, scales):
    """Scale each cloud's xyz by its factor (B, 1, 1)."""
    return torch.cat([batch[..., 0:3] * scales, batch[..., 3:]], dim=-1)


def draw_shift(generator, batch, shift_range=0.1):
    return _uniform(generator, (batch.shape[0], 1, 3), batch.device,
                    -shift_range, shift_range)


def shift(batch, shifts):
    """Translate each cloud's xyz by its offset (B, 1, 3)."""
    return torch.cat([batch[..., 0:3] + shifts, batch[..., 3:]], dim=-1)


def draw_jitter(generator, batch, sigma=0.01, clip=0.05):
    noise = torch.randn(batch[..., 0:3].shape, generator=generator,
                        device=batch.device)
    return torch.clamp(sigma * noise, -clip, clip)


def jitter(batch, noise):
    """Add per-point noise (B, N, 3) to xyz."""
    return torch.cat([batch[..., 0:3] + noise, batch[..., 3:]], dim=-1)


def draw_shuffle_points(generator, batch):
    return torch.randperm(batch.shape[1], generator=generator,
                          device=batch.device)


def shuffle_points(batch, perm):
    """Reorder the points of every cloud by one permutation (N,)."""
    return batch[:, perm, :]


def draw_random_point_dropout(generator, batch, max_dropout_ratio=0.875):
    B, N = batch.shape[:2]
    ratios = _uniform(generator, (B, 1), batch.device, 0.0, 1.0)
    u = torch.rand((B, N), generator=generator, device=batch.device)
    return u <= ratios * max_dropout_ratio


def random_point_dropout(batch, drop):
    """Replace the points where `drop` (B, N) is set by each cloud's point
    0, every channel."""
    return torch.where(drop[..., None], batch[:, 0:1, :].expand_as(batch),
                       batch)


CLS_CHAIN = (
    (draw_rotate_y, rotate_y),
    (draw_rotate_perturbation, rotate_perturbation),
    (draw_random_scale, random_scale),
    (draw_shift, shift),
    (draw_jitter, jitter),
    (draw_shuffle_points, shuffle_points),
)


# draws whose parameters every cloud shares (not one row a cloud)
_SHARED = (draw_shuffle_points,)


def _run_chain(chain, generator: torch.Generator, batch: torch.Tensor):
    """Each transform of ``chain`` in order, its parameters drawn for the
    global batch (a stand-in of the global shape: the draws read only the
    shape and the device) and cut to this rank's rows."""
    b = batch.shape[0]
    off, total = replica_rows(b)
    like = batch if total == b else batch[:1].expand(total, *batch.shape[1:])
    for draw, apply in chain:
        params = draw(generator, like)
        if draw not in _SHARED:
            params = params[off:off + b]
        batch = apply(batch, params)
    return batch


def augment_cls(generator: torch.Generator, batch: torch.Tensor):
    """rotate -> perturb -> scale -> shift -> jitter -> shuffle, each
    transform's parameters drawn from ``generator`` in that order."""
    return _run_chain(CLS_CHAIN, generator, batch)


CLS_NORMALS_CHAIN = CLS_CHAIN + (
    (draw_random_point_dropout, random_point_dropout),)


def augment_cls_normals(generator: torch.Generator, batch: torch.Tensor):
    """The cls chain, then random input dropout (the 5000-point xyz+normal
    recipe: modelnet_dataset.py:60-72 and train.py:201-202), each
    transform's parameters drawn from ``generator`` in that order."""
    return _run_chain(CLS_NORMALS_CHAIN, generator, batch)


SCANNET_CHAIN = ((draw_rotate_z, rotate_z),)


def augment_scannet(generator: torch.Generator, batch: torch.Tensor):
    """A rotation about z only (scannet/train.py:230)."""
    return _run_chain(SCANNET_CHAIN, generator, batch)
