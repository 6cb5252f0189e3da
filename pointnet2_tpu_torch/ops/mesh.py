"""Area-weighted mesh -> point-cloud sampling.

Port of pointnet2_tpu/ops/mesh.py (the reference's mesh-sampling demo,
tf_ops/sampling/tf_sampling.py:60-89): pick triangles with probability
proportional to their area (``prob_sample``), draw a uniform barycentric
point on each, then optionally reduce the draws to a uniformly spread
subset with farthest point sampling.

On CUDA tensors the corner gather and the reduction run the port's
kernels: the row gather (csrc/gather.cu) and FPS (csrc/fps.cu), which
answers any number of draws, as the JAX package's FPS does (above 16384
points on its thread-block-cluster route). The categorical draw is
``torch.cumsum`` + ``torch.searchsorted`` on every device. The draws come
from an explicit ``torch.Generator``, or are given as ``uniforms=(r, u,
v)``, the three (B, n_samples) uniform tensors of ``jax.random.split(key,
3)`` in the JAX package, so the same surface points can be drawn on both
sides.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.sampling import (
    farthest_point_sample,
    gather_point,
    prob_sample,
)

__all__ = ["triangle_areas", "sample_mesh"]


def triangle_areas(triangles: torch.Tensor) -> torch.Tensor:
    """Twice-area weights of each triangle: |cross(b - a, c - a)| (the 1/2
    cancels in the categorical draw), with a 1e-9 floor under the square
    root so degenerate triangles keep a tiny finite weight.

    triangles: (B, T, 3, 3) corners [a, b, c] on the last-but-one axis.
    Returns (B, T) float32.
    """
    a = triangles[:, :, 0, :]
    e1 = triangles[:, :, 1, :] - a
    e2 = triangles[:, :, 2, :] - a
    cross = torch.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                         e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                         e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]],
                        dim=-1).float()
    return torch.sqrt(torch.sum(cross * cross, dim=-1) + 1e-9)


def _uniforms(triangles: torch.Tensor, n_samples: int,
              generator: torch.Generator | None) -> tuple:
    """(r, u, v): (B, n_samples) uniforms in [0, 1), r in float32, u and v
    in the corners' dtype, from ``generator`` on the corners' device."""
    B = triangles.shape[0]
    draw = [torch.rand((B, n_samples), generator=generator,
                       device=triangles.device, dtype=dt)
            for dt in (torch.float32, triangles.dtype, triangles.dtype)]
    return tuple(draw)


def sample_mesh(triangles: torch.Tensor, n_samples: int,
                generator: torch.Generator | None = None,
                npoint: int | None = None, *,
                uniforms: tuple | None = None) -> torch.Tensor:
    """Sample a point cloud uniformly over a triangle mesh's surface.

    triangles: (B, T, 3, 3) corners; n_samples: surface draws a mesh;
    generator: the draws' generator (on the corners' device), unless
    ``uniforms`` gives them; npoint: if given, reduce the draws to npoint
    points by farthest point sampling (the reference's oversample-then-FPS
    recipe, tf_sampling.py:83).

    Returns (B, npoint or n_samples, 3) points on the surface.

    A draw (u, v) with u + v > 1 folds back into the lower triangle by
    (u, v) -> ((u' + d) / 2, (u' - d) / 2) with u' = 1 - |u + v - 1| and
    d = u - v: uniform over the triangle without a branch
    (tf_sampling.py:75-79).
    """
    B, T = triangles.shape[:2]
    r, us, vs = (uniforms if uniforms is not None
                 else _uniforms(triangles, n_samples, generator))
    dev = triangles.device
    r, us, vs = (t.to(dev) for t in (r, us, vs))
    tri_idx = prob_sample(triangle_areas(triangles), r)  # (B, S)

    corners = triangles.reshape(B, T, 9)
    picked = gather_point(corners, tri_idx).reshape(B, n_samples, 3, 3)
    a, b, c = picked[:, :, 0], picked[:, :, 1], picked[:, :, 2]

    us, vs = us.to(triangles.dtype), vs.to(triangles.dtype)
    uplusv = 1.0 - torch.abs(us + vs - 1.0)
    uminusv = us - vs
    us = (uplusv + uminusv) * 0.5
    vs = (uplusv - uminusv) * 0.5
    pts = a + (b - a) * us[..., None] + (c - a) * vs[..., None]

    if npoint is not None:
        pts = gather_point(pts, farthest_point_sample(pts, npoint))
    return pts
