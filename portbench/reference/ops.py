"""Plain PyTorch point ops of the reference: a frozen copy of the
arithmetic the published PointNet++ ops define, written out here so that
the benchmark's check imports nothing of the program under test.

- ``fps``: the first index is 0; each step takes the point with the
  largest squared distance to the chosen set, ties to the lowest index;
  distances summed as (dx*dx + dy*dy) + dz*dz in float32.
- ``ball_query``: the first ``nsample`` points in scan order with squared
  distance below float32(radius)**2, the rest of the slots filled with the
  first hit, an empty ball giving index 0.
- ``three_nn``: the three smallest squared distances ascending, ties to
  the lowest index.
- ``gather``: rows of (B, N, C) by (B, ...) indices.
"""

from __future__ import annotations

import numpy as np
import torch


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, *S) -> (B, *S, C)."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    rows = torch.arange(B, device=points.device)[:, None]
    return points[rows, flat].reshape(*idx.shape, points.shape[-1])


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int64 indices."""
    B, N, _ = xyz.shape
    xyz = xyz.detach().float()
    out = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    col = torch.arange(N, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    best_d = torch.full((B, N), 1e38, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, last]
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        best_d = torch.minimum(best_d, dx * dx + dy * dy + dz * dz)
        top = best_d.amax(dim=1, keepdim=True)
        last = torch.where(best_d == top, col, N).amin(dim=1)
        out[:, j] = last
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) points, new_xyz (B, M, 3) centres -> (B, M, nsample)
    int64 indices."""
    N = xyz.shape[1]
    r2 = float(np.square(np.float32(radius)))
    diff = new_xyz.detach()[:, :, None, :] - xyz.detach()[:, None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    del diff
    hit = d2 < r2
    del d2
    col = torch.arange(N, dtype=torch.long, device=xyz.device)
    keys = torch.where(hit, col, N)
    if nsample > N:
        keys = torch.nn.functional.pad(keys, (0, nsample - N), value=N)
    idx = torch.topk(keys, nsample, dim=-1, largest=False,
                     sorted=True).values
    cnt = hit.sum(-1, keepdim=True)
    first = idx[..., :1]
    slot = torch.arange(nsample, device=xyz.device)
    idx = torch.where(slot < cnt, idx, first)
    return torch.where(first == N, torch.zeros_like(idx), idx)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, 3) unknown, xyz2 (B, M, 3) known, M >= 3 -> (dist, idx),
    both (B, N, 3): squared distances ascending and int64 indices."""
    a = xyz1.detach()[:, :, None, :]
    b = xyz2.detach()[:, None, :, :]
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    d = (dx * dx + dy * dy) + dz * dz
    del dx, dy, dz
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1, keepdim=True)
        dists.append(torch.gather(d, -1, i))
        idxs.append(i)
        d.scatter_(-1, i, float("inf"))
    return torch.cat(dists, -1), torch.cat(idxs, -1)
