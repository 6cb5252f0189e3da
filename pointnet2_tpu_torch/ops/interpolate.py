"""Interpolation ops: the three nearest known points of each unknown point,
and the inverse-distance weighted combination of their rows.

Port of pointnet2_tpu/ops/interpolate.py:29-177 and
ops/pallas/three_nn.py:67-111:

- ``three_nn``: squared distances, the three smallest in ascending order
  with ties to the lowest index; fewer than 3 known points leave the
  missing slots at dist=+inf, idx=0. No gradient. It runs its CUDA kernel
  (csrc/three_nn.cu) on CUDA tensors and its plain PyTorch version on CPU
  tensors (``config.use_kernel``); ``three_nn_kernel.launches`` counts the
  kernel's launches.
- ``three_interpolate``: out[j] = sum_k points[idx[j, k]] * weight[j, k],
  as the JAX package's ``mxu`` route computes it: the three rows gathered
  exactly (one launch of the row gather for all 3N rows), then combined in
  f32 as ((g0*w0) + g1*w1) + g2*w2 and cast once. Its gradient into points
  is the gather's, the deterministic scatter-add; into weight it is
  <grad, points[idx]>.
"""

from __future__ import annotations

import ctypes

import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import _build
from pointnet2_tpu_torch.ops.grouping import _check_cuda, _stream, gather_rows


def _check_shapes(xyz1: torch.Tensor, xyz2: torch.Tensor) -> None:
    if (xyz1.dim() != 3 or xyz2.dim() != 3 or xyz1.shape[2] != 3
            or xyz2.shape[2] != 3 or xyz1.shape[0] != xyz2.shape[0]):
        raise ValueError(f"three_nn takes xyz1 (B,N,3) and xyz2 (B,M,3), got "
                         f"{tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    if xyz2.shape[1] == 0:
        raise ValueError("three_nn needs at least one known point (M >= 1)")


def three_nn_plain(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain PyTorch 3-NN (pointnet2_tpu/ops/interpolate.py:53-85): the
    (B,N,M) squared distances summed per coordinate as ((dx*dx + dy*dy) +
    dz*dz), padded with inf to 3 columns when M < 3, then three passes of
    ``torch.argmin`` (the first occurrence of the minimum), each knocking
    out the chosen column with inf. Not ``topk``: its tie order is not
    specified. xyz1 (B,N,3), xyz2 (B,M,3) f32 -> (dist f32, idx int32),
    both (B,N,3)."""
    _check_shapes(xyz1, xyz2)
    M = xyz2.shape[1]
    a = xyz1[:, :, None, :]
    b = xyz2[:, None, :, :]
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    d = (dx * dx + dy * dy) + dz * dz  # (B, N, M)
    del dx, dy, dz
    if M < 3:
        d = torch.nn.functional.pad(d, (0, 3 - M), value=float("inf"))
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1, keepdim=True)
        dists.append(torch.gather(d, -1, i))
        idxs.append(i)
        d.scatter_(-1, i, float("inf"))
    return torch.cat(dists, -1), torch.cat(idxs, -1).to(torch.int32)


def launch_three_nn(xyz1, xyz2, dist, idx) -> None:
    """Launch csrc/three_nn.cu on checked, preallocated buffers (no launch
    count: :func:`three_nn_kernel` counts)."""
    B, N, _ = xyz1.shape
    fn = _build.bind("three_nn", "pn2_three_nn",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    with torch.cuda.device(xyz1.device):
        err = fn(xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(),
                 idx.data_ptr(), B, N, xyz2.shape[1], _stream(xyz1))
    _build.check("three_nn", err, "three_nn launch")


def three_nn_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """CUDA 3-NN (csrc/three_nn.cu): xyz1 (B,N,3), xyz2 (B,M,3) contiguous
    f32 on one card, M >= 1 -> (dist (B,N,3) f32, idx (B,N,3) int32), bit
    for bit as :func:`three_nn_plain`; any B (launches of at most 65535
    clouds, one count a call)."""
    _check_cuda(xyz1, "xyz1", (torch.float32,), 3)
    _check_cuda(xyz2, "xyz2", (torch.float32,), 3)
    _check_shapes(xyz1, xyz2)
    B, N, _ = xyz1.shape
    if xyz1.device != xyz2.device:
        raise ValueError(f"three_nn takes both clouds on one device, got "
                         f"{xyz1.device}, {xyz2.device}")
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=xyz1.device)
    if B * N == 0:
        return dist, idx
    launch_three_nn(xyz1, xyz2, dist, idx)
    three_nn_kernel.launches += 1
    return dist, idx


three_nn_kernel.launches = 0


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3 nearest neighbours of each unknown point among the known points.

    xyz1: (B, N, 3) unknown (dense) points; xyz2: (B, M, 3) known (sparse),
    M >= 1. Returns (dist, idx): (B, N, 3) f32 squared distances ascending
    and (B, N, 3) int32 indices into M. Both inputs are detached and cast
    to f32; no gradient.
    """
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    if config.use_kernel(xyz1):
        return three_nn_kernel(xyz1.contiguous(), xyz2.contiguous())
    return three_nn_plain(xyz1, xyz2)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-point interpolation: points (B, M, C) known features, idx
    (B, N, 3) int, weight (B, N, 3) -> (B, N, C) in the promotion of the
    points' and weights' dtypes. The three terms are written out so the sum
    runs in one fixed order, that of the JAX package's ``mxu`` route
    (ops/interpolate.py:122-136)."""
    B, N, _ = idx.shape
    rows = gather_rows(points, idx.reshape(B, 3 * N))
    rows = rows.reshape(B, N, 3, points.shape[-1])
    w = weight.float()
    out = rows[:, :, 0].float() * w[..., 0:1]
    out = out + rows[:, :, 1].float() * w[..., 1:2]
    out = out + rows[:, :, 2].float() * w[..., 2:3]
    return out.to(torch.promote_types(points.dtype, weight.dtype))
