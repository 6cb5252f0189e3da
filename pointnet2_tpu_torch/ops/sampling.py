"""Sampling ops: farthest point sampling, point gather, probability
sampling.

Port of pointnet2_tpu/ops/sampling.py:33-167:

- ``farthest_point_sample``: seed is always index 0; iteratively selects the
  point with the maximum min squared distance to the selected set; ties
  broken by lowest index. Index-producing, no gradient.
- ``gather_point``: gathers (B,M,C) from (B,N,C) by (B,M) indices, an exact
  copy (the row gather of ops/grouping.py), whose gradient is the
  scatter-add.
- ``prob_sample``: categorical indices by cumulative sum and binary
  search, plain PyTorch on every device (no Pallas kernel in the JAX
  package either). No gradient.

FPS runs its CUDA kernel on CUDA tensors, at any cloud size (one CTA a
cloud up to 16384 points, a thread-block cluster above: ``fps_route``),
and its plain PyTorch version on CPU tensors (``config.use_kernel``);
``fps_kernel.launches`` counts the kernel's launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import _build
from pointnet2_tpu_torch.ops.grouping import _check_cuda, _stream, gather_rows


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS (pointnet2_tpu/ops/sampling.py:33-54), one step of
    the selection chain per loop iteration. xyz (B,N,3) f32 ->
    (B, npoint) int32."""
    B, N, _ = xyz.shape
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    if npoint == 1:
        return out
    col = torch.arange(N, dtype=torch.int32, device=xyz.device)
    n_fill = torch.tensor(N, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    min_dist = torch.full((B, N), 1e38, dtype=torch.float32,
                          device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, last]  # (B, 3)
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        # argmax with lowest-index tie-break
        best = min_dist.amax(dim=1, keepdim=True)
        nxt = torch.where(min_dist == best, col, n_fill).amin(dim=1)
        out[:, j] = nxt
        last = nxt.long()
    return out


# csrc/fps.cu's routes: one CTA a cloud up to CTA_POINTS points, else a
# thread-block cluster of C CTAs (fps_route), whose slices sit in
# registers up to MAX_CLUSTER * CTA_POINTS points and above that in a
# scratch of 16 bytes a point
CTA_POINTS = 1024 * 16
MAX_CLUSTER = 16
_INT32_MAX = 2 ** 31 - 1


def fps_route(n: int) -> tuple[str, int]:
    """The route csrc/fps.cu takes for clouds of n points and its CTAs a
    cloud: ("cta", 1) up to 16384 points; ("cluster", C) with C the
    smallest of 2, 4, 8, 16 such that ceil(n / C) <= 16384; ("scratch",
    16) above 16 x 16384 = 262144 points."""
    if n <= CTA_POINTS:
        return "cta", 1
    if n > MAX_CLUSTER * CTA_POINTS:
        return "scratch", MAX_CLUSTER
    c = 2
    while -(-n // c) > CTA_POINTS:
        c *= 2
    return "cluster", c


def fps_scratch(xyz: torch.Tensor) -> torch.Tensor | None:
    """The scratch route's (B, N, 4) f32 buffer (x, y, z and the running
    minimum of each point), or None where the route needs none."""
    B, N, _ = xyz.shape
    if fps_route(N)[0] != "scratch":
        return None
    return torch.empty((B, N, 4), dtype=torch.float32, device=xyz.device)


def launch_fps(xyz: torch.Tensor, out: torch.Tensor,
               scratch: torch.Tensor | None = None) -> None:
    """Launch csrc/fps.cu on checked, preallocated buffers (``scratch``
    from :func:`fps_scratch`; no launch count: :func:`fps_kernel`
    counts)."""
    B, N, _ = xyz.shape
    fn = _build.bind("fps", "pn2_fps",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    with torch.cuda.device(xyz.device):
        err = fn(xyz.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, N,
                 out.shape[1], _stream(xyz))
    _build.check("fps", err, "fps launch")


def fps_kernel(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """CUDA FPS (csrc/fps.cu): xyz (B, N, 3) contiguous f32 with
    1 <= N < 2**31 -> (B, npoint) int32, bit for bit :func:`fps_plain`."""
    _check_cuda(xyz, "xyz", (torch.float32,), 3)
    B, N, c = xyz.shape
    if c != 3 or not 1 <= N <= _INT32_MAX:
        raise ValueError(f"fps takes (B, N, 3) with 1 <= N < 2**31, got "
                         f"{tuple(xyz.shape)}")
    if not 1 <= npoint <= _INT32_MAX:
        raise ValueError(f"npoint must be in [1, 2**31), got {npoint}")
    ctas = fps_route(N)[1]
    if B * ctas > _INT32_MAX:
        raise ValueError(f"fps takes at most 2**31 - 1 CTAs, got B={B} "
                         f"clouds of {ctas}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    launch_fps(xyz, out, fps_scratch(xyz))
    fps_kernel.launches += 1
    return out


fps_kernel.launches = 0


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative farthest point sampling.

    xyz: (B, N, 3) point coordinates; npoint: number of points to select.
    Returns (B, npoint) int32 indices into N; the first is always 0.
    """
    xyz = xyz.detach().float()
    if config.use_kernel(xyz):
        return fps_kernel(xyz.contiguous(), npoint)
    return fps_plain(xyz, npoint)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of points by per-batch indices: points (B, N, C),
    idx (B, M) -> (B, M, C)."""
    return gather_rows(points, idx)


def prob_sample(inp: torch.Tensor, inpr: torch.Tensor) -> torch.Tensor:
    """Sample categorical indices proportional to unnormalized weights
    (pointnet2_tpu/ops/sampling.py:156-167).

    inp: (B, N) unnormalized weights (e.g. triangle areas); inpr: (B, M)
    uniform randoms in [0, 1). Returns (B, M) int32 indices: the smallest
    r with cumsum(inp)[r] >= u * cumsum(inp)[-1], clamped to N - 1.

    The float32 prefix sums are ``torch.cumsum``'s, whose order of
    additions differs from XLA's (and between the CPU and CUDA): where a
    draw lies within that rounding of a boundary the index can move by
    one. On weights whose prefix sums are exact (small integers, dyadic
    values) every order gives the same indices.
    """
    cs = torch.cumsum(inp.detach().float(), dim=1).contiguous()
    q = (inpr.detach().float() * cs[:, -1:]).contiguous()
    idx = torch.searchsorted(cs, q, side="left")
    return idx.clamp_max(inp.shape[1] - 1).to(torch.int32)
