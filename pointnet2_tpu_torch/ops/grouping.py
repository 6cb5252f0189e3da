"""Grouping ops: fixed-radius ball query (single, with the neighbours' xyz,
and multi-radius), kNN, the neighbour row gather and its gradient, the
deterministic row scatter-add.

Port of pointnet2_tpu/ops/grouping.py:38-276 and
ops/pallas/group.py:261-298:

- ``query_ball_point``: for each query, the indices of the FIRST `nsample`
  dataset points (in scan order) with squared distance < float32(radius)**2;
  remaining slots are padded with the first hit, an empty ball gives index
  0; also the number of in-ball points, capped at nsample. No gradient.
- ``query_ball_and_group_xyz``: the same, plus the neighbours' coordinates
  from the same pass; differentiable in the dataset points (scatter-add).
- ``query_ball_point_multi``: the ball query at several radii in one scan.
- ``knn_point``: the k nearest points, ties to the lowest index.
- ``group_point``: gathers (B,M,S,C) neighbour rows from (B,N,C) by (B,M,S)
  indices, an exact copy. Its gradient with respect to the points is the
  deterministic scatter-add ``scatter_rows`` (accumulated in f32, cast
  once), through the autograd Function ``GatherRows``; idx gets none.

Each op runs its CUDA kernel on CUDA tensors and its plain PyTorch version
on CPU tensors (``config.use_kernel``). The kernel wrappers count their
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import _build


def _r2(radius: float) -> float:
    # squared in f32, as ball_query.py:211-214 and grouping.py:43: a
    # python-f64 radius**2 differs by an ulp for e.g. radius=0.1
    return float(np.square(np.float32(radius)))


def _check_cuda(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# ball query
# ---------------------------------------------------------------------------


def ball_query_plain(radius: float, nsample: int, xyz1: torch.Tensor,
                     xyz2: torch.Tensor):
    """Plain PyTorch ball query (pointnet2_tpu/ops/grouping.py:38-56):
    the (B,M,N) squared-distance tensor, then the nsample smallest
    hit keys in ascending order."""
    N = xyz1.shape[1]
    diff = xyz2[:, :, None, :] - xyz1[:, None, :, :]  # (B, M, N, 3)
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    mask = d2 < _r2(radius)
    col = torch.arange(N, dtype=torch.int32, device=xyz1.device)
    keys = torch.where(mask, col, torch.tensor(N, dtype=torch.int32,
                                                device=xyz1.device))
    if nsample > N:  # fewer dataset points than slots: pad with misses
        keys = torch.nn.functional.pad(keys, (0, nsample - N), value=N)
    # nsample smallest keys ascending == first nsample hits in scan order
    idx = torch.topk(keys, nsample, dim=-1, largest=False, sorted=True).values
    cnt = torch.clamp(mask.sum(-1), max=nsample).to(torch.int32)
    first = idx[..., :1]
    slot = torch.arange(nsample, device=xyz1.device)
    idx = torch.where(slot < cnt[..., None], idx, first)
    idx = torch.where(first == N, torch.zeros_like(idx), idx)
    return idx.to(torch.int32), cnt


def launch_ball_query(radius: float, xyz1, xyz2, idx, cnt) -> None:
    """Launch csrc/ball_query.cu on checked, preallocated buffers (no
    launch count: :func:`ball_query_kernel` counts)."""
    B, N, _ = xyz1.shape
    M, nsample = idx.shape[1], idx.shape[2]
    fn = _build.bind("ball_query", "pn2_ball_query",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(xyz1.device):
        err = fn(xyz1.data_ptr(), xyz2.data_ptr(), idx.data_ptr(),
                 cnt.data_ptr(), B, N, M, nsample, _r2(radius),
                 _stream(xyz1))
    _build.check("ball_query", err, "ball_query launch")


def ball_query_kernel(radius: float, nsample: int, xyz1: torch.Tensor,
                      xyz2: torch.Tensor):
    """CUDA ball query (csrc/ball_query.cu): xyz1 (B,N,3), xyz2 (B,M,3)
    contiguous f32 on one card -> (idx (B,M,nsample) i32, cnt (B,M) i32)."""
    _check_xyz_pair(xyz1, xyz2)
    if nsample < 1:
        raise ValueError(f"need nsample >= 1, got {nsample}")
    B, M = xyz2.shape[:2]
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz1.device)
    if B * M == 0:
        return idx, cnt
    launch_ball_query(radius, xyz1, xyz2, idx, cnt)
    ball_query_kernel.launches += 1
    return idx, cnt


ball_query_kernel.launches = 0


def query_ball_point(radius: float, nsample: int, xyz1: torch.Tensor,
                     xyz2: torch.Tensor):
    """Fixed-radius near-neighbour search with padded fixed-size output.

    xyz1: (B, N, 3) dataset points; xyz2: (B, M, 3) query points.
    Returns idx (B, M, nsample) int32 (first nsample in scan order, padded
    with the first hit) and pts_cnt (B, M) int32 (capped at nsample).
    """
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    if config.use_kernel(xyz1):
        return ball_query_kernel(radius, nsample, xyz1.contiguous(),
                                 xyz2.contiguous())
    return ball_query_plain(radius, nsample, xyz1, xyz2)


def _check_xyz_pair(xyz1: torch.Tensor, xyz2: torch.Tensor) -> None:
    _check_cuda(xyz1, "xyz1", (torch.float32,), 3)
    _check_cuda(xyz2, "xyz2", (torch.float32,), 3)
    if (xyz1.shape[2] != 3 or xyz2.shape[2] != 3
            or xyz1.shape[0] != xyz2.shape[0] or xyz1.device != xyz2.device):
        raise ValueError(f"ball query takes xyz1 (B,N,3) and xyz2 (B,M,3) "
                         f"on one device, got {tuple(xyz1.shape)} and "
                         f"{tuple(xyz2.shape)}")
    if xyz1.shape[1] < 1:
        raise ValueError("ball query needs N >= 1 dataset points")


# ---------------------------------------------------------------------------
# ball query with the neighbours' xyz
# ---------------------------------------------------------------------------


def ball_query_group_xyz_plain(radius: float, nsample: int,
                               xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain PyTorch ball query plus the neighbours' coordinates: the plain
    ball query, then the (B, M, nsample, 3) rows of xyz1 by its indices."""
    idx, cnt = ball_query_plain(radius, nsample, xyz1, xyz2)
    B, M = idx.shape[:2]
    grouped = gather_rows_plain(xyz1, idx.reshape(B, M * nsample))
    return idx, cnt, grouped.reshape(B, M, nsample, 3)


def launch_ball_query_group_xyz(radius: float, xyz1, xyz2, idx, cnt,
                                grouped) -> None:
    """Launch pn2_ball_query_group_xyz of csrc/ball_query.cu on checked,
    preallocated buffers (no launch count)."""
    B, N, _ = xyz1.shape
    M, nsample = idx.shape[1], idx.shape[2]
    fn = _build.bind("ball_query", "pn2_ball_query_group_xyz",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(xyz1.device):
        err = fn(xyz1.data_ptr(), xyz2.data_ptr(), idx.data_ptr(),
                 cnt.data_ptr(), grouped.data_ptr(), B, N, M, nsample,
                 _r2(radius), _stream(xyz1))
    _build.check("ball_query", err, "ball_query_group_xyz launch")


def ball_query_group_xyz_kernel(radius: float, nsample: int,
                                xyz1: torch.Tensor, xyz2: torch.Tensor):
    """CUDA ball query with grouped xyz (csrc/ball_query.cu): xyz1 (B,N,3),
    xyz2 (B,M,3) contiguous f32 on one card -> (idx (B,M,nsample) i32,
    cnt (B,M) i32, grouped (B,M,nsample,3) f32 == xyz1[b, idx])."""
    _check_xyz_pair(xyz1, xyz2)
    if nsample < 1:
        raise ValueError(f"need nsample >= 1, got {nsample}")
    B, M = xyz2.shape[:2]
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz1.device)
    grouped = torch.empty((B, M, nsample, 3), dtype=torch.float32,
                          device=xyz1.device)
    if B * M == 0:
        return idx, cnt, grouped
    launch_ball_query_group_xyz(radius, xyz1, xyz2, idx, cnt, grouped)
    ball_query_group_xyz_kernel.launches += 1
    return idx, cnt, grouped


ball_query_group_xyz_kernel.launches = 0


class BallQueryGroupXyz(torch.autograd.Function):
    """Ball query and the neighbours' xyz inside autograd (the custom VJP
    of pointnet2_tpu/ops/grouping.py:141-166): the gradient of ``grouped``
    with respect to xyz1 is the scatter-add of its cotangent into the N
    rows; xyz2, idx and cnt get none."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, radius, nsample):
        if config.use_kernel(xyz1):
            idx, cnt, grouped = ball_query_group_xyz_kernel(
                radius, nsample, xyz1.contiguous(), xyz2.contiguous())
        else:
            idx, cnt, grouped = ball_query_group_xyz_plain(radius, nsample,
                                                           xyz1, xyz2)
        ctx.mark_non_differentiable(idx, cnt)
        ctx.save_for_backward(idx)
        ctx.n = xyz1.shape[1]
        return idx, cnt, grouped

    @staticmethod
    def backward(ctx, _gidx, _gcnt, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (idx,) = ctx.saved_tensors
        B, M, S = idx.shape
        g = scatter_rows(grad.reshape(B, M * S, 3).contiguous(),
                         idx.reshape(B, M * S), ctx.n)
        return g, None, None, None


def query_ball_and_group_xyz(radius: float, nsample: int, xyz1: torch.Tensor,
                             xyz2: torch.Tensor):
    """Ball query and the neighbours' coordinates in one pass.

    The same as ``idx, cnt = query_ball_point(...)`` followed by
    ``group_point(xyz1, idx)``, with xyz1 in f32. Returns (idx (B,M,nsample)
    i32, pts_cnt (B,M) i32, grouped_xyz (B,M,nsample,3) f32, uncentred).
    Differentiable in xyz1 (scatter-add), not in xyz2."""
    return BallQueryGroupXyz.apply(xyz1.float(), xyz2.detach().float(),
                                   radius, nsample)


# ---------------------------------------------------------------------------
# multi-radius ball query
# ---------------------------------------------------------------------------

MAX_RADII = 8  # kMaxRadii of csrc/ball_query.cu


def ball_query_multi_plain(radii, nsamples, xyz1: torch.Tensor,
                           xyz2: torch.Tensor):
    """Plain PyTorch multi-radius ball query: the plain ball query at each
    radius, a tuple of (idx, cnt) pairs."""
    return tuple(ball_query_plain(r, ns, xyz1, xyz2)
                 for r, ns in zip(radii, nsamples))


def launch_ball_query_multi(radii, xyz1, xyz2, outs) -> None:
    """Launch pn2_ball_query_multi of csrc/ball_query.cu on checked,
    preallocated (idx, cnt) buffers, one pair per radius (no launch
    count)."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    count = len(outs)
    r2s = (ctypes.c_float * count)(*[_r2(r) for r in radii])
    nss = (ctypes.c_int * count)(*[idx.shape[2] for idx, _ in outs])
    idxs = (ctypes.c_void_p * count)(*[idx.data_ptr() for idx, _ in outs])
    cnts = (ctypes.c_void_p * count)(*[cnt.data_ptr() for _, cnt in outs])
    fn = _build.bind("ball_query", "pn2_ball_query_multi",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    with torch.cuda.device(xyz1.device):
        err = fn(xyz1.data_ptr(), xyz2.data_ptr(), r2s, nss, idxs, cnts,
                 count, B, N, M, _stream(xyz1))
    _build.check("ball_query", err, "ball_query_multi launch")


def ball_query_multi_kernel(radii, nsamples, xyz1: torch.Tensor,
                            xyz2: torch.Tensor):
    """CUDA multi-radius ball query (csrc/ball_query.cu), one scan of the
    dataset for 1 to 8 radii in any order: xyz1 (B,N,3), xyz2 (B,M,3)
    contiguous f32 on one card -> a tuple of (idx (B,M,nsample_i) i32,
    cnt (B,M) i32), each bit-identical to the ball query at radius i."""
    _check_xyz_pair(xyz1, xyz2)
    radii, nsamples = tuple(radii), tuple(nsamples)
    if len(radii) != len(nsamples) or not 1 <= len(radii) <= MAX_RADII:
        raise ValueError(f"need 1 to {MAX_RADII} radii with one nsample "
                         f"each, got {radii} and {nsamples}")
    if min(nsamples) < 1:
        raise ValueError(f"need every nsample >= 1, got {nsamples}")
    B, M = xyz2.shape[:2]
    outs = tuple((torch.empty((B, M, ns), dtype=torch.int32,
                              device=xyz1.device),
                  torch.empty((B, M), dtype=torch.int32, device=xyz1.device))
                 for ns in nsamples)
    if B * M == 0:
        return outs
    launch_ball_query_multi(radii, xyz1, xyz2, outs)
    ball_query_multi_kernel.launches += 1
    return outs


ball_query_multi_kernel.launches = 0


def query_ball_point_multi(radii, nsamples, xyz1: torch.Tensor,
                           xyz2: torch.Tensor):
    """Ball query at several radii over the same (dataset, queries) pair:
    the same as ``[query_ball_point(r, ns, xyz1, xyz2) for r, ns in
    zip(radii, nsamples)]``, in one launch on the card. Returns a tuple of
    (idx (B,M,nsample_i) i32, cnt (B,M) i32) pairs. No gradient."""
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    if config.use_kernel(xyz1):
        return ball_query_multi_kernel(radii, nsamples, xyz1.contiguous(),
                                       xyz2.contiguous())
    return ball_query_multi_plain(radii, nsamples, xyz1, xyz2)


# ---------------------------------------------------------------------------
# k nearest neighbours
# ---------------------------------------------------------------------------


def knn_point(k: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """k nearest neighbours of each query in the dataset (ops/grouping.py:
    265-276): xyz1 (B, N, C) dataset, xyz2 (B, M, C) queries -> (val, idx),
    (B, M, k) squared distances ascending and int32 indices, ties to the
    lowest index. Plain PyTorch on both devices (the JAX package has no
    Pallas kernel here): a stable ascending sort, since ``torch.topk``
    promises no order among ties on CUDA."""
    diff = xyz2[:, :, None, :] - xyz1[:, None, :, :]
    d2 = diff[..., 0] * diff[..., 0]  # (B, M, N), summed in channel order
    for c in range(1, diff.shape[-1]):
        d2 = d2 + diff[..., c] * diff[..., c]
    val, idx = torch.sort(d2, dim=-1, stable=True)
    return val[..., :k], idx[..., :k].to(torch.int32)


# ---------------------------------------------------------------------------
# row gather (forward)
# ---------------------------------------------------------------------------


def gather_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, n, C), idx (B, K) -> (B, K, C), by advanced indexing
    (jnp.take_along_axis in the JAX package)."""
    b = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[b, idx.long()]


def launch_gather_rows(points, idx, out) -> None:
    """Launch csrc/gather.cu on checked, preallocated buffers (no launch
    count: :func:`gather_rows_kernel` counts)."""
    B, n, C = points.shape
    fn = _build.bind("gather", "pn2_gather_rows",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), idx.data_ptr(), out.data_ptr(), B, n,
                 idx.shape[1], C, points.element_size(), _stream(points))
    _build.check("gather", err, "gather_rows launch")


def gather_rows_kernel(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """CUDA row gather (csrc/gather.cu): points (B, n, C) contiguous f32 or
    bf16, idx (B, K) contiguous int32 with every value in [0, n) ->
    (B, K, C), bit for bit."""
    _check_cuda(points, "points", (torch.float32, torch.bfloat16), 3)
    _check_cuda(idx, "idx", (torch.int32,), 2)
    B, n, C = points.shape
    if idx.shape[0] != B or idx.device != points.device:
        raise ValueError(f"idx {tuple(idx.shape)} does not index points "
                         f"{tuple(points.shape)} on {points.device}")
    out = torch.empty((B, idx.shape[1], C), dtype=points.dtype,
                      device=points.device)
    if out.numel() == 0:
        return out
    if n < 1:
        raise ValueError("cannot gather from an empty point set")
    launch_gather_rows(points, idx, out)
    gather_rows_kernel.launches += 1
    return out


gather_rows_kernel.launches = 0


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if config.use_kernel(points):
        return gather_rows_kernel(points.contiguous(), idx)
    return gather_rows_plain(points, idx)


# ---------------------------------------------------------------------------
# row scatter-add (the gather's backward)
# ---------------------------------------------------------------------------


def scatter_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Plain PyTorch scatter-add (ops/grouping.py:194-202): g (B, K, C),
    idx (B, K) -> (B, n, C), summed by ``index_add_`` into a zero f32
    buffer (f64 for a float64 g) and cast once to g's dtype. An index
    outside [0, n) lands in a spare row that is dropped. On a CUDA tensor
    ``index_add_`` sums with atomics, in no fixed order."""
    B, K, C = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    ix = idx.long()
    ix = torch.where((ix >= 0) & (ix < n), ix, n)
    ix = ix + torch.arange(B, device=g.device)[:, None] * (n + 1)
    out = torch.zeros((B * (n + 1), C), dtype=acc, device=g.device)
    out.index_add_(0, ix.reshape(-1), g.reshape(B * K, C).to(acc))
    return out.reshape(B, n + 1, C)[:, :n].to(g.dtype).contiguous()


def scatter_csr_plain(idx: torch.Tensor, n: int):
    """Plain CSR of a scatter's indices, idx (B, K) -> (off (B, n+1), perm
    (B, K)) int32: perm is the stable argsort of the destination rows (an
    index outside [0, n) counts as row n), so row j's k lie in ascending
    order in perm[b, off[b, j]:off[b, j+1]] and the out-of-range k fill
    perm[b, off[b, n]:]; off[b, n] is the number of valid indices. The
    layout csrc/scatter.cu builds; for the tests and the card checks."""
    B, K = idx.shape
    ix = idx.long()
    row = torch.where((ix >= 0) & (ix < n), ix, n)
    perm = torch.argsort(row, dim=1, stable=True).to(torch.int32)
    flat = (row + torch.arange(B, device=idx.device)[:, None] * (n + 1))
    count = torch.bincount(flat.reshape(-1), minlength=B * (n + 1))
    count = count.reshape(B, n + 1)[:, :n]
    off = torch.zeros((B, n + 1), dtype=torch.int64, device=idx.device)
    off[:, 1:] = count.cumsum(1)
    return off.to(torch.int32), perm


def scatter_rows_csr_plain(g: torch.Tensor, off: torch.Tensor,
                           perm: torch.Tensor, n: int) -> torch.Tensor:
    """Plain segmented sum over a CSR (:func:`scatter_csr_plain`): row j of
    cloud b adds g[b, perm[b, p]] for p in [off[b, j], off[b, j+1]) one
    after another, in f32 (f64 for a float64 g) from +0.0, and casts once
    to g's dtype: the order csrc/scatter.cu sums in."""
    B, K, C = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    out = torch.zeros((B, n, C), dtype=acc, device=g.device)
    lens = (off[:, 1:] - off[:, :-1]).long()
    depth = int(lens.max()) if lens.numel() else 0
    gs = g.to(acc)
    for t in range(depth):  # the t-th term of every row at once
        pos = (off[:, :n].long() + t).clamp(max=K - 1)
        k = torch.gather(perm.long(), 1, pos)
        rows = torch.gather(gs, 1, k[..., None].expand(B, n, C))
        out = torch.where((lens > t)[..., None], out + rows, out)
    return out.to(g.dtype)


# indices a chunk of csrc/scatter.cu (kChunk): the count table holds one
# count per (row, chunk)
_CHUNK = 2048


def scatter_buffers(idx: torch.Tensor, n: int) -> dict:
    """The scratch of one scatter launch: the count table (B, n+1, chunks)
    and the CSR it leaves, off (B, n+1) and perm (B, K), all int32."""
    B, K = idx.shape
    dev, i32 = idx.device, torch.int32
    return {"count": torch.empty((B, n + 1, -(-K // _CHUNK)), dtype=i32,
                                 device=dev),
            "off": torch.empty((B, n + 1), dtype=i32, device=dev),
            "perm": torch.empty((B, K), dtype=i32, device=dev)}


def launch_scatter_rows(g, idx, out, bufs: dict) -> None:
    """Launch csrc/scatter.cu on checked, preallocated buffers (``bufs``
    from :func:`scatter_buffers`; no launch count: :func:`scatter_rows_kernel`
    counts)."""
    B, K, C = g.shape
    fn = _build.bind("scatter", "pn2_scatter_rows",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 bufs["count"].data_ptr(), bufs["off"].data_ptr(),
                 bufs["perm"].data_ptr(), B, K, out.shape[1], C,
                 g.element_size(), _stream(g))
    _build.check("scatter", err, "scatter_rows launch")


def scatter_rows_kernel(g: torch.Tensor, idx: torch.Tensor, n: int,
                        return_csr: bool = False):
    """CUDA scatter-add (csrc/scatter.cu): g (B, K, C) contiguous f32 or
    bf16, idx (B, K) contiguous int32 -> (B, n, C) in g's dtype, each
    element summed in f32 in ascending k: bit for bit
    :func:`scatter_rows_plain` on CPU copies, the same bits from launch to
    launch; indices outside [0, n) add nothing; any B (the passes run on
    at most 65535 clouds at a time). With ``return_csr`` also the kernel's
    CSR (off, perm), as :func:`scatter_csr_plain` gives it."""
    _check_cuda(g, "g", (torch.float32, torch.bfloat16), 3)
    _check_cuda(idx, "idx", (torch.int32,), 2)
    B, K, C = g.shape
    if tuple(idx.shape) != (B, K) or idx.device != g.device:
        raise ValueError(f"idx {tuple(idx.shape)} does not index g "
                         f"{tuple(g.shape)} on {g.device}")
    if n < 0 or n >= 2 ** 31 - 1:
        raise ValueError(f"need 0 <= n < 2**31 - 1, got n={n}")
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    bufs = scatter_buffers(idx, n)
    if out.numel() > 0:
        launch_scatter_rows(g, idx, out, bufs)  # K = 0 writes zeros
        scatter_rows_kernel.launches += 1
    if return_csr:
        return out, bufs["off"], bufs["perm"]
    return out


scatter_rows_kernel.launches = 0


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add (B, K, C) by (B, K) into (B, n, C): the kernel on CUDA
    tensors, ``index_add_`` on CPU tensors."""
    if config.use_kernel(g):
        return scatter_rows_kernel(g.contiguous(),
                                   idx.to(torch.int32).contiguous(), n)
    return scatter_rows_plain(g, idx, n)


class GatherRows(torch.autograd.Function):
    """Row gather (B, n, C) by (B, K) -> (B, K, C) inside autograd: forward
    is the gather, backward the scatter-add of the output's gradient into
    the n rows (the custom VJP of group.py:261-298). idx gets no gradient,
    and nothing is launched backwards unless the points need a gradient."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return _gather_rows(points, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad.contiguous(), idx, ctx.n), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (B, n, C) by (B, K) -> (B, K, C), differentiable in
    points: the kernels on CUDA tensors, the plain versions on CPU
    tensors."""
    return GatherRows.apply(points, idx.to(torch.int32).contiguous())


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features: points (B,N,C), idx (B,M,S) -> (B,M,S,C)."""
    B, M, S = idx.shape
    out = gather_rows(points, idx.reshape(B, M * S))
    return out.reshape(B, M, S, points.shape[-1])
