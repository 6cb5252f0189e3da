"""Fused (BN -> ReLU -> Dense)* -> max-pool chain of the set-abstraction
MLP: the eval-mode forward, and the train-mode forward with its
rematerialising backward.

Port of pointnet2_tpu/ops/pallas/fused_mlp.py. The chain covers BN_0 ..
BN_D and the dense layers W_1 .. W_D; its input is the pre-BN_0 grouped
tensor (B, M, S, C_0), the lifted first dense gathered (nn/pointnet.py).
Each BN j runs as the per-channel f32 affine ``a_j = scale_j * rsqrt(var_j
+ eps)``, ``b_j = bias_j - mean_j * a_j`` (running statistics in eval, batch
statistics in train), and each step of the chain is one kernel of
csrc/fused_mlp.cu:

- ``dense_fwd`` (row 10, ``_dense_fwd``): ``y = T(T(relu(x*a + b)) @
  T(W)^T + bias)`` for x (R, Cin) of the activation type T (f32 or bf16),
  accumulated in f32, and optionally the f32 column sum and sum of squares
  of the rounded y (the BN statistics of a train-mode pass);
- ``pool_fwd`` (row 11, ``_pool_fwd``): ``max_S T(relu(y*a + b))``, (G, S,
  C) -> (G, C);
- ``affine_fwd`` (row 12, ``_affine_fwd``): ``T(relu(y*a + b))``, the tail
  without pooling;
- ``top_stats`` (row 13, ``_top_stats``): the top BN's reduction totals
  ``T1 = sum(dout)``, ``T2 = sum(dout * yhat)``, the pooled cotangent routed
  to the first-occurrence argmax over S of ``T(relu(y*a + b))``;
- ``dense_bwd`` (row 14, ``_dense_bwd``): dense k's backward from its saved
  pre-BN output y_k and the layer below's y_{k-1}: ``dy = gr*(dout - m1 -
  yhat*m2)``, ``dW = T(dy)^T @ z_{k-1}``, ``db = sum(dy)``, ``g_{k-1} =
  T(T(dy) @ T(W))`` and BN_{k-1}'s T1/T2 from the rounded g_{k-1};
- ``first_bwd`` (row 15, ``_first_bwd``): BN_0's ``dx = T(gr*(dout - m1 -
  yhat*m2))``.

The backward ops read a BN as its (7, C) f32 pack (``bn_pack``). Every
``v*a + b`` rounds the product and the sum apart, and f32 stays f32 (no
TF32, config.disable_tf32). Each op runs its kernel on CUDA tensors and its
plain PyTorch version on CPU tensors (``config.use_kernel``); the kernel
wrappers count their launches in ``<wrapper>.launches``. Weights are
nn.Linear's (Cout, Cin); the Flax kernel is its transpose, so dW here is the
transpose of the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import _build
from pointnet2_tpu_torch.ops.grouping import _check_cuda, _stream

_ACT = (torch.float32, torch.bfloat16)


class ChainConfig(NamedTuple):
    """Static chain description. ``replica`` is the mesh of a cross-replica
    train step (parallel/mesh.py; JAX's ``axis_name``): the train chain
    then averages each BN's (mean, mean square) and the backward's T1/T2
    means over its ranks (pointnet2_tpu/ops/pallas/fused_mlp.py:501-526,
    573-580). None: one process, no collective."""

    eps: float
    pool: bool  # max-pool over the S axis in the epilogue
    replica: object = None


def _sync(cfg: ChainConfig, u: torch.Tensor, v: torch.Tensor):
    """(u, v) averaged over ``cfg.replica``'s ranks by one all-reduce of
    the stacked pair; themselves without a replica."""
    if cfg.replica is None:
        return u, v
    return cfg.replica.mean(torch.stack([u, v])).unbind(0)


def _affine_relu(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """T(relu(y.f32 * a + b)), eager mul then add: two roundings."""
    return torch.relu(y.float() * a + b).to(y.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def dense_fwd_plain(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor, bias: torch.Tensor,
                    want_stats: bool = False):
    """Plain PyTorch dense pass: x2d (R, Cin), a, b (Cin) f32, w (Cout,
    Cin), bias (Cout) -> (y (R, Cout) in x2d's type, sum, sumsq), the two
    f32 column sums of float(y) with ``want_stats``, else None. The matmul
    runs in f32 on the rounded operands, so acc is not rounded before the
    bias, as on the TPU's f32 accumulator."""
    z = _affine_relu(x2d, a, b)
    acc = torch.matmul(z.float(), w.to(x2d.dtype).float().t())
    y = (acc + bias.float()).to(x2d.dtype)
    if not want_stats:
        return y, None, None
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def pool_fwd_plain(y3d: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pooled tail: y3d (G, S, C) -> (G, C)."""
    return _affine_relu(y3d, a, b).amax(dim=1)


def affine_fwd_plain(y2d: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch unpooled tail: y2d (R, C) -> (R, C)."""
    return _affine_relu(y2d, a, b)


def bn_pack(scale, bias, mean, var, eps: float, m1=None, m2=None):
    """A BN as the (7, C) f32 rows the backward reads
    (pointnet2_tpu/ops/pallas/fused_mlp.py:237-254): a, b (the affine), mean,
    r = rsqrt(var + eps), gr = scale * r, and m1, m2, the batch means of
    dout and dout * yhat (zero for running statistics)."""
    r = torch.rsqrt(var.float() + eps)
    a = scale.float() * r
    z = torch.zeros_like(a)
    return torch.stack([a, bias.float() - mean.float() * a, mean.float(), r,
                        scale.float() * r, z if m1 is None else m1.float(),
                        z if m2 is None else m2.float()])


def _pooled_cotangent(y3d: torch.Tensor, g: torch.Tensor,
                      p: torch.Tensor) -> torch.Tensor:
    """The pooled cotangent g (G, C) spread over S: at the first-occurrence
    argmax over S of T(relu(y3d*a + b)), 0 elsewhere (f32, (G, S, C))."""
    z = torch.relu(y3d.float() * p[0] + p[1]).to(y3d.dtype).float()
    sel = (torch.arange(y3d.shape[1], device=y3d.device)[None, :, None]
           == z.argmax(1)[:, None])
    return torch.where(sel, g.float()[:, None, :], 0.0)


def _bn_bwd_terms(y: torch.Tensor, dz: torch.Tensor, p: torch.Tensor):
    """(dout, yhat) of a BN + ReLU from its pre-BN input y, the cotangent dz
    of the ReLU's output, and the pack p; f32, eager mul and add (two
    roundings each)."""
    yf = y.float()
    dout = dz * (yf * p[0] + p[1] > 0)
    return dout, (yf - p[2]) * p[3]


def _bn_dy(dout, yhat, p):
    """gr * (dout - m1 - yhat * m2), f32, op by op."""
    return p[4] * (dout - p[5] - yhat * p[6])


def top_stats_plain(y: torch.Tensor, g: torch.Tensor, p: torch.Tensor,
                    pool: bool):
    """Plain PyTorch row 13: the top BN's (T1, T2), each (C,) f32. pool: y
    (G, S, C), g (G, C); else y and g (R, C)."""
    if pool:
        dout, yhat = _bn_bwd_terms(y, _pooled_cotangent(y, g, p), p)
        red = (0, 1)
    else:
        dout, yhat = _bn_bwd_terms(y, g.float(), p)
        red = (0,)
    return dout.sum(red), (dout * yhat).sum(red)


def dense_bwd_plain(yk: torch.Tensor, yp: torch.Tensor, g: torch.Tensor,
                    pk: torch.Tensor, pp: torch.Tensor, w: torch.Tensor,
                    top_pool: bool):
    """Plain PyTorch row 14, dense k's backward. yk: (G, S, Ck) with
    top_pool, else (R, Ck); yp (R, Cp), pre-BN_{k-1}; g: (G, Ck) pooled
    cotangent with top_pool, else (R, Ck); pk, pp the packs of BN_k (with
    its m1, m2) and BN_{k-1}; w (Ck, Cp). Returns g_{k-1} (R, Cp) in yk's
    type, dW (Ck, Cp), db (Ck,), T1, T2 (Cp,) of BN_{k-1}, all f32 but g.
    dy is rounded to T before both products, db sums the unrounded dy, and
    T1/T2 come from the rounded g_{k-1} (fused_mlp.py:351-388)."""
    dt = yk.dtype
    if top_pool:
        dz = _pooled_cotangent(yk, g, pk).reshape(-1, yk.shape[-1])
        yk = yk.reshape(-1, yk.shape[-1])
    else:
        dz = g.float()
    dout, yhat = _bn_bwd_terms(yk, dz, pk)
    dy = _bn_dy(dout, yhat, pk)
    zp = _affine_relu(yp, pp[0], pp[1])
    dy_c = dy.to(dt)
    dw = torch.matmul(dy_c.float().t(), zp.float())
    gp = torch.matmul(dy_c.float(), w.to(dt).float()).to(dt)
    doutp, yhatp = _bn_bwd_terms(yp, gp.float(), pp)
    return gp, dw, dy.sum(0), doutp.sum(0), (doutp * yhatp).sum(0)


def first_bwd_plain(x2d: torch.Tensor, g: torch.Tensor,
                    p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row 15: BN_0's dx = T(gr * (dout - m1 - yhat * m2)),
    x2d and g (R, C0) of T."""
    dout, yhat = _bn_bwd_terms(x2d, g.float(), p)
    return _bn_dy(dout, yhat, p).to(x2d.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


# the kernels' fixed partition (csrc/fused_mlp.cu kTopWarps, kItems, kBM,
# kSlab): items (pooled groups or rows) a block of row 13, items a block of
# row 14's dy pass, rows a partial of the statistics and of T1/T2 (the
# dense passes' 64-row blocks), rows a slab of the dW product. Each
# depends on the shape only, so the cross-block sums are reproducible.
_TOP_ITEMS, _ITEMS, _ROWS, _SLAB = 8, 64, 64, 1024


def _check_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  what: str) -> None:
    """x of the activation type, a and b its (C,) f32 affine, one card."""
    _check_cuda(x, what, _ACT, x.dim())
    C = x.shape[-1]
    for name, t in (("a", a), ("b", b)):
        _check_cuda(t, name, (torch.float32,), 1)
        if t.shape[0] != C or t.device != x.device:
            raise ValueError(f"{name} must be ({C},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if C < 1:
        raise ValueError(f"{what} needs at least one channel")


def launch_fused_dense(x2d, a, b, w, bias, y, w16=None, part=None,
                       sums=None) -> None:
    """Launch pn2_fused_dense on checked, preallocated buffers (no launch
    count: :func:`fused_dense_kernel` counts). ``w16`` (Cout, Cin) bf16
    scratch for W rounded (bf16 only, else None); ``part`` (2, row blocks,
    Cout) and ``sums`` (2, Cout) f32 for the statistics, or None."""
    R, Cin = x2d.shape
    fn = _build.bind("fused_mlp", "pn2_fused_dense",
                     [ctypes.c_void_p] * 11
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
    ptrs = ((None,) * 4 if part is None else
            (part[0].data_ptr(), part[1].data_ptr(), sums[0].data_ptr(),
             sums[1].data_ptr()))
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                 None if w16 is None else w16.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), *ptrs, R, Cin, w.shape[0], x2d.element_size(),
                 _stream(x2d))
    _build.check("fused_mlp", err, "fused_dense launch")


def dense_w16(x2d: torch.Tensor, w: torch.Tensor):
    """The (Cout, Cin) bf16 scratch a bf16 dense pass rounds W into, or
    None for f32."""
    if x2d.dtype != torch.bfloat16:
        return None
    return torch.empty(w.shape, dtype=torch.bfloat16, device=x2d.device)


def fused_dense_kernel(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor,
                       want_stats: bool = False):
    """CUDA dense pass (csrc/fused_mlp.cu): contiguous x2d (R, Cin) f32 or
    bf16, a, b (Cin) f32, w (Cout, Cin) f32, bias (Cout) f32, on one card ->
    as :func:`dense_fwd_plain` (bf16: the product on the tensor cores, f32:
    on the CUDA cores, no TF32). Any R >= 0; Cin, Cout >= 1."""
    _check_affine(x2d, a, b, "x2d")
    if x2d.dim() != 2:
        raise ValueError(f"x2d must be (R, Cin), got {tuple(x2d.shape)}")
    R, Cin = x2d.shape
    _check_cuda(w, "w", (torch.float32,), 2)
    _check_cuda(bias, "bias", (torch.float32,), 1)
    Cout = w.shape[0]
    if (w.shape[1] != Cin or Cout < 1 or bias.shape[0] != Cout
            or w.device != x2d.device or bias.device != x2d.device):
        raise ValueError(f"w must be (Cout, {Cin}) and bias (Cout,) on "
                         f"{x2d.device}, got {tuple(w.shape)} and "
                         f"{tuple(bias.shape)}")
    dev = x2d.device
    y = torch.empty((R, Cout), dtype=x2d.dtype, device=dev)
    part = sums = None
    if want_stats:
        part = torch.empty((2, -(-R // _ROWS), Cout), dtype=torch.float32,
                           device=dev)
        sums = torch.zeros((2, Cout), dtype=torch.float32, device=dev)
    if R > 0:
        launch_fused_dense(x2d, a, b, w, bias, y, dense_w16(x2d, w), part,
                           sums)
        fused_dense_kernel.launches += 1
    return (y, None, None) if sums is None else (y, sums[0], sums[1])


fused_dense_kernel.launches = 0


def launch_fused_pool(y3d, a, b, out) -> None:
    """Launch pn2_fused_pool on checked, preallocated buffers."""
    G, S, C = y3d.shape
    fn = _build.bind("fused_mlp", "pn2_fused_pool",
                     [ctypes.c_void_p] * 4
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(y3d.device):
        err = fn(y3d.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 G, S, C, y3d.element_size(), _stream(y3d))
    _build.check("fused_mlp", err, "fused_pool launch")


def fused_pool_kernel(y3d: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """CUDA pooled tail (csrc/fused_mlp.cu): contiguous y3d (G, S, C) f32
    or bf16 with S >= 1, a, b (C) f32 -> (G, C), bit for bit as
    :func:`pool_fwd_plain`."""
    _check_affine(y3d, a, b, "y3d")
    if y3d.dim() != 3 or y3d.shape[1] < 1:
        raise ValueError(f"y3d must be (G, S >= 1, C), got "
                         f"{tuple(y3d.shape)}")
    G, _, C = y3d.shape
    out = torch.empty((G, C), dtype=y3d.dtype, device=y3d.device)
    if G == 0:
        return out
    launch_fused_pool(y3d, a, b, out)
    fused_pool_kernel.launches += 1
    return out


fused_pool_kernel.launches = 0


def launch_fused_affine(y2d, a, b, out) -> None:
    """Launch pn2_fused_affine on checked, preallocated buffers."""
    R, C = y2d.shape
    fn = _build.bind("fused_mlp", "pn2_fused_affine",
                     [ctypes.c_void_p] * 4
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
    with torch.cuda.device(y2d.device):
        err = fn(y2d.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 R, C, y2d.element_size(), _stream(y2d))
    _build.check("fused_mlp", err, "fused_affine launch")


def fused_affine_kernel(y2d: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """CUDA unpooled tail (csrc/fused_mlp.cu): contiguous y2d (R, C) f32 or
    bf16, a, b (C) f32 -> (R, C), bit for bit as :func:`affine_fwd_plain`."""
    _check_affine(y2d, a, b, "y2d")
    if y2d.dim() != 2:
        raise ValueError(f"y2d must be (R, C), got {tuple(y2d.shape)}")
    out = torch.empty_like(y2d)
    if y2d.shape[0] == 0:
        return out
    launch_fused_affine(y2d, a, b, out)
    fused_affine_kernel.launches += 1
    return out


fused_affine_kernel.launches = 0


def _check_pack(p: torch.Tensor, C: int, dev, name: str = "p") -> None:
    _check_cuda(p, name, (torch.float32,), 2)
    if tuple(p.shape) != (7, C) or p.device != dev:
        raise ValueError(f"{name} must be (7, {C}) on {dev}, got "
                         f"{tuple(p.shape)} on {p.device}")


def _check_cotangent(y: torch.Tensor, g: torch.Tensor, pool: bool) -> tuple:
    """y (G, S, C) and g (G, C) with pool, else both (R, C), of one type on
    one card; returns (items, S, C)."""
    _check_cuda(y, "y", _ACT, 3 if pool else 2)
    _check_cuda(g, "g", (y.dtype,), 2)
    items, C = y.shape[0], y.shape[-1]
    S = y.shape[1] if pool else 1
    if tuple(g.shape) != (items, C) or g.device != y.device:
        raise ValueError(f"g must be ({items}, {C}) on {y.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if S < 1 or C < 1:
        raise ValueError(f"y must have S >= 1 and C >= 1, got "
                         f"{tuple(y.shape)}")
    return items, S, C


def top_stats_part(items: int, C: int, device) -> torch.Tensor:
    """Row 13's f32 scratch: (2, item blocks of _TOP_ITEMS, C)."""
    return torch.empty((2, -(-items // _TOP_ITEMS), C), dtype=torch.float32,
                       device=device)


def launch_fused_top_stats(y, g, p, part, sums, S: int) -> None:
    """Launch pn2_fused_top_stats: ``part`` the (2, ceil(items /
    _TOP_ITEMS), C) f32 scratch of :func:`top_stats_part`, ``sums`` (2, C)
    f32 out."""
    items, C = y.shape[0], y.shape[-1]
    fn = _build.bind("fused_mlp", "pn2_fused_top_stats",
                     [ctypes.c_void_p] * 5
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), g.data_ptr(), p.data_ptr(), part.data_ptr(),
                 sums.data_ptr(), items, S, C, y.element_size(), _stream(y))
    _build.check("fused_mlp", err, "fused_top_stats launch")


def fused_top_stats_kernel(y: torch.Tensor, g: torch.Tensor, p: torch.Tensor,
                           pool: bool):
    """CUDA row 13 (csrc/fused_mlp.cu): contiguous y, g as
    :func:`top_stats_plain` takes them, f32 or bf16, p (7, C) f32 -> (T1,
    T2) (C,) f32, the plain version's sums in another (fixed) order."""
    items, S, C = _check_cotangent(y, g, pool)
    _check_pack(p, C, y.device)
    sums = torch.zeros((2, C), dtype=torch.float32, device=y.device)
    if items > 0:
        launch_fused_top_stats(y, g, p, top_stats_part(items, C, y.device),
                               sums, S)
        fused_top_stats_kernel.launches += 1
    return sums[0], sums[1]


fused_top_stats_kernel.launches = 0


def launch_fused_dense_bwd(yk, yp, g, pk, pp, w, bufs: dict, S: int) -> None:
    """Launch pn2_fused_dense_bwd on checked buffers: ``bufs`` holds the
    scratches w16 (Ck, Cp) bf16 (bf16 only, else None), dyc (R, Ck) T,
    db_part (item blocks, Ck), t_part (2, row blocks, Cp), dw_part (slabs,
    Ck, Cp), and the outputs gp (R, Cp) T, dw (Ck, Cp), db (Ck,), t (2,
    Cp)."""
    items, ck = yk.shape[0], yk.shape[-1]
    cp = yp.shape[-1]
    fn = _build.bind("fused_mlp", "pn2_fused_dense_bwd",
                     [ctypes.c_void_p] * 15
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    b = bufs
    w16 = None if b["w16"] is None else b["w16"].data_ptr()
    with torch.cuda.device(yk.device):
        err = fn(yk.data_ptr(), yp.data_ptr(), g.data_ptr(), pk.data_ptr(),
                 pp.data_ptr(), w.data_ptr(), w16, b["dyc"].data_ptr(),
                 b["db_part"].data_ptr(), b["gp"].data_ptr(),
                 b["t_part"].data_ptr(), b["dw_part"].data_ptr(),
                 b["dw"].data_ptr(), b["db"].data_ptr(), b["t"].data_ptr(),
                 items, S, ck, cp, yk.element_size(), _stream(yk))
    _build.check("fused_mlp", err, "fused_dense_bwd launch")


def dense_bwd_buffers(yk: torch.Tensor, cp: int, S: int) -> dict:
    """The scratches and outputs of one dense_bwd launch (see
    :func:`launch_fused_dense_bwd`)."""
    items, ck = yk.shape[0], yk.shape[-1]
    R = items * S
    dev, f32 = yk.device, torch.float32
    bf16 = yk.dtype == torch.bfloat16
    return {
        "w16": (torch.empty((ck, cp), dtype=torch.bfloat16, device=dev)
                if bf16 else None),
        "dyc": torch.empty((R, ck), dtype=yk.dtype, device=dev),
        "db_part": torch.empty((-(-items // _ITEMS), ck), dtype=f32,
                               device=dev),
        "gp": torch.empty((R, cp), dtype=yk.dtype, device=dev),
        "t_part": torch.empty((2, -(-R // _ROWS), cp), dtype=f32,
                              device=dev),
        "dw_part": torch.empty((-(-R // _SLAB), ck, cp), dtype=f32,
                               device=dev),
        "dw": torch.zeros((ck, cp), dtype=f32, device=dev),
        "db": torch.zeros(ck, dtype=f32, device=dev),
        "t": torch.zeros((2, cp), dtype=f32, device=dev),
    }


def fused_dense_bwd_kernel(yk: torch.Tensor, yp: torch.Tensor,
                           g: torch.Tensor, pk: torch.Tensor,
                           pp: torch.Tensor, w: torch.Tensor,
                           top_pool: bool):
    """CUDA row 14 (csrc/fused_mlp.cu): contiguous tensors as
    :func:`dense_bwd_plain` takes them, f32 or bf16 activations, f32 packs
    and w (Ck, Cp) -> as :func:`dense_bwd_plain`: dy bit for bit, the
    products and sums in another (fixed) order (bf16: both products on
    the tensor cores, f32: on the CUDA cores, no TF32)."""
    items, S, ck = _check_cotangent(yk, g, top_pool)
    _check_cuda(yp, "yp", (yk.dtype,), 2)
    R, cp = yp.shape
    if R != items * S or cp < 1 or yp.device != yk.device:
        raise ValueError(f"yp must be ({items * S}, Cp >= 1) on {yk.device},"
                         f" got {tuple(yp.shape)} on {yp.device}")
    _check_pack(pk, ck, yk.device, "pk")
    _check_pack(pp, cp, yk.device, "pp")
    _check_cuda(w, "w", (torch.float32,), 2)
    if tuple(w.shape) != (ck, cp) or w.device != yk.device:
        raise ValueError(f"w must be ({ck}, {cp}) on {yk.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    bufs = dense_bwd_buffers(yk, cp, S)
    if items > 0:
        launch_fused_dense_bwd(yk, yp, g, pk, pp, w, bufs, S)
        fused_dense_bwd_kernel.launches += 1
    return bufs["gp"], bufs["dw"], bufs["db"], bufs["t"][0], bufs["t"][1]


fused_dense_bwd_kernel.launches = 0


def launch_fused_first_bwd(x2d, g, p, dx) -> None:
    """Launch pn2_fused_first_bwd on checked, preallocated buffers."""
    R, C = x2d.shape
    fn = _build.bind("fused_mlp", "pn2_fused_first_bwd",
                     [ctypes.c_void_p] * 4
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), g.data_ptr(), p.data_ptr(), dx.data_ptr(),
                 R, C, x2d.element_size(), _stream(x2d))
    _build.check("fused_mlp", err, "fused_first_bwd launch")


def fused_first_bwd_kernel(x2d: torch.Tensor, g: torch.Tensor,
                           p: torch.Tensor) -> torch.Tensor:
    """CUDA row 15 (csrc/fused_mlp.cu): contiguous x2d, g (R, C0) f32 or
    bf16, p (7, C0) f32 -> dx (R, C0), bit for bit as
    :func:`first_bwd_plain`."""
    _, _, C = _check_cotangent(x2d, g, False)
    _check_pack(p, C, x2d.device)
    dx = torch.empty_like(x2d)
    if x2d.shape[0] > 0:
        launch_fused_first_bwd(x2d, g, p, dx)
        fused_first_bwd_kernel.launches += 1
    return dx


fused_first_bwd_kernel.launches = 0


# ---------------------------------------------------------------------------
# dispatch and the chain
# ---------------------------------------------------------------------------


def dense_fwd(x2d, a, b, w, bias, want_stats: bool = False):
    """Row 10: the kernel on a CUDA tensor, the plain version on a CPU one.
    Returns (y, sum, sumsq); the sums are None without ``want_stats``."""
    if config.use_kernel(x2d):
        return fused_dense_kernel(x2d.contiguous(), a.contiguous(),
                                  b.contiguous(), w.contiguous(),
                                  bias.contiguous(), want_stats)
    return dense_fwd_plain(x2d, a, b, w, bias, want_stats)


def pool_fwd(y3d, a, b) -> torch.Tensor:
    """Row 11: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if config.use_kernel(y3d):
        return fused_pool_kernel(y3d.contiguous(), a.contiguous(),
                                 b.contiguous())
    return pool_fwd_plain(y3d, a, b)


def affine_fwd(y2d, a, b) -> torch.Tensor:
    """Row 12: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if config.use_kernel(y2d):
        return fused_affine_kernel(y2d.contiguous(), a.contiguous(),
                                   b.contiguous())
    return affine_fwd_plain(y2d, a, b)


def top_stats(y, g, p, pool: bool):
    """Row 13: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if config.use_kernel(y):
        return fused_top_stats_kernel(y.contiguous(), g.contiguous(),
                                      p.contiguous(), pool)
    return top_stats_plain(y, g, p, pool)


def dense_bwd(yk, yp, g, pk, pp, w, top_pool: bool):
    """Row 14: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if config.use_kernel(yk):
        return fused_dense_bwd_kernel(yk.contiguous(), yp.contiguous(),
                                      g.contiguous(), pk.contiguous(),
                                      pp.contiguous(), w.contiguous(),
                                      top_pool)
    return dense_bwd_plain(yk, yp, g, pk, pp, w, top_pool)


def first_bwd(x2d, g, p) -> torch.Tensor:
    """Row 15: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if config.use_kernel(x2d):
        return fused_first_bwd_kernel(x2d.contiguous(), g.contiguous(),
                                      p.contiguous())
    return first_bwd_plain(x2d, g, p)


def bn_affine(scale, bias, mean, var, eps: float):
    """A BN as the per-channel f32 affine (a, b): x*a + b."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    return a, bias.float() - mean.float() * a


def _flat(denses, *groups) -> list:
    """The chain's tensors as one argument list of an autograd Function:
    W_1, bias_1, .., W_D, bias_D, then each group (scales, biases, ...)."""
    return [t for wb in denses for t in wb] + [t for g in groups for t in g]


def _unflat(flat, D: int, n_groups: int):
    """Inverse of :func:`_flat`: (denses, group_0, group_1, ...)."""
    denses = [(flat[2 * k], flat[2 * k + 1]) for k in range(D)]
    rest = flat[2 * D:]
    return (denses, *(rest[i * (D + 1):(i + 1) * (D + 1)]
                      for i in range(n_groups)))


def _tail(cfg: ChainConfig, cur, a, b, shape):
    B, M, S, _ = shape
    if cfg.pool:
        return pool_fwd(cur.reshape(B * M, S, -1), a, b).reshape(B, M, -1)
    return affine_fwd(cur, a, b).reshape(B, M, S, -1)


class _ChainEval(torch.autograd.Function):
    """The eval-mode chain, kept out of autograd on both devices: the JAX
    package's fused_chain_eval has no gradient (jax.grad over it fails), so
    a backward through it raises instead of returning none (the kernels
    write into fresh buffers) or another route's gradient."""

    @staticmethod
    def forward(ctx, cfg, x, D, *flat):
        denses, scales, biases, means, vars_ = _unflat(flat, D, 4)
        B, M, S, C0 = x.shape
        cur = x.reshape(B * M * S, C0)
        a, b = bn_affine(scales[0], biases[0], means[0], vars_[0], cfg.eps)
        for k, (w, bias) in enumerate(denses):
            cur, _, _ = dense_fwd(cur, a, b, w, bias)
            a, b = bn_affine(scales[k + 1], biases[k + 1], means[k + 1],
                             vars_[k + 1], cfg.eps)
        return _tail(cfg, cur, a, b, x.shape)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "the eval-mode fused SA chain is not differentiable, as in the "
            "JAX package (fused_chain_eval): train with model.train(), "
            "which takes the train-mode chain, or turn config.fused_mlp off")


def fused_chain_eval(cfg: ChainConfig, x: torch.Tensor, denses, scales,
                     biases, running) -> torch.Tensor:
    """Inference-mode fused chain (running statistics; forward only).

    x: (B, M, S, C_0) pre-BN_0 activations, f32 or bf16; denses: (W_k (Cout,
    Cin), bias_k) for k = 1..D; scales, biases: BN gamma and beta for BN_0
    .. BN_D; running: (mean, var) per BN. Returns (B, M, C_D) when cfg.pool,
    else (B, M, S, C_D), in x's type. A backward through it raises."""
    means, vars_ = zip(*running)
    return _ChainEval.apply(cfg, x, len(denses),
                            *_flat(denses, scales, biases, means, vars_))


class _ChainTrain(torch.autograd.Function):
    """fused_chain_train with its custom VJP (pointnet2_tpu/ops/pallas/
    fused_mlp.py:507-622): the forward saves every pre-BN activation, the
    backward rematerialises from them through rows 13-15."""

    @staticmethod
    def forward(ctx, cfg, x, D, *flat):
        denses, scales, biases = _unflat(flat, D, 2)
        B, M, S, C0 = x.shape
        n = B * M * S
        x2d = x.reshape(n, C0)
        xf = x2d.float()
        mean, meansq = _sync(cfg, xf.mean(0), xf.square().mean(0))
        means, vars_ = [mean], [torch.clamp_min(meansq - mean.square(), 0.0)]
        ys = [x2d]
        a, b = bn_affine(scales[0], biases[0], means[0], vars_[0], cfg.eps)
        for k, (w, bias) in enumerate(denses):
            y, s, ss = dense_fwd(ys[-1], a, b, w, bias, want_stats=True)
            mean, meansq = _sync(cfg, s / n, ss / n)  # the kernel's sums
            means.append(mean)
            vars_.append(torch.clamp_min(meansq - mean.square(), 0.0))
            ys.append(y)
            a, b = bn_affine(scales[k + 1], biases[k + 1], means[-1],
                             vars_[-1], cfg.eps)
        out = _tail(cfg, ys[-1], a, b, x.shape)
        ctx.cfg, ctx.shape, ctx.D = cfg, x.shape, D
        ctx.save_for_backward(*ys, *means, *vars_, *(w for w, _ in denses),
                              *scales, *biases)
        ctx.mark_non_differentiable(*means, *vars_)
        return (out, *means, *vars_)

    @staticmethod
    def backward(ctx, g_out, *_):
        cfg, D = ctx.cfg, ctx.D
        B, M, S, C0 = ctx.shape
        n = B * M * S
        saved = ctx.saved_tensors
        ys, rest = saved[:D + 1], saved[D + 1:]
        means, vars_ = rest[:D + 1], rest[D + 1:2 * D + 2]
        ws = rest[2 * D + 2:3 * D + 2]
        scales, biases = rest[3 * D + 2:4 * D + 3], rest[4 * D + 3:]

        def pack(j, t1=None, t2=None):
            # m1, m2: the means of the totals over the batch's rows; over
            # every rank's rows in a cross-replica step (the average of the
            # totals over n local rows is the global sum over the global
            # rows). The local totals themselves become d_biases/d_scales:
            # the step's gradient average covers them.
            if t1 is not None:
                t1, t2 = _sync(cfg, t1, t2)
            return bn_pack(scales[j], biases[j], means[j], vars_[j], cfg.eps,
                           None if t1 is None else t1 / n,
                           None if t2 is None else t2 / n)

        g_out = g_out.to(ys[0].dtype)
        y_top = ys[D].reshape(B * M, S, -1) if cfg.pool else ys[D]
        g = g_out.reshape(B * M, -1) if cfg.pool else g_out.reshape(
            ys[D].shape)
        t1, t2 = top_stats(y_top, g, pack(D), cfg.pool)
        d_scales, d_biases = [None] * (D + 1), [None] * (D + 1)
        d_denses = [None] * D
        d_biases[D], d_scales[D] = t1, t2
        for k in range(D, 0, -1):
            # in: BN_k's totals; out: g_{k-1} and BN_{k-1}'s totals
            g, dw, db, t1, t2 = dense_bwd(
                y_top if k == D else ys[k], ys[k - 1], g, pack(k, t1, t2),
                pack(k - 1), ws[k - 1], top_pool=cfg.pool and k == D)
            d_denses[k - 1] = (dw, db)
            d_biases[k - 1], d_scales[k - 1] = t1, t2
        dx = first_bwd(ys[0], g, pack(0, t1, t2))
        return (None, dx.reshape(ctx.shape), None,
                *_flat(d_denses, d_scales, d_biases))


def fused_chain_train(cfg: ChainConfig, x: torch.Tensor, denses, scales,
                      biases):
    """Training-mode fused chain (batch statistics), differentiable in x,
    the dense weights and biases and the BN scales and biases.

    Arguments as :func:`fused_chain_eval` without ``running``. Returns (out,
    stats): out as :func:`fused_chain_eval`'s, stats a tuple of (mean, var)
    per BN (f32, no gradient), the batch statistics for the running update
    (pointnet2_tpu/ops/pallas/fused_mlp.py:541-554)."""
    out, *st = _ChainTrain.apply(cfg, x, len(denses),
                                 *_flat(denses, scales, biases))
    D1 = len(denses) + 1
    return out, tuple(zip(st[:D1], st[D1:]))


def fused_chain_eligible(x_shape, dtype, n_dense: int) -> bool:
    """Whether the fused route takes this chain: the JAX package's rule
    (pointnet2_tpu/ops/pallas/fused_mlp.py:646-660), so that the same
    layers take the same route in both packages. Requires >= 1 dense layer,
    a 4-D (B, M, S, C) input whose row count has a power-of-two factor >=
    16 and an even M*S, and f32 or bf16. The CUDA kernels themselves mask
    their edges and take any row count; the rule is the TPU kernels'
    exact-tile one."""
    if n_dense < 1 or len(x_shape) != 4:
        return False
    if dtype not in _ACT:
        return False
    B, M, S, C = x_shape
    rows = B * M * S
    return (rows & (-rows)) >= 16 and (M * S) % 2 == 0
