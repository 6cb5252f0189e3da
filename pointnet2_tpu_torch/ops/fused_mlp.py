"""Fused (BN -> ReLU -> Dense)* -> max-pool chain of the set-abstraction
MLP, forward in eval mode.

Port of pointnet2_tpu/ops/pallas/fused_mlp.py:103-230,625-660. The chain
covers BN_0 .. BN_D and the dense layers W_1 .. W_D; its input is the
pre-BN_0 grouped tensor (B, M, S, C_0), the lifted first dense gathered
(nn/pointnet.py). Each BN j runs on its running statistics as the per-channel
f32 affine ``a_j = scale_j * rsqrt(var_j + eps)``, ``b_j = bias_j - mean_j *
a_j``, and each step of the chain is one kernel of csrc/fused_mlp.cu:

- ``dense_fwd`` (row 10, ``_dense_fwd``): ``y = T(T(relu(x*a + b)) @
  T(W)^T + bias)`` for x (R, Cin) of the activation type T (f32 or bf16),
  accumulated in f32, and optionally the f32 column sum and sum of squares
  of the rounded y (the BN statistics of a train-mode pass);
- ``pool_fwd`` (row 11, ``_pool_fwd``): ``max_S T(relu(y*a + b))``, (G, S,
  C) -> (G, C);
- ``affine_fwd`` (row 12, ``_affine_fwd``): ``T(relu(y*a + b))``, the tail
  without pooling.

Every ``relu(v*a + b)`` rounds the product and the sum apart, and f32 stays
f32 (no TF32, config.disable_tf32). Each op runs its kernel on CUDA tensors
and its plain PyTorch version on CPU tensors (``config.use_kernel``); the
kernel wrappers count their launches in ``<wrapper>.launches``. Weights are
nn.Linear's (Cout, Cin); the Flax kernel is its transpose.
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
    """Static chain description (the cross-replica BN axis of the JAX
    package comes with scale-out)."""

    eps: float
    pool: bool  # max-pool over the S axis in the epilogue


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


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


def launch_fused_dense(x2d, a, b, w, bias, y, part=None, sums=None) -> None:
    """Launch pn2_fused_dense on checked, preallocated buffers (no launch
    count: :func:`fused_dense_kernel` counts). ``part`` (2, row blocks,
    Cout) and ``sums`` (2, Cout) f32 for the statistics, or None."""
    R, Cin = x2d.shape
    fn = _build.bind("fused_mlp", "pn2_fused_dense",
                     [ctypes.c_void_p] * 10
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
    ptrs = ((None,) * 4 if part is None else
            (part[0].data_ptr(), part[1].data_ptr(), sums[0].data_ptr(),
             sums[1].data_ptr()))
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                 bias.data_ptr(), y.data_ptr(), *ptrs, R, Cin, w.shape[0],
                 x2d.element_size(), _stream(x2d))
    _build.check("fused_mlp", err, "fused_dense launch")


def fused_dense_kernel(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor,
                       want_stats: bool = False):
    """CUDA dense pass (csrc/fused_mlp.cu): contiguous x2d (R, Cin) f32 or
    bf16, a, b (Cin) f32, w (Cout, Cin) f32, bias (Cout) f32, on one card ->
    as :func:`dense_fwd_plain`. Any R >= 0; Cin, Cout >= 1."""
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
        part = torch.empty((2, -(-R // 64), Cout), dtype=torch.float32,
                           device=dev)
        sums = torch.zeros((2, Cout), dtype=torch.float32, device=dev)
    if R > 0:
        launch_fused_dense(x2d, a, b, w, bias, y, part, sums)
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


def bn_affine(scale, bias, mean, var, eps: float):
    """Eval BN as the per-channel f32 affine (a, b): x*a + b."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    return a, bias.float() - mean.float() * a


def fused_chain_eval(cfg: ChainConfig, x: torch.Tensor, denses, scales,
                     biases, running) -> torch.Tensor:
    """Inference-mode fused chain (running statistics; forward only).

    x: (B, M, S, C_0) pre-BN_0 activations, f32 or bf16; denses: (W_k (Cout,
    Cin), bias_k) for k = 1..D; scales, biases: BN gamma and beta for BN_0
    .. BN_D; running: (mean, var) per BN. Returns (B, M, C_D) when cfg.pool,
    else (B, M, S, C_D), in x's type."""
    B, M, S, C0 = x.shape
    cur = x.reshape(B * M * S, C0)
    a, b = bn_affine(scales[0], biases[0], *running[0], cfg.eps)
    for k, (w, bias) in enumerate(denses):
        cur, _, _ = dense_fwd(cur, a, b, w, bias)
        a, b = bn_affine(scales[k + 1], biases[k + 1], *running[k + 1],
                         cfg.eps)
    if cfg.pool:
        return pool_fwd(cur.reshape(B * M, S, -1), a, b).reshape(B, M, -1)
    return affine_fwd(cur, a, b).reshape(B, M, S, -1)


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
