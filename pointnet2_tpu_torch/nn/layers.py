"""Base layers: batch norm with scheduled momentum, Dense+BN+ReLU blocks
and the shared point MLP.

Port of pointnet2_tpu/nn/layers.py:48-134,137-329. Parity notes:

- Xavier(glorot)-uniform dense weights, zero bias; parameters stay float32
  and each dense runs in its layer's dtype (``flax.linen.Dense(dtype=...,
  param_dtype=float32)``).
- BatchNorm: eps 1e-3, ``(x.f32 - mean) * rsqrt(var + eps) * scale + bias``
  computed in float32 (float64 for a float64 model) and cast back to the
  layer dtype. In train mode (``module.train()``) mean and var are the
  batch statistics, the mean and mean square over all axes but the channel
  with ``var = max(E[x^2] - E[x]^2, 0)``, and gradients flow through them;
  the running statistics are updated in place, outside autograd, as
  ``running*m + batch*(1-m)`` with the call-time momentum ``m`` (the
  bn_decay schedule, train/schedules.py). Not ``torch.nn.BatchNorm*``: its momentum
  convention is the opposite and its running variance unbiased.
- ``bn_momentum`` is a call-time argument of every block, as in the JAX
  package, and is read only in train mode: a number, or a 0-d float32
  tensor holding the same float32 value (what a CUDA graph of the train
  step passes, so that each replay reads its step's momentum).
- Cross-replica BN (``cross_replica``, pointnet2_tpu/nn/layers.py:28-62):
  while a data-parallel train step runs its forward and backward under a
  mesh of several ranks, train-mode BN averages its (mean, mean square)
  over the ranks before forming the variance, with one all-reduce of the
  stacked (2, C) statistics, so the step normalises as one global batch
  would. The average's backward averages the cotangent the same way: with
  L = (1/N) sum_j L_j and m the average, rank i's cotangent for its local
  statistics is (1/N) sum_j dL_j/dm, which makes the averaged gradient the
  global batch's. Dropout (models/cls_ssg.py) and the on-device
  augmentation draw for the global batch and keep the rank's rows
  (``replica_rows``).
- Rematerialisation (``RematTape``): a checkpointed forward runs twice, once
  in the forward and again inside the backward. The second run must not
  fold its batch statistics into the running ones again, nor draw other
  dropout masks from the step's generator, so BatchNorm skips its running
  update and dropout replays the masks of the first run while a tape
  replays.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.ops import fused_mlp
from pointnet2_tpu_torch.ops.pooling import max_pool
from pointnet2_tpu_torch.parallel.mesh import collective


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``:
    input, weight and bias are cast to it first. With ``dtype`` None the
    compute type is the promotion of the input's type and float32, as for a
    Flax Dense without a dtype."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Xavier-uniform weight, zero bias (tf_util.py:41-49,104-106)."""
        nn.init.xavier_uniform_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def forward_columns(self, x: torch.Tensor, start: int, stop: int,
                        bias: bool = True) -> torch.Tensor:
        """The dense on the input features [start, stop) alone, ``x @
        W[:, start:stop]^T`` plus the bias if ``bias``: a split of the dense
        around a concat, without multiplying the other block's zeros."""
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = self.bias.to(dt) if bias else None
        return F.linear(x.to(dt), self.weight[:, start:stop].to(dt), b)


def init_dense(model: nn.Module, seed: int) -> None:
    """Xavier-uniform weights and zero biases for every Dense of `model`,
    drawn in module order from one generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dense):
            m.reset_parameters(gen)


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """BN arithmetic runs in at least float32: f32 for bf16 and f32 inputs
    (as the JAX package), f64 for a float64 model (a test reference)."""
    return torch.promote_types(x.dtype, torch.float32)


_REPLICA: list = [None]  # the mesh of the running data-parallel step


@contextlib.contextmanager
def cross_replica(mesh):
    """Run a train step's forward and backward as one rank of ``mesh``
    (parallel/mesh.py): train-mode BN averages its statistics over the
    ranks, and dropout masks and augmentation parameters are drawn for the
    global batch, of which this rank keeps its rows. A mesh without a
    process group (one process) changes nothing."""
    _REPLICA.append(collective(mesh))
    try:
        yield
    finally:
        _REPLICA.pop()


def replica_rows(b: int) -> tuple[int, int]:
    """(this rank's first row, the global row count) of a batch of ``b``
    rows a rank; (0, b) outside a cross-replica step."""
    mesh = _REPLICA[-1]
    return (0, b) if mesh is None else mesh.rows(b)


class _ReplicaMean(torch.autograd.Function):
    """The average over the ranks, whose backward averages the cotangent
    over the ranks (JAX's pmean and its transpose)."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return mesh.mean(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.mean(g)


def _batch_stats(x: torch.Tensor):
    """Batch mean and biased var over all axes but the last, in at least
    float32, as pointnet2_tpu/nn/layers.py:48-62: (mean, mean square)
    averaged over the ranks of a cross-replica step before the variance."""
    xf = x.to(_stat_dtype(x))
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=dims)
    meansq = xf.square().mean(dim=dims)
    mesh = _REPLICA[-1]
    if mesh is not None:
        mean, meansq = _ReplicaMean.apply(
            mesh, torch.stack([mean, meansq])).unbind(0)
    return mean, torch.clamp_min(meansq - mean.square(), 0.0)


def _f32(v) -> float:
    """A momentum as the float32 value the JAX package computes with
    (``jnp.asarray(m, float32)``)."""
    return float(np.float32(v))


class RematTape:
    """What the first run of a checkpointed forward leaves for its second:
    the dropout masks it drew, in order. ``replaying`` is set for the
    second run (the recompute inside the backward)."""

    def __init__(self):
        self.masks: list[torch.Tensor] = []
        self.replaying = False
        self._next = 0

    def mask(self, draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        if not self.replaying:
            self.masks.append(draw())
            return self.masks[-1]
        self._next += 1
        return self.masks[self._next - 1]


_TAPE: RematTape | None = None


@contextlib.contextmanager
def remat_tape(tape: RematTape, replaying: bool):
    """Run a checkpointed forward under ``tape``: recording its masks, or
    (``replaying``) giving them back and skipping BN's running update."""
    global _TAPE
    prev = _TAPE
    tape.replaying, tape._next = replaying, 0
    _TAPE = tape
    try:
        yield
    finally:
        _TAPE = prev


def taped_mask(draw: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A dropout mask from ``draw()``, or, in a checkpointed forward, the
    one its tape recorded for this call."""
    return draw() if _TAPE is None else _TAPE.mask(draw)


class BatchNorm(nn.Module):
    """Batch normalization over the last axis with call-time momentum."""

    def __init__(self, num_features: int, epsilon: float = 1e-3, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _stats(self, x: torch.Tensor, momentum):
        """(mean, var) to normalize with: in train mode the batch's, after
        folding them into the running statistics; in eval the running
        ones."""
        if not self.training:
            return self.running_mean, self.running_var
        mean, var = _batch_stats(x)
        self.update_stats(mean, var, momentum)
        return mean, var

    def update_stats(self, mean: torch.Tensor, var: torch.Tensor,
                     momentum) -> None:
        """Fold batch statistics into the running ones, in place and outside
        autograd: ``running*m + batch*(1-m)``
        (pointnet2_tpu/nn/layers.py:95-112); the fused SA chain computes its
        statistics in its kernels and writes them back through here.
        ``momentum`` is a number or a 0-d float32 tensor (1 - m is then
        rounded to float32 on its device, as on the host). Nothing is
        folded while a remat tape replays: the forward already did."""
        if _TAPE is not None and _TAPE.replaying:
            return
        if isinstance(momentum, torch.Tensor):
            m, one_minus = momentum, 1.0 - momentum
        else:
            m = _f32(momentum)
            one_minus = _f32(np.float32(1.0) - np.float32(m))
        with torch.no_grad():
            self.running_mean.copy_(self.running_mean * m
                                    + mean.detach() * one_minus)
            self.running_var.copy_(self.running_var * m
                                   + var.detach() * one_minus)

    def forward(self, x: torch.Tensor, momentum=0.9) -> torch.Tensor:
        mean, var = self._stats(x, momentum)
        y = (x.to(_stat_dtype(x)) - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.weight + self.bias
        return y.to(self.dtype or x.dtype)

    def affine_coeffs(self, x: torch.Tensor, momentum=0.9):
        """The BN transform of ``x`` as per-channel f32 coefficients (a, b),
        with BN(x) == x*a + b up to float reassociation. In train mode the
        statistics are x's and the running ones are updated, as by
        ``forward``."""
        mean, var = self._stats(x, momentum)
        a = self.weight * torch.rsqrt(var + self.epsilon)
        return a, self.bias - mean * a


class ConvBN(nn.Module):
    """Dense (== 1x1 conv) + optional BN + optional ReLU over the channel
    axis. The linear part is exposed separately (``dense`` / ``post``) so
    SetAbstraction can lift the first matmul through the neighbour gather."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 relu: bool = True, dtype=None):
        super().__init__()
        self.bn = bn
        self.relu = relu
        self.dtype = dtype
        self.dense = Dense(in_features, features, dtype=dtype)
        if bn:
            self.norm = BatchNorm(features, dtype=dtype)

    def post(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        """The non-linear tail (BN + activation) after the dense."""
        if self.bn:
            x = self.norm(x, bn_momentum)
        if self.relu:
            x = torch.relu(x)
        return x

    def post_pooled_max(self, y: torch.Tensor, dim: int = -2,
                        bn_momentum=0.9) -> torch.Tensor:
        """``max_pool(post(y), dim)`` with the pool commuted before the BN:
        ``max relu(y*a+b) == relu(max_or_min(y)*a + b)`` exactly, max where
        a > 0 and min where a < 0, so the widest activation skips the
        normalize+ReLU pass. Requires bn=True and ReLU. The gradient routes
        through the first-occurrence max and min (ops.max_pool), and in
        train mode through y's batch statistics."""
        if not (self.bn and self.relu):
            raise ValueError("post_pooled_max needs BN and ReLU")
        a, b = self.norm.affine_coeffs(y, bn_momentum)
        hi = max_pool(y, dim)
        lo = -max_pool(-y, dim)
        sel = torch.where(a > 0, hi.to(a.dtype), lo.to(a.dtype))
        return torch.relu(sel * a + b).to(self.dtype or y.dtype)

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        return self.post(self.dense(x), bn_momentum)


# The reference distinguishes conv (on point grids) from fully_connected;
# both are the same Dense block.
DenseBN = ConvBN


class SharedMLP(nn.Module):
    """A stack of ConvBN layers applied pointwise (the per-point MLP),
    children named ``conv0``, ``conv1``, ... as in the JAX package.

    ``lift_first`` / ``finish_first`` split layer 0 around its dense so a
    caller can apply the first matmul on the un-gathered point set and the
    rest on the gathered neighbour tensor (see SetAbstraction)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 bn: bool = True, dtype=None):
        super().__init__()
        self.bn = bn
        widths = [in_features, *features]
        for i, f in enumerate(features):
            self.add_module(f"conv{i}",
                            ConvBN(widths[i], f, bn=bn, dtype=dtype))
        self.blocks = [getattr(self, f"conv{i}") for i in range(len(features))]

    def lift_first(self, x: torch.Tensor) -> torch.Tensor:
        """Apply only layer 0's dense (linear: commutes with gathers). In
        float32 this matmul runs in full float32 (TF32 is off, see
        config.disable_tf32): the caller subtracts a lifted centre term,
        which amplifies rounding."""
        return self.blocks[0].dense(x)

    def finish_first(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        """Layer 0's BN+activation, then the remaining layers."""
        x = self.blocks[0].post(x, bn_momentum)
        for block in self.blocks[1:]:
            x = block(x, bn_momentum)
        return x

    def pooled_max_supported(self) -> bool:
        """Whether the pool-before-affine tail applies (BN + ReLU chain)."""
        return self.bn and config.pooled_max_enabled()

    def finish_first_pooled(self, x: torch.Tensor, dim: int = -2,
                            bn_momentum=0.9):
        """``max_pool(finish_first(x), dim)`` with the last layer's BN+ReLU
        commuted after the pool (ConvBN.post_pooled_max)."""
        if len(self.blocks) == 1:
            # single layer: x is already that layer's pre-BN dense output
            return self.blocks[0].post_pooled_max(x, dim, bn_momentum)
        x = self.blocks[0].post(x, bn_momentum)
        for block in self.blocks[1:-1]:
            x = block(x, bn_momentum)
        last = self.blocks[-1]
        return last.post_pooled_max(last.dense(x), dim, bn_momentum)

    def call_pooled(self, x: torch.Tensor, dim: int = -2,
                    bn_momentum=0.9) -> torch.Tensor:
        """``max_pool(self(x), dim)`` with the pool-before-affine tail."""
        for block in self.blocks[:-1]:
            x = block(x, bn_momentum)
        last = self.blocks[-1]
        return last.post_pooled_max(last.dense(x), dim, bn_momentum)

    def fused_tail_supported(self, x: torch.Tensor, pool: bool) -> bool:
        """Whether `fused_tail` runs this chain (ops/fused_mlp.py), as
        pointnet2_tpu/nn/layers.py:274-290: BN on, >= 2 layers (the chain
        needs a dense after the lifted layer 0), the config gate, pooling,
        and the JAX package's eligible shapes and types. Every block of a
        SharedMLP has the ReLU the kernels assume."""
        return (self.bn
                and config.fused_mlp_enabled()
                and len(self.blocks) >= 2
                and pool
                and fused_mlp.fused_chain_eligible(
                    x.shape, x.dtype, len(self.blocks) - 1))

    def fused_tail(self, x: torch.Tensor, bn_momentum=0.9,
                   pool: bool = True) -> torch.Tensor:
        """Fused-kernel equivalent of ``finish_first`` + max-pool(dim=-2).

        ``x`` is the pre-BN_0 tensor (B, M, S, mlp[0]), the lifted first
        dense's gathered output. Runs BN_0 -> (dense_k + BN_k)_k -> max-pool
        as the kernels of csrc/fused_mlp.cu; the result equals the unfused
        path's up to float reassociation of the BN affine. In eval the BNs
        take their running statistics and the result has no gradient (a
        backward raises, as the JAX package's eval chain has none). In train
        mode they take the batch's, the chain is differentiable through its
        backward kernels, and each BN's running statistics are updated with
        ``bn_momentum`` (pointnet2_tpu/nn/layers.py:321-326)."""
        denses, scales, biases, running = [], [], [], []
        for i, block in enumerate(self.blocks):
            scales.append(block.norm.weight)
            biases.append(block.norm.bias)
            running.append((block.norm.running_mean, block.norm.running_var))
            if i > 0:
                denses.append((block.dense.weight, block.dense.bias))
        cfg = fused_mlp.ChainConfig(eps=self.blocks[0].norm.epsilon,
                                    pool=pool, replica=_REPLICA[-1])
        if self.training:
            out, stats = fused_mlp.fused_chain_train(cfg, x, denses, scales,
                                                     biases)
            for block, (mean, var) in zip(self.blocks, stats):
                block.norm.update_stats(mean, var, bn_momentum)
            return out
        return fused_mlp.fused_chain_eval(cfg, x, denses, scales, biases,
                                          running)

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, bn_momentum)
        return x
