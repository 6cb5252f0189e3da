"""The plain PointNet++ of the reference, built from a configuration file's
layer lists: float32 activations, parameters in a dict keyed by the names
the configuration's layers give them, every dense on every row the
published model applies it to.

Set abstraction groups first, as the published model does: farthest point
sampling, the ball query, the neighbours' xyz less their centre
concatenated before their features, the shared MLP (dense, batch norm,
ReLU) and a max over the neighbours; ``group_all`` takes the whole cloud
as one group at the origin. Feature propagation weights the three nearest
known points by inverse squared distance, concatenates the skip features
after them, and runs its MLP. The head is dense (+ batch norm + ReLU +
dropout) layers; a classifier flattens the last set abstraction's output
first.

Batch norm: epsilon from the configuration; in train mode the batch's
mean and biased variance over every axis but the channel, E[x^2] - E[x]^2
clamped at 0, in eval the running statistics.

``Ctx.linear`` replaces each dense's product: :func:`fp8` is the control
of the benchmark's check, the reference in the precision below the
configuration's bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from portbench.reference import ops


def _round(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to a float8 format with one per-tensor scale (its
    largest magnitude onto the format's largest), back in t's dtype."""
    top = torch.finfo(fmt).max
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t.detach() / scale).to(fmt).to(t.dtype) * scale


class _FP8Linear(torch.autograd.Function):
    """x @ w^T + b computed as float8 training computes it: the operands
    and the output in e4m3, the gradient in e5m2 against the forward's
    rounded operands, sums in float32. The program keeps its activations
    in bfloat16 between layers; this keeps them in float8."""

    @staticmethod
    def forward(ctx, x, w, b):
        qx, qw = _round(x, torch.float8_e4m3fn), _round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(qx, qw)
        return _round(torch.nn.functional.linear(qx, qw, b),
                      torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        gx = qg @ qw
        gw = qg.reshape(-1, qg.shape[-1]).T @ qx.reshape(-1, qx.shape[-1])
        return gx, gw, qg.reshape(-1, qg.shape[-1]).sum(0)


def fp8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A dense layer computed in float8 (``_FP8Linear``): the control of
    the benchmark's check, the reference in the precision below the
    configuration's bfloat16."""
    return _FP8Linear.apply(x, w, b)


@dataclass
class Ctx:
    train: bool = False
    eps: float = 1e-3
    generator: torch.Generator | None = None  # dropout masks, train mode
    linear: Callable = F.linear
    stats: dict | None = None  # train mode: each batch norm's (mean, var)


def dense(ctx: Ctx, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return ctx.linear(x, p[f"{name}.dense.weight"], p[f"{name}.dense.bias"])


def batch_norm(ctx: Ctx, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if ctx.train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = torch.clamp_min(x.square().mean(dim=dims) - mean.square(), 0.0)
        if ctx.stats is not None:
            ctx.stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.norm.running_mean"], p[f"{name}.norm.running_var"]
    y = (x - mean) * torch.rsqrt(var + ctx.eps)
    return y * p[f"{name}.norm.weight"] + p[f"{name}.norm.bias"]


def mlp(ctx: Ctx, p: dict, prefix: str, x: torch.Tensor, depth: int):
    for i in range(depth):
        name = f"{prefix}.conv{i}"
        x = torch.relu(batch_norm(ctx, p, name, dense(ctx, p, name, x)))
    return x


def set_abstraction(ctx: Ctx, p: dict, spec: dict, xyz: torch.Tensor,
                    points: torch.Tensor | None):
    prefix = f"{spec['name']}.mlp_mod"
    if spec.get("group_all"):
        grouped = xyz if points is None else torch.cat([xyz, points], -1)
        new_xyz = torch.zeros_like(xyz[:, :1])
        x = mlp(ctx, p, prefix, grouped[:, None], len(spec["mlp"]))
        return new_xyz, x.amax(dim=2)
    new_xyz = ops.gather(xyz, ops.fps(xyz, spec["npoint"]))
    idx = ops.ball_query(spec["radius"], spec["nsample"], xyz, new_xyz)
    grouped = ops.gather(xyz, idx) - new_xyz[:, :, None, :]
    if points is not None:
        grouped = torch.cat([grouped, ops.gather(points, idx)], -1)
    x = mlp(ctx, p, prefix, grouped, len(spec["mlp"]))
    return new_xyz, x.amax(dim=2)


def feature_propagation(ctx: Ctx, p: dict, spec: dict, xyz1, xyz2, points1,
                        points2) -> torch.Tensor:
    dist, idx = ops.three_nn(xyz1, xyz2)
    inv = 1.0 / torch.clamp_min(dist, 1e-10)
    weight = inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])
    rows = ops.gather(points2, idx)  # (B, N, 3, C)
    x = (rows * weight[..., None]).sum(dim=2)
    if points1 is not None:
        x = torch.cat([x, points1], -1)
    return mlp(ctx, p, f"{spec['name']}.mlp", x, len(spec["mlp"]))


def head(ctx: Ctx, p: dict, specs: list, x: torch.Tensor) -> torch.Tensor:
    for spec in specs:
        x = dense(ctx, p, spec["name"], x)
        if spec["bn"]:
            x = torch.relu(batch_norm(ctx, p, spec["name"], x))
        rate = spec["dropout"]
        if ctx.train and rate:
            keep = torch.rand(x.shape, generator=ctx.generator,
                              device=x.device) < 1.0 - rate
            x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    return x


def pointnet2(ctx: Ctx, p: dict, cfg: dict, cloud: torch.Tensor):
    """(B, N, 3 + C) float32 -> logits, (B, K) for a classifier (no
    ``fp`` list), (B, N, K) for a segmenter."""
    xyz = cloud[..., :3]
    points = cloud[..., 3:] if cloud.shape[-1] > 3 else None
    levels = [(xyz, points)]
    for spec in cfg["sa"]:
        levels.append(set_abstraction(ctx, p, spec, *levels[-1]))
    if not cfg["fp"]:
        feat = levels[-1][1]
        return head(ctx, p, cfg["head"], feat.reshape(feat.shape[0], -1))
    feat = levels[-1][1]
    for i, spec in enumerate(cfg["fp"]):
        xyz1, points1 = levels[-2 - i]
        feat = feature_propagation(ctx, p, spec, xyz1, levels[-1 - i][0],
                                   points1, feat)
    return head(ctx, p, cfg["head"], feat)


def layout(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor that :func:`pointnet2` reads for
    ``cfg``, kind one of weight, bias, scale, shift, var (harness/weights.py
    draws each kind alike)."""
    out = []

    def block(name: str, fan_in: int, fan_out: int, bn: bool = True):
        out.append((f"{name}.dense.weight", (fan_out, fan_in), "weight"))
        out.append((f"{name}.dense.bias", (fan_out,), "bias"))
        if bn:
            for field, kind in (("weight", "scale"), ("bias", "shift"),
                                ("running_mean", "shift"),
                                ("running_var", "var")):
                out.append((f"{name}.norm.{field}", (fan_out,), kind))

    width = cfg["in_channels"] - 3
    widths = [width]
    for spec in cfg["sa"]:
        w = 3 + width
        for i, f in enumerate(spec["mlp"]):
            block(f"{spec['name']}.mlp_mod.conv{i}", w, f)
            w = f
        width = spec["mlp"][-1]
        widths.append(width)
    for i, spec in enumerate(cfg["fp"]):
        w = width + widths[-2 - i]
        for j, f in enumerate(spec["mlp"]):
            block(f"{spec['name']}.mlp.conv{j}", w, f)
            w = f
        width = spec["mlp"][-1]
    for spec in cfg["head"]:
        block(spec["name"], width, spec["width"], spec["bn"])
        width = spec["width"]
    return out
