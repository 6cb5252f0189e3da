"""PointNet++ set abstraction (single-scale, group-all and multi-scale)
and feature propagation, train and eval forward.

Port of pointnet2_tpu/nn/pointnet.py, with its options: the pooling modes
max, avg, weighted_avg and max_and_avg, kNN or ball-query grouping,
use_xyz, bn, the post-pooling mlp2 stack, and both layouts of the first
dense. In the default ``fuse_first`` layout the first MLP layer's dense,
which is linear, commutes with the neighbour gather and the centre
subtraction:

    Dense(concat[gather(xyz) - c, gather(pts)])
      == gather(Dense(concat[xyz, pts])) - c @ W_xyz

The dense therefore runs on the N un-gathered points, the gather moves
mlp[0]-wide rows, and only BN+ReLU touch the grouped tensor. The unfused
layout (``fuse_first=False``, and always for weighted_avg and group_all)
groups the raw centred coordinates and features first, as the reference
does, through the ball query that also returns the neighbours' xyz.
Feature propagation splits its first dense the same way around the
interpolation. With ``config.fused_mlp`` on, the max-pooled MLP tail of the
fuse_first layout (SetAbstraction and SetAbstractionMSG) runs as the fused
chain (``SharedMLP.fused_tail``, ops/fused_mlp.py) where the JAX package
runs it; the unfused layout, group_all and feature propagation never do.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from pointnet2_tpu_torch.nn.layers import SharedMLP
from pointnet2_tpu_torch.ops import (
    farthest_point_sample,
    gather_point,
    group_point,
    knn_point,
    max_pool,
    query_ball_and_group_xyz,
    query_ball_point,
    three_interpolate,
    three_nn,
)

POOLINGS = ("max", "avg", "weighted_avg", "max_and_avg")


def sample_and_group(npoint: int, radius: float | None, nsample: int,
                     xyz: torch.Tensor, points: torch.Tensor | None,
                     knn: bool = False, use_xyz: bool = True, dtype=None):
    """FPS -> gather -> (ball query | kNN) -> group -> centre-subtract
    (pointnet2_tpu/nn/pointnet.py:36-71). Geometry (FPS, the neighbour
    search, new_xyz) stays f32; with ``dtype`` the grouped coordinates are
    centred and the features gathered in that dtype.

    Returns (new_xyz (B,npoint,3), new_points (B,npoint,nsample,3+C),
    idx (B,npoint,nsample), grouped_xyz (B,npoint,nsample,3))."""
    new_xyz = gather_point(xyz, farthest_point_sample(xyz, npoint))
    dt = dtype or xyz.dtype
    center = new_xyz[:, :, None, :].to(dt)
    if knn:
        _, idx = knn_point(nsample, xyz, new_xyz)
        grouped_xyz = group_point(xyz.to(dt), idx) - center
    else:
        idx, _, raw = query_ball_and_group_xyz(radius, nsample, xyz, new_xyz)
        grouped_xyz = raw.to(dt) - center
    if points is None:
        return new_xyz, grouped_xyz, idx, grouped_xyz
    grouped_points = group_point(points if dtype is None else points.to(dtype),
                                 idx)
    if use_xyz:
        new_points = torch.cat([grouped_xyz, grouped_points], dim=-1)
    else:
        new_points = grouped_points
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None,
                         use_xyz: bool = True):
    """Single global group at the origin (utils/pointnet_util.py:59-84).
    Returns (new_xyz (B,1,3), new_points (B,1,N,C'), idx (B,1,N),
    grouped_xyz (B,1,N,3))."""
    B, N, _ = xyz.shape
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    idx = torch.arange(N, dtype=torch.int32,
                       device=xyz.device)[None, None, :].expand(B, 1, N)
    grouped_xyz = xyz[:, None, :, :]
    if points is not None:
        if use_xyz:
            dt = torch.promote_types(xyz.dtype, points.dtype)
            new_points = torch.cat([xyz.to(dt), points.to(dt)], dim=2)
        else:
            new_points = points
        new_points = new_points[:, None, :, :]
    else:
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


def _pool(new_points: torch.Tensor, grouped_xyz: torch.Tensor | None,
          pooling: str) -> torch.Tensor:
    """Pooling over the nsample axis of (B, np, ns, C)
    (pointnet2_tpu/nn/pointnet.py:91-106); weighted_avg weights each
    neighbour by exp(-5 |offset|), normalised over the group, in the
    activation dtype."""
    if pooling == "max":
        return max_pool(new_points, 2)
    if pooling == "avg":
        return new_points.mean(dim=2)
    if pooling == "weighted_avg":
        dists = torch.linalg.vector_norm(grouped_xyz, dim=-1, keepdim=True)
        exp_dists = torch.exp(-dists * 5)
        weights = exp_dists / exp_dists.sum(dim=2, keepdim=True)
        return (new_points * weights).sum(dim=2)
    if pooling == "max_and_avg":
        return torch.cat([new_points.mean(dim=2), max_pool(new_points, 2)],
                         dim=-1)
    raise ValueError(f"unknown pooling {pooling!r}")


def _mlp_pool(mlp_mod: SharedMLP, pre: torch.Tensor,
              grouped_xyz: torch.Tensor | None, pooling: str,
              bn_momentum) -> torch.Tensor:
    """The shared MLP's tail on ``pre`` (B, np, ns, mlp[0]), layer 0's
    dense output, then the pooling over ns. Max pooling commutes the pool
    before the last BN affine where it applies, so the widest tensor skips
    its normalize+ReLU pass (ConvBN.post_pooled_max)."""
    if pooling == "max" and mlp_mod.pooled_max_supported():
        return mlp_mod.finish_first_pooled(pre, 2, bn_momentum)
    return _pool(mlp_mod.finish_first(pre, bn_momentum), grouped_xyz, pooling)


def _lifted_center_term(mlp_mod: SharedMLP, new_xyz: torch.Tensor,
                        feat_width: int, xyz_first: bool, dtype):
    """W_xyz^T . new_xyz for the lifted first dense, computed as
    Dense([c, 0]) - Dense([0, 0]) == c @ W_xyz (the bias cancels), in the
    same order as the JAX package so the two round alike."""
    B, M, _ = new_xyz.shape
    c = new_xyz.to(dtype)
    if feat_width:
        zeros = torch.zeros((B, M, feat_width), dtype=dtype,
                            device=new_xyz.device)
        csrc = torch.cat([c, zeros] if xyz_first else [zeros, c], dim=-1)
    else:
        csrc = c
    return mlp_mod.lift_first(csrc) - mlp_mod.lift_first(torch.zeros_like(csrc))


class SetAbstraction(nn.Module):
    """PointNet++ SA module (single-scale or group-all)
    (pointnet2_tpu/nn/pointnet.py:128-234).

    ``feature_channels`` is the channel count of ``points`` (0 when the
    module gets xyz only). Options as in the JAX module: ``mlp2`` (a shared
    MLP after the pooling, child ``mlp2_mod``), ``bn``, ``pooling`` (one of
    :data:`POOLINGS`), ``knn`` (kNN instead of the ball query), ``use_xyz``
    and ``fuse_first`` (the lifted first dense; weighted_avg and group_all
    always take the unfused layout). forward(xyz (B,N,3), points (B,N,C) |
    None) -> (new_xyz (B,np,3) f32, new_points (B,np,C'), idx (B,np,ns))."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, feature_channels: int,
                 mlp: Sequence[int], mlp2: Sequence[int] | None = None,
                 group_all: bool = False, bn: bool = True,
                 pooling: str = "max", knn: bool = False,
                 use_xyz: bool = True, dtype=None, fuse_first: bool = True):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}")
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        self.pooling = pooling
        self.knn = knn
        self.use_xyz = use_xyz
        self.dtype = dtype
        self.fuse_first = fuse_first
        with_xyz = use_xyz or feature_channels == 0
        in_features = feature_channels + (3 if with_xyz else 0)
        self.mlp_mod = SharedMLP(in_features, mlp, bn=bn, dtype=dtype)
        if mlp2:
            pooled = mlp[-1] * (2 if pooling == "max_and_avg" else 1)
            self.mlp2_mod = SharedMLP(pooled, mlp2, bn=bn, dtype=dtype)
        else:
            self.mlp2_mod = None

    def _fused_forward(self, xyz, points):
        """Sample/group with the first dense lifted through the gather;
        returns (new_xyz, layer 0's dense output, idx)."""
        new_xyz = gather_point(xyz, farthest_point_sample(xyz, self.npoint))
        if self.knn:
            _, idx = knn_point(self.nsample, xyz, new_xyz)
        else:
            idx, _ = query_ball_point(self.radius, self.nsample, xyz, new_xyz)

        dt = self.dtype or xyz.dtype
        cxyz = xyz.to(dt)
        if points is None:
            src = cxyz
        elif self.use_xyz:
            src = torch.cat([cxyz, points.to(dt)], dim=-1)
        else:
            src = points.to(dt)
        lifted = self.mlp_mod.lift_first(src)  # (B, N, mlp[0])
        grouped = group_point(lifted, idx)  # (B, np, ns, mlp[0])
        if points is None or self.use_xyz:
            feat_width = 0 if points is None else points.shape[-1]
            cw = _lifted_center_term(self.mlp_mod, new_xyz, feat_width,
                                     xyz_first=True, dtype=dt)
            grouped = grouped - cw[:, :, None, :]
        return new_xyz, grouped, idx

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None,
                bn_momentum=0.9):
        """BN runs on batch statistics in train mode (``.train()``), where
        ``bn_momentum`` weights the running update; in eval it is unused."""
        if (self.fuse_first and not self.group_all
                and self.pooling != "weighted_avg"):
            new_xyz, pre, idx = self._fused_forward(xyz, points)
            if (self.pooling == "max"
                    and self.mlp_mod.fused_tail_supported(pre, pool=True)):
                # the fused chain (csrc/fused_mlp.cu), checked before the
                # pool-before-affine tail, as pointnet2_tpu/nn/pointnet.py:
                # 192-197; the unfused layout never takes it
                new_points = self.mlp_mod.fused_tail(pre, bn_momentum)
            else:
                new_points = _mlp_pool(self.mlp_mod, pre, None, self.pooling,
                                       bn_momentum)
        else:
            if self.group_all:
                new_xyz, new_points, idx, grouped_xyz = sample_and_group_all(
                    xyz, points, self.use_xyz)
            else:
                new_xyz, new_points, idx, grouped_xyz = sample_and_group(
                    self.npoint, self.radius, self.nsample, xyz, points,
                    self.knn, self.use_xyz, dtype=self.dtype)
            if self.dtype is not None:
                new_points = new_points.to(self.dtype)
            new_points = _mlp_pool(self.mlp_mod,
                                   self.mlp_mod.lift_first(new_points),
                                   grouped_xyz, self.pooling, bn_momentum)
        if self.mlp2_mod is not None:
            new_points = self.mlp2_mod(new_points, bn_momentum)
        return new_xyz, new_points, idx


class SetAbstractionMSG(nn.Module):
    """PointNet++ SA module with multi-scale grouping
    (pointnet2_tpu/nn/pointnet.py:237-327): one FPS, then per radius a ball
    query, grouping, a shared MLP and a max-pool, concatenated. As the
    reference, it concatenates [features, xyz], the reverse of single-scale
    grouping. Children ``mlp_mods_0``, ``mlp_mods_1``, ... (the Flax
    scopes).

    ``fuse_first`` (default): per radius, the ball query and the gather of
    the lifted first dense; otherwise the ball query that also returns the
    neighbours' xyz, and the reference's layout. Both run one ball query
    per radius, as the JAX package does (``ops.query_ball_point_multi`` is
    the one-launch alternative). forward(xyz (B,N,3), points (B,N,C) |
    None) -> (new_xyz (B,npoint,3) f32, (B,npoint,sum of mlp[-1]))."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], feature_channels: int,
                 mlp_list: Sequence[Sequence[int]], bn: bool = True,
                 use_xyz: bool = True, dtype=None, fuse_first: bool = True):
        super().__init__()
        if not len(radius_list) == len(nsample_list) == len(mlp_list):
            raise ValueError("need one nsample and one mlp per radius")
        self.npoint = npoint
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.use_xyz = use_xyz
        self.dtype = dtype
        self.fuse_first = fuse_first
        with_xyz = use_xyz or feature_channels == 0
        in_features = feature_channels + (3 if with_xyz else 0)
        self.mlp_mods = []
        for i, mlp in enumerate(mlp_list):
            mod = SharedMLP(in_features, mlp, bn=bn, dtype=dtype)
            self.add_module(f"mlp_mods_{i}", mod)
            self.mlp_mods.append(mod)

    def _scales(self):
        return zip(self.mlp_mods, self.radius_list, self.nsample_list)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None,
                bn_momentum=0.9):
        new_xyz = gather_point(xyz, farthest_point_sample(xyz, self.npoint))
        dt = self.dtype or xyz.dtype
        cxyz = xyz.to(dt)
        cpoints = None if points is None else points.to(dt)
        outs = []
        if self.fuse_first:
            if cpoints is None:
                src = cxyz
            elif self.use_xyz:
                src = torch.cat([cpoints, cxyz], dim=-1)
            else:
                src = cpoints
            feat_width = 0 if cpoints is None else cpoints.shape[-1]
            center_needed = cpoints is None or self.use_xyz
            for mlp_mod, radius, nsample in self._scales():
                idx, _ = query_ball_point(radius, nsample, xyz, new_xyz)
                grouped = group_point(mlp_mod.lift_first(src), idx)
                if center_needed:
                    cw = _lifted_center_term(mlp_mod, new_xyz, feat_width,
                                             xyz_first=False, dtype=dt)
                    grouped = grouped - cw[:, :, None, :]
                if mlp_mod.fused_tail_supported(grouped, pool=True):
                    # pointnet2_tpu/nn/pointnet.py:296-298; the unfused
                    # layout below has no fused branch, as in JAX
                    outs.append(mlp_mod.fused_tail(grouped, bn_momentum))
                else:
                    outs.append(_mlp_pool(mlp_mod, grouped, None, "max",
                                          bn_momentum))
            return new_xyz, torch.cat(outs, dim=-1)

        center = new_xyz[:, :, None, :].to(dt)
        for mlp_mod, radius, nsample in self._scales():
            idx, _, raw = query_ball_and_group_xyz(radius, nsample, xyz,
                                                   new_xyz)
            grouped_xyz = raw.to(dt) - center
            if cpoints is None:
                grouped = grouped_xyz
            else:
                grouped = group_point(cpoints, idx)
                if self.use_xyz:
                    grouped = torch.cat([grouped, grouped_xyz], dim=-1)
            outs.append(_mlp_pool(mlp_mod, mlp_mod.lift_first(grouped), None,
                                  "max", bn_momentum))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """PointNet++ FP module: inverse-distance 3-NN upsampling of the known
    points' features to the unknown points, a skip connection, and a
    shared MLP (pointnet2_tpu/nn/pointnet.py:330-398, ``fuse_first``).

    ``known_channels`` is C2, the width of ``points2``; ``skip_channels``
    is C1, the width of ``points1`` (0 without a skip). The child is named
    ``mlp``, as the Flax scope, and keeps one first dense of width C2 + C1
    (the state_dict matches Flax's). That dense is applied by column
    slices: ``p2 @ W[:, :C2]^T + b`` on the M known points, interpolated,
    plus ``p1 @ W[:, C2:]^T`` on the N unknown points. The interpolation
    weights sum to 1, so this equals the dense on the concat up to float
    reassociation, and the bias counts once.

    forward(xyz1 (B,N,3), xyz2 (B,M,3), points1 (B,N,C1) | None,
    points2 (B,M,C2)) -> (B, N, mlp[-1])."""

    def __init__(self, known_channels: int, skip_channels: int,
                 mlp: Sequence[int], dtype=None):
        super().__init__()
        self.known_channels = known_channels
        self.dtype = dtype
        self.mlp = SharedMLP(known_channels + skip_channels, mlp, dtype=dtype)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: torch.Tensor | None, points2: torch.Tensor,
                bn_momentum=0.9) -> torch.Tensor:
        dist, idx = three_nn(xyz1, xyz2)
        # no gradient into the weights: the reference defines none
        dist = torch.clamp_min(dist, 1e-10)
        inv = 1.0 / dist
        weight = inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])
        dt = self.dtype or points2.dtype
        dense = self.mlp.blocks[0].dense
        c2 = self.known_channels
        lifted2 = dense.forward_columns(points2.to(dt), 0, c2)
        pre = three_interpolate(lifted2, idx, weight).to(dt)
        if points1 is not None:
            pre = pre + dense.forward_columns(points1.to(dt), c2,
                                              dense.in_features, bias=False)
        return self.mlp.finish_first(pre, bn_momentum)
