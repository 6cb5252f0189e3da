"""PointNet++ set abstraction and feature propagation, train and eval
forward.

Port of pointnet2_tpu/nn/pointnet.py:74-234,330-398 for what the
single-scale models run: the ``fuse_first`` layout with max pooling, the
group_all module, and feature propagation. The first MLP layer's dense is
linear, so it commutes with the neighbour gather and the centre
subtraction:

    Dense(concat[gather(xyz) - c, gather(pts)])
      == gather(Dense(concat[xyz, pts])) - c @ W_xyz

The dense therefore runs on the N un-gathered points, the gather moves
mlp[0]-wide rows, and only BN+ReLU touch the grouped tensor. Feature
propagation splits its first dense the same way around the interpolation.
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
    max_pool,
    query_ball_point,
    three_interpolate,
    three_nn,
)


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
    """PointNet++ SA module (single-scale or group-all) with max pooling.

    ``feature_channels`` is the channel count of ``points`` (0 when the
    module gets xyz only). forward(xyz (B,N,3), points (B,N,C) | None) ->
    (new_xyz (B,np,3) f32, new_points (B,np,mlp[-1]), idx (B,np,ns))."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, feature_channels: int,
                 mlp: Sequence[int], group_all: bool = False,
                 use_xyz: bool = True, dtype=None):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        self.use_xyz = use_xyz
        self.dtype = dtype
        with_xyz = use_xyz or feature_channels == 0
        in_features = feature_channels + (3 if with_xyz else 0)
        self.mlp_mod = SharedMLP(in_features, mlp, dtype=dtype)

    def _fused_forward(self, xyz, points, bn_momentum):
        """Sample/group with the first dense lifted through the gather."""
        new_xyz = gather_point(xyz, farthest_point_sample(xyz, self.npoint))
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
        if self.mlp_mod.pooled_max_supported():
            # pool commuted before the last BN affine: the widest tensor
            # skips its normalize+ReLU pass (ConvBN.post_pooled_max)
            pooled = self.mlp_mod.finish_first_pooled(grouped, 2, bn_momentum)
        else:
            pooled = max_pool(self.mlp_mod.finish_first(grouped, bn_momentum),
                              2)
        return new_xyz, pooled, idx

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None,
                bn_momentum=0.9):
        """BN runs on batch statistics in train mode (``.train()``), where
        ``bn_momentum`` weights the running update; in eval it is unused."""
        if not self.group_all:
            return self._fused_forward(xyz, points, bn_momentum)
        new_xyz, new_points, idx, _ = sample_and_group_all(xyz, points,
                                                           self.use_xyz)
        if self.dtype is not None:
            new_points = new_points.to(self.dtype)
        if self.mlp_mod.pooled_max_supported():
            new_points = self.mlp_mod.call_pooled(new_points, 2, bn_momentum)
        else:
            new_points = max_pool(self.mlp_mod(new_points, bn_momentum), 2)
        return new_xyz, new_points, idx


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
