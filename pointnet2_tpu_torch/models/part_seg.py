"""PointNet++ part segmentation (ShapeNet-part, single-scale grouping),
eval and train forward.

Port of pointnet2_tpu/models/part_seg.py (architecture parity with the
reference's models/pointnet2_part_seg.py:17-41): input (B, N, 6) xyz and
normals; SA(512, 0.2, 64, [64,64,128]) -> SA(128, 0.4, 64, [128,128,256])
-> SA(group_all, [256,512,1024]) -> FP [256,256] -> FP [256,128] -> FP
[128,128,128] (its skip input is concat[xyz, normals]) -> FC128 ->
drop0.5 -> FC num_parts, per point. FP1's known set is the group_all
centre, one point at the origin, so its three_nn has M = 1.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.models.cls_ssg import Dropout
from pointnet2_tpu_torch.nn.layers import DenseBN, init_dense
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction


class PointNet2PartSeg(nn.Module):
    """Built on ``device`` (CUDA by default; without a card that raises)
    in eval mode, with Xavier-uniform dense weights drawn from ``seed``."""

    def __init__(self, num_parts: int = 50, dtype=None, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = config.check_device(device)
        config.disable_tf32()
        if dtype == torch.float32:
            dtype = None  # float32 compute is the no-dtype default
        self.num_classes = num_parts  # outputs per point, read by Predictor
        self.sa1 = SetAbstraction(512, 0.2, 64, 3, (64, 64, 128), dtype=dtype)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, (128, 128, 256),
                                  dtype=dtype)
        self.sa3 = SetAbstraction(None, None, None, 256, (256, 512, 1024),
                                  group_all=True, dtype=dtype)
        self.fp1 = FeaturePropagation(1024, 256, (256, 256), dtype=dtype)
        self.fp2 = FeaturePropagation(256, 128, (256, 128), dtype=dtype)
        self.fp3 = FeaturePropagation(128, 6, (128, 128, 128), dtype=dtype)
        self.fc1 = DenseBN(128, 128, dtype=dtype)
        self.drop1 = Dropout(0.5)
        self.fc2 = DenseBN(128, num_parts, bn=False, relu=False)
        init_dense(self, seed)
        self.to(device)
        self.eval()

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, N, 6+) -> float32 logits (B, N, num_parts)."""
        if point_cloud.shape[-1] < 6:
            raise ValueError("part_seg expects (B, N, 6) xyz+normal input, "
                             f"got {tuple(point_cloud.shape)}")
        m = bn_momentum
        l0_xyz = point_cloud[..., :3]
        l0_points = point_cloud[..., 3:6]
        l1_xyz, l1_points, _ = self.sa1(l0_xyz, l0_points, m)
        l2_xyz, l2_points, _ = self.sa2(l1_xyz, l1_points, m)
        l3_xyz, l3_points, _ = self.sa3(l2_xyz, l2_points, m)

        l2_points = self.fp1(l2_xyz, l3_xyz, l2_points, l3_points, m)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points, m)
        l0_points = self.fp3(l0_xyz, l1_xyz,
                             torch.cat([l0_xyz, l0_points], dim=-1),
                             l1_points, m)

        net = self.drop1(self.fc1(l0_points, m), generator)
        return self.fc2(net).float()
