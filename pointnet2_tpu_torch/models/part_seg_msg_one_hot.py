"""PointNet++ part segmentation with multi-scale grouping and a one-hot
object-category label, eval and train forward.

Port of pointnet2_tpu/models/part_seg_msg_one_hot.py (architecture parity
with the reference's models/pointnet2_part_seg_msg_one_hot.py:19-47):
input (B, N, 6) xyz and normals plus a (B,) category label;
MSG(512, [0.1,0.2,0.4], [32,64,128], [[32,32,64],[64,64,128],[64,96,128]])
-> MSG(128, [0.4,0.8], [64,128], [[128,128,256],[128,196,256]]) ->
SA(group_all, [256,512,1024]) -> FP [256,256] -> FP [256,128] -> FP
[128,128], whose skip input is concat[one_hot(label, 16), xyz, normals]
(22 channels) -> FC128 -> drop0.5 -> FC num_parts, per point.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.models.cls_ssg import Dropout
from pointnet2_tpu_torch.nn.layers import DenseBN, init_dense
from pointnet2_tpu_torch.nn.pointnet import (
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMSG,
)

NUM_CATEGORIES = 16


def one_hot(labels: torch.Tensor, num: int, dtype) -> torch.Tensor:
    """(B,) integer labels -> (B, num) as ``jax.nn.one_hot``: a label
    outside [0, num) gives a row of zeros (``F.one_hot`` would raise)."""
    classes = torch.arange(num, device=labels.device)
    return (labels.long()[:, None] == classes).to(dtype)


class PointNet2PartSegMSGOneHot(nn.Module):
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
        self.sa1 = SetAbstractionMSG(
            512, (0.1, 0.2, 0.4), (32, 64, 128), 3,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)), dtype=dtype)
        self.sa2 = SetAbstractionMSG(
            128, (0.4, 0.8), (64, 128), 64 + 128 + 128,
            ((128, 128, 256), (128, 196, 256)), dtype=dtype)
        self.sa3 = SetAbstraction(None, None, None, 256 + 256,
                                  (256, 512, 1024), group_all=True,
                                  dtype=dtype)
        self.fp1 = FeaturePropagation(1024, 512, (256, 256), dtype=dtype)
        self.fp2 = FeaturePropagation(256, 320, (256, 128), dtype=dtype)
        self.fp3 = FeaturePropagation(128, NUM_CATEGORIES + 6, (128, 128),
                                      dtype=dtype)
        self.fc1 = DenseBN(128, 128, dtype=dtype)
        self.drop1 = Dropout(0.5)
        self.fc2 = DenseBN(128, num_parts, bn=False, relu=False)
        init_dense(self, seed)
        self.to(device)
        self.eval()

    def forward(self, point_cloud: torch.Tensor, cls_label: torch.Tensor,
                bn_momentum=0.9,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, N, 6+) clouds and (B,) labels -> float32 logits (B, N,
        num_parts)."""
        if point_cloud.shape[-1] < 6:
            raise ValueError("part_seg expects (B, N, 6) xyz+normal input, "
                             f"got {tuple(point_cloud.shape)}")
        m = bn_momentum
        B, N = point_cloud.shape[:2]
        l0_xyz = point_cloud[..., :3]
        l0_points = point_cloud[..., 3:6]
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, m)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, m)
        l3_xyz, l3_points, _ = self.sa3(l2_xyz, l2_points, m)

        l2_points = self.fp1(l2_xyz, l3_xyz, l2_points, l3_points, m)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points, m)
        hot = one_hot(cls_label, NUM_CATEGORIES, l0_xyz.dtype)
        hot = hot[:, None, :].expand(B, N, NUM_CATEGORIES)
        l0_all = torch.cat([hot, l0_xyz, l0_points], dim=-1)
        l0_points = self.fp3(l0_xyz, l1_xyz, l0_all, l1_points, m)

        net = self.drop1(self.fc1(l0_points, m), generator)
        return self.fc2(net).float()
