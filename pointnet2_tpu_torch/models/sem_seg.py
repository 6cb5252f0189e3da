"""PointNet++ semantic segmentation (ScanNet), eval and train forward.

Port of pointnet2_tpu/models/sem_seg.py (architecture parity with the
reference's models/pointnet2_sem_seg.py:18-45): SA(1024, 0.1, 32,
[32,32,64]) -> SA(256, 0.2, 32, [64,64,128]) -> SA(64, 0.4, 32,
[128,128,256]) -> SA(16, 0.8, 32, [256,256,512]) -> FP [256,256] -> FP
[256,256] -> FP [256,128] -> FP [128,128,128] -> FC128 -> drop0.5 ->
FC num_classes, per point. Reads the xyz channels only. With
``dtype=torch.bfloat16`` activations run in bf16 while parameters, BN
statistics, geometry and the logits stay float32, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.models.cls_ssg import Dropout
from pointnet2_tpu_torch.nn.layers import DenseBN, init_dense
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction


class PointNet2SemSeg(nn.Module):
    """Built on ``device`` (CUDA by default; without a card that raises)
    in eval mode, with Xavier-uniform dense weights drawn from ``seed``."""

    def __init__(self, num_classes: int = 21, dtype=None, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = config.check_device(device)
        config.disable_tf32()
        if dtype == torch.float32:
            dtype = None  # float32 compute is the no-dtype default
        self.num_classes = num_classes
        self.sa1 = SetAbstraction(1024, 0.1, 32, 0, (32, 32, 64), dtype=dtype)
        self.sa2 = SetAbstraction(256, 0.2, 32, 64, (64, 64, 128),
                                  dtype=dtype)
        self.sa3 = SetAbstraction(64, 0.4, 32, 128, (128, 128, 256),
                                  dtype=dtype)
        self.sa4 = SetAbstraction(16, 0.8, 32, 256, (256, 256, 512),
                                  dtype=dtype)
        self.fp1 = FeaturePropagation(512, 256, (256, 256), dtype=dtype)
        self.fp2 = FeaturePropagation(256, 128, (256, 256), dtype=dtype)
        self.fp3 = FeaturePropagation(256, 64, (256, 128), dtype=dtype)
        self.fp4 = FeaturePropagation(128, 0, (128, 128, 128), dtype=dtype)
        self.fc1 = DenseBN(128, 128, dtype=dtype)
        self.drop1 = Dropout(0.5)
        # as in the JAX model, the classifier layer has no dtype
        self.fc2 = DenseBN(128, num_classes, bn=False, relu=False)
        init_dense(self, seed)
        self.to(device)
        self.eval()

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, N, 3+C) -> float32 logits (B, N, num_classes)."""
        m = bn_momentum
        l0_xyz = point_cloud[..., :3]
        l1_xyz, l1_points, _ = self.sa1(l0_xyz, None, m)
        l2_xyz, l2_points, _ = self.sa2(l1_xyz, l1_points, m)
        l3_xyz, l3_points, _ = self.sa3(l2_xyz, l2_points, m)
        l4_xyz, l4_points, _ = self.sa4(l3_xyz, l3_points, m)

        l3_points = self.fp1(l3_xyz, l4_xyz, l3_points, l4_points, m)
        l2_points = self.fp2(l2_xyz, l3_xyz, l2_points, l3_points, m)
        l1_points = self.fp3(l1_xyz, l2_xyz, l1_points, l2_points, m)
        l0_points = self.fp4(l0_xyz, l1_xyz, None, l1_points, m)

        net = self.drop1(self.fc1(l0_points, m), generator)
        return self.fc2(net).float()
