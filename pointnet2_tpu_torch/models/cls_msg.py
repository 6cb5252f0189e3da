"""PointNet++ multi-scale-grouping classifier, train and eval forward.

Port of pointnet2_tpu/models/cls_msg.py (architecture parity with the
reference's models/pointnet2_cls_msg.py:17-39):
MSG(512, [0.1,0.2,0.4], [16,32,128], [[32,32,64],[64,64,128],[64,96,128]])
-> MSG(128, [0.2,0.4,0.8], [32,64,128], [[64,64,128],[128,128,256],
[128,128,256]]) -> SA(group_all, [256,512,1024]) -> FC512 -> drop0.6 ->
FC256 -> drop0.6 -> FC40.

The 5000-point xyz+normal recipe uses nsample 128 in the first two layers:
``sa1_nsample`` / ``sa2_nsample``. Inputs, dtypes and train mode as in
``cls_ssg``.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.models.cls_ssg import Dropout
from pointnet2_tpu_torch.nn.layers import DenseBN, init_dense
from pointnet2_tpu_torch.nn.pointnet import SetAbstraction, SetAbstractionMSG


class PointNet2ClsMSG(nn.Module):
    """Built on ``device`` (CUDA by default; without a card that raises)
    in eval mode, with Xavier-uniform dense weights drawn from ``seed``."""

    def __init__(self, num_classes: int = 40,
                 sa1_nsample: tuple[int, int, int] = (16, 32, 128),
                 sa2_nsample: tuple[int, int, int] = (32, 64, 128),
                 dtype=None, in_channels: int = 3, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = config.check_device(device)
        config.disable_tf32()
        if dtype == torch.float32:
            dtype = None  # float32 compute is the no-dtype default
        self.num_classes = num_classes
        self.sa1 = SetAbstractionMSG(
            512, (0.1, 0.2, 0.4), sa1_nsample, in_channels - 3,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)), dtype=dtype)
        self.sa2 = SetAbstractionMSG(
            128, (0.2, 0.4, 0.8), sa2_nsample, 64 + 128 + 128,
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)), dtype=dtype)
        self.sa3 = SetAbstraction(None, None, None, 128 + 256 + 256,
                                  (256, 512, 1024), group_all=True,
                                  dtype=dtype)
        self.fc1 = DenseBN(1024, 512, dtype=dtype)
        self.drop1 = Dropout(0.6)
        self.fc2 = DenseBN(512, 256, dtype=dtype)
        self.drop2 = Dropout(0.6)
        self.fc3 = DenseBN(256, num_classes, bn=False, relu=False)

        init_dense(self, seed)
        self.to(device)
        self.eval()

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, N, 3+C) -> float32 logits (B, num_classes)."""
        m = bn_momentum
        l0_xyz = point_cloud[..., :3]
        l0_points = point_cloud[..., 3:] if point_cloud.shape[-1] > 3 else None
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, m)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, m)
        _, l3_points, _ = self.sa3(l2_xyz, l2_points, m)

        net = l3_points.reshape(l3_points.shape[0], -1)
        net = self.drop1(self.fc1(net, m), generator)
        net = self.drop2(self.fc2(net, m), generator)
        return self.fc3(net).float()
