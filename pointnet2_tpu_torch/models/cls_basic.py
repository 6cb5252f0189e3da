"""PointNet v1 baseline classifier, train and eval forward.

Port of pointnet2_tpu/models/cls_basic.py (architecture parity with the
reference's models/pointnet_cls_basic.py:21-64): per-point MLP
(64,64,64,128,1024) -> global max-pool -> FC512 -> FC256 -> drop0.3 ->
FC40. Every input channel goes into the per-point MLP. No point op: it
launches none of the port's kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.models.cls_ssg import Dropout
from pointnet2_tpu_torch.nn.layers import DenseBN, SharedMLP, init_dense
from pointnet2_tpu_torch.ops import max_pool


class PointNetClsBasic(nn.Module):
    """Built on ``device`` (CUDA by default; without a card that raises)
    in eval mode, with Xavier-uniform dense weights drawn from ``seed``."""

    def __init__(self, num_classes: int = 40, dtype=None, in_channels: int = 3,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = config.check_device(device)
        config.disable_tf32()
        if dtype == torch.float32:
            dtype = None  # float32 compute is the no-dtype default
        self.num_classes = num_classes
        self.dtype = dtype
        self.point_mlp = SharedMLP(in_channels, (64, 64, 64, 128, 1024),
                                   dtype=dtype)
        self.fc1 = DenseBN(1024, 512, dtype=dtype)
        self.fc2 = DenseBN(512, 256, dtype=dtype)
        self.drop = Dropout(0.3)
        self.fc3 = DenseBN(256, num_classes, bn=False, relu=False)
        init_dense(self, seed)
        self.to(device)
        self.eval()

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, N, C) -> float32 logits (B, num_classes)."""
        m = bn_momentum
        net = point_cloud if self.dtype is None else point_cloud.to(self.dtype)
        if self.point_mlp.pooled_max_supported():
            # the global max-pool commuted before the last BN affine, so
            # the (B, N, 1024) tensor skips its normalize pass
            net = self.point_mlp.call_pooled(net, 1, m)
        else:
            net = max_pool(self.point_mlp(net, m), 1)
        net = self.fc2(self.fc1(net, m), m)
        net = self.drop(net, generator)
        return self.fc3(net).float()
