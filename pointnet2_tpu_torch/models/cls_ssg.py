"""PointNet++ single-scale-grouping classifier, train and eval forward.

Port of pointnet2_tpu/models/cls_ssg.py (architecture parity with the
reference's models/pointnet2_cls_ssg.py:20-44):
SA(512, 0.2, 32, [64,64,128]) -> SA(128, 0.4, 64, [128,128,256]) ->
SA(group_all, [256,512,1024]) -> FC512 -> drop0.5 -> FC256 -> drop0.5 -> FC40.

Accepts (B, N, 3) clouds or (B, N, 3+C) with extra channels (normals) used
as initial point features. With ``dtype=torch.bfloat16`` activations run in
bf16 while parameters, BN statistics, geometry (FPS, ball query, new_xyz)
and the logits stay float32, as in the JAX package.

Train mode (``model.train()``): BN on batch statistics with the running
update weighted by ``bn_momentum``, and dropout 0.5 after fc1 and fc2 with
masks drawn from ``generator`` (on the model's device).
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.nn.layers import (
    DenseBN,
    init_dense,
    replica_rows,
    taped_mask,
)
from pointnet2_tpu_torch.nn.pointnet import SetAbstraction


class Dropout(nn.Module):
    """Inverted dropout as flax.linen.Dropout: in train mode keep each
    element with probability 1-rate and scale it by 1/(1-rate), else zero
    it. The keep mask comes from :meth:`keep_mask` (``torch.rand`` on the
    given generator; ``F.dropout`` takes none), drawn for the global batch
    of a cross-replica step, of which this rank keeps its rows
    (nn/layers.py's ``replica_rows``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def keep_mask(self, shape, device, generator):
        return torch.rand(shape, generator=generator,
                          device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        off, total = replica_rows(x.shape[0])

        def draw():
            keep = self.keep_mask((total, *x.shape[1:]), x.device, generator)
            return keep[off:off + x.shape[0]]

        keep = taped_mask(draw)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class PointNet2ClsSSG(nn.Module):
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
        feat = in_channels - 3
        self.sa1 = SetAbstraction(512, 0.2, 32, feat, (64, 64, 128),
                                  dtype=dtype)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, (128, 128, 256),
                                  dtype=dtype)
        self.sa3 = SetAbstraction(None, None, None, 256, (256, 512, 1024),
                                  group_all=True, dtype=dtype)
        self.fc1 = DenseBN(1024, 512, dtype=dtype)
        self.drop1 = Dropout(0.5)
        self.fc2 = DenseBN(512, 256, dtype=dtype)
        self.drop2 = Dropout(0.5)
        # as in the JAX model, the classifier layer has no dtype: it computes
        # in the promotion of its bf16 input and its f32 weights
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
        l1_xyz, l1_points, _ = self.sa1(l0_xyz, l0_points, m)
        l2_xyz, l2_points, _ = self.sa2(l1_xyz, l1_points, m)
        _, l3_points, _ = self.sa3(l2_xyz, l2_points, m)

        net = l3_points.reshape(l3_points.shape[0], -1)
        net = self.drop1(self.fc1(net, m), generator)
        net = self.drop2(self.fc2(net, m), generator)
        return self.fc3(net).float()
