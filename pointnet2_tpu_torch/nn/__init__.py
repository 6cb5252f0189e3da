"""Layers of the port: BatchNorm, ConvBN/DenseBN, SharedMLP,
SetAbstraction, SetAbstractionMSG and FeaturePropagation."""

from pointnet2_tpu_torch.nn.layers import BatchNorm, ConvBN, DenseBN, SharedMLP
from pointnet2_tpu_torch.nn.pointnet import (
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMSG,
    sample_and_group,
)

__all__ = ["BatchNorm", "ConvBN", "DenseBN", "FeaturePropagation",
           "SetAbstraction", "SetAbstractionMSG", "SharedMLP",
           "sample_and_group"]
