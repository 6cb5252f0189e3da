"""Layers of the port: BatchNorm, ConvBN/DenseBN, SharedMLP,
SetAbstraction and FeaturePropagation."""

from pointnet2_tpu_torch.nn.layers import BatchNorm, ConvBN, DenseBN, SharedMLP
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction

__all__ = ["BatchNorm", "ConvBN", "DenseBN", "FeaturePropagation",
           "SetAbstraction", "SharedMLP"]
