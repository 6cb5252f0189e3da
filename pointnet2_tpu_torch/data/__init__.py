"""Data of the port: host-side loaders and augmentations (numpy) and the
on-device training augmentation (torch)."""

from pointnet2_tpu_torch.data.modelnet import ModelNetH5Dataset, pc_normalize
from pointnet2_tpu_torch.data.synthetic import SyntheticClassification

__all__ = ["ModelNetH5Dataset", "SyntheticClassification", "pc_normalize"]
