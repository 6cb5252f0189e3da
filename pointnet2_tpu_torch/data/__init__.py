"""Data of the port: host-side loaders and augmentations (numpy) and the
on-device training augmentation (torch)."""

from pointnet2_tpu_torch.data.modelnet import (
    ModelNetDataset,
    ModelNetH5Dataset,
    pc_normalize,
)
from pointnet2_tpu_torch.data.scannet import (
    ScannetDataset,
    ScannetDatasetVirtualScan,
    ScannetDatasetWholeScene,
    make_synthetic_scenes,
)
from pointnet2_tpu_torch.data.shapenet_part import (
    PartDataset,
    PartNormalDataset,
    SyntheticShapeNetPart,
)
from pointnet2_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticSegmentation,
)

__all__ = ["ModelNetDataset", "ModelNetH5Dataset", "PartDataset",
           "PartNormalDataset", "ScannetDataset",
           "ScannetDatasetVirtualScan", "ScannetDatasetWholeScene",
           "SyntheticClassification", "SyntheticSegmentation",
           "SyntheticShapeNetPart", "make_synthetic_scenes", "pc_normalize"]
