"""Model registry of the port: reference-compatible names -> modules.

The same names and tasks as the JAX package's registry
(pointnet2_tpu/models/__init__.py).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from pointnet2_tpu_torch.models.cls_basic import PointNetClsBasic
from pointnet2_tpu_torch.models.cls_msg import PointNet2ClsMSG
from pointnet2_tpu_torch.models.cls_ssg import PointNet2ClsSSG
from pointnet2_tpu_torch.models.losses import (
    classification_loss,
    segmentation_loss,
    weighted_segmentation_loss,
)
from pointnet2_tpu_torch.models.part_seg import PointNet2PartSeg
from pointnet2_tpu_torch.models.part_seg_msg_one_hot import (
    PointNet2PartSegMSGOneHot,
)
from pointnet2_tpu_torch.models.sem_seg import PointNet2SemSeg

__all__ = ["MODEL_REGISTRY", "ModelSpec", "PointNet2ClsMSG", "PointNet2ClsSSG",
           "PointNet2PartSeg", "PointNet2PartSegMSGOneHot", "PointNet2SemSeg",
           "PointNetClsBasic", "get_model"]


@dataclass(frozen=True)
class ModelSpec:
    cls: type
    loss: Callable
    task: str  # "cls" | "part_seg" | "part_seg_one_hot" | "sem_seg"


MODEL_REGISTRY: dict[str, ModelSpec] = {
    "pointnet_cls_basic": ModelSpec(PointNetClsBasic, classification_loss,
                                    "cls"),
    "pointnet2_cls_ssg": ModelSpec(PointNet2ClsSSG, classification_loss,
                                   "cls"),
    "pointnet2_cls_msg": ModelSpec(PointNet2ClsMSG, classification_loss,
                                   "cls"),
    "pointnet2_part_seg": ModelSpec(PointNet2PartSeg, segmentation_loss,
                                    "part_seg"),
    "pointnet2_part_seg_msg_one_hot": ModelSpec(
        PointNet2PartSegMSGOneHot, segmentation_loss, "part_seg_one_hot"),
    "pointnet2_sem_seg": ModelSpec(PointNet2SemSeg,
                                   weighted_segmentation_loss, "sem_seg"),
}


def get_spec(name: str) -> ModelSpec:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def get_model(name: str, **kwargs: Any):
    """Instantiate a registered model by its reference-compatible name."""
    return get_spec(name).cls(**kwargs)
