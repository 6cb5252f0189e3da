"""Model registry of the port: reference-compatible names -> modules.

Holds what has been ported; the JAX package's registry
(pointnet2_tpu/models/__init__.py) lists the rest.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from pointnet2_tpu_torch.models.cls_ssg import PointNet2ClsSSG
from pointnet2_tpu_torch.models.losses import classification_loss

__all__ = ["MODEL_REGISTRY", "ModelSpec", "PointNet2ClsSSG", "get_model"]


@dataclass(frozen=True)
class ModelSpec:
    cls: type
    loss: Callable
    task: str  # "cls"


MODEL_REGISTRY: dict[str, ModelSpec] = {
    "pointnet2_cls_ssg": ModelSpec(PointNet2ClsSSG, classification_loss,
                                   "cls"),
}


def get_spec(name: str) -> ModelSpec:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model {name!r} is not ported; ported: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def get_model(name: str, **kwargs: Any):
    """Instantiate a registered model by its reference-compatible name."""
    return get_spec(name).cls(**kwargs)
