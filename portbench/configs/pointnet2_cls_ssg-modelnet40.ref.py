"""The plain reference of this configuration, float32, no kernels of the
program: the published SSG classifier built from the configuration file's
layer lists (reference/model.py), the tensors it reads, the work it does
(harness/counts.py), and the published train.py's ModelNet40
augmentation and per-cloud cross-entropy (reference/train.py)."""

from portbench.harness.counts import forward_flops, fps_shapes
from portbench.reference.model import layout, pointnet2
from portbench.reference.train import augment_cls, cloud_cross_entropy

__all__ = ["forward", "layout", "forward_flops", "fps_shapes", "augment",
           "loss"]

forward = pointnet2
augment = augment_cls
loss = cloud_cross_entropy
