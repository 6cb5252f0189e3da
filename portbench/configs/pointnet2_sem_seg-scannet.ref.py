"""The plain reference of this configuration, float32, no kernels of the
program: the published ScanNet segmenter built from the configuration
file's layer lists (reference/model.py), the tensors it reads and the
work it does (harness/counts.py). It is served, not trained, so it names
no augmentation or loss."""

from portbench.harness.counts import forward_flops, fps_shapes
from portbench.reference.model import layout, pointnet2

__all__ = ["forward", "layout", "forward_flops", "fps_shapes"]

forward = pointnet2
