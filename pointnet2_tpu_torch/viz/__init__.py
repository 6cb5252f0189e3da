"""Visualization: the native ball-splat renderer and the interactive
viewer (a host renderer, built with g++ at first use)."""

from pointnet2_tpu_torch.viz.viewer import (  # noqa: F401
    native_library,
    render,
    showpoints,
)
