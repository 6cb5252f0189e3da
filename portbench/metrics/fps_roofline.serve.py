"""Kernels (``ops/sampling.py`` ``farthest_point_sample``, ``csrc/fps.cu``):
the samplings' least time by their operations over their measured time
at the model's shapes and the cell's batch, % (harness/fps.py)."""

from portbench.harness.fps import roofline_pct


def read(run):
    return roofline_pct(run)
