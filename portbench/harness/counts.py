"""Work reckoned from a configuration's widths and a cell's shapes, and the
card's peaks: what the utilisation metrics divide by. Nothing here reads
how the program computes, so a change of implementation cannot move these
numbers.

Each configuration's reference (``configs/<config>.ref.py``) names the
count of its model, ``forward_flops`` and ``fps_shapes``; those below are
for a single-scale PointNet++ layer list (one MLP a set abstraction, the
lists of reference/model.py). Dense FLOPs (2 a multiply-add) of one
forward of one cloud:

- set abstraction, as the published model groups: every layer of the
  shared MLP on every one of the npoint x nsample grouped rows (the whole
  cloud for ``group_all``), the first on 3 + C input columns;
- feature propagation, as the port and the JAX package apply its first
  dense: the columns of the interpolated features on the M known points,
  those of the skip features on the N unknown ones (the interpolation
  weights sum to 1, so this is the same linear map), the other layers on
  the N points;
- the head on one row a cloud (a classifier) or on every point.

A train step counts three forwards (the backward's two products a dense):
``TRAIN_STEP_FORWARDS``.

Farthest point sampling: npoint x N x 10 float32 operations a cloud (a
selection step reads every point's running minimum: three differences,
three products, two sums, a minimum and a comparison), against the card's
float32 rate outside the tensor cores, as ``PERF.md`` bounds row 1.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, 700 W): bf16 on the tensor cores,
# float32 operations on the CUDA cores (67 TFLOP/s counting an FMA as two),
# HBM3 bytes a second
PEAK_BF16_FLOPS = 989e12
PEAK_F32_OPS = 33.5e12
PEAK_HBM_BYTES = 3.35e12

FPS_OPS_PER_PAIR = 10
TRAIN_STEP_FORWARDS = 3


def _mlp_flops(rows: int, width_in: int, mlp: list) -> int:
    total, w = 0, width_in
    for out in mlp:
        total += 2 * rows * w * out
        w = out
    return total


def levels(cfg: dict) -> list[tuple[int, int]]:
    """(points, feature width) of each level: the input cloud, then each
    set abstraction's output."""
    out = [(cfg["num_point"], cfg["in_channels"] - 3)]
    for spec in cfg["sa"]:
        n = 1 if spec.get("group_all") else spec["npoint"]
        out.append((n, spec["mlp"][-1]))
    return out


def forward_flops(cfg: dict) -> int:
    """Dense FLOPs of one forward of one cloud (module docstring)."""
    lv = levels(cfg)
    total = 0
    for spec, (n_in, c_in) in zip(cfg["sa"], lv):
        rows = n_in if spec.get("group_all") else (spec["npoint"]
                                                    * spec["nsample"])
        total += _mlp_flops(rows, 3 + c_in, spec["mlp"])
    width = lv[-1][1]
    for i, spec in enumerate(cfg["fp"]):
        n_known = lv[-1 - i][0]
        n_unknown, c_skip = lv[-2 - i]
        first = spec["mlp"][0]
        total += 2 * (n_known * width + n_unknown * c_skip) * first
        total += _mlp_flops(n_unknown, first, spec["mlp"][1:])
        width = spec["mlp"][-1]
    rows = cfg["num_point"] if cfg["fp"] else 1
    width = width if cfg["fp"] else lv[-1][0] * lv[-1][1]
    for spec in cfg["head"]:
        total += 2 * rows * width * spec["width"]
        width = spec["width"]
    return total


def fps_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(N, npoint) of each farthest point sampling of one forward."""
    lv = levels(cfg)
    return [(n_in, spec["npoint"]) for spec, (n_in, _) in zip(cfg["sa"], lv)
            if not spec.get("group_all")]


def fps_ops(n: int, npoint: int, clouds: int) -> int:
    return clouds * npoint * n * FPS_OPS_PER_PAIR


def fps_bound_s(n: int, npoint: int, clouds: int) -> float:
    """The least time the card takes for the sampling's operations."""
    return fps_ops(n, npoint, clouds) / PEAK_F32_OPS
