"""ScanNet whole-scene tiling, numpy only.

The port's copy of ``ScannetDatasetWholeScene.block_members``
(pointnet2_tpu/data/scannet.py:337-365), which ``Predictor.predict_scene``
uses to cut a room into 1.5 m columns with 0.2 m overlap. The data set
classes come with the segmentation training slice.
"""

from __future__ import annotations

import numpy as np

BLOCK = 1.5  # column side, m
OVERLAP = 0.2  # the column grown by this on every side, m


def block_members(pts: np.ndarray, coordmin: np.ndarray, nx: int,
                  ny: int) -> np.ndarray:
    """(block_id, point_id) int64 pairs, sorted by block (stable), of the
    expanded (0.2 m overlap) membership test on an nx x ny grid of 1.5 m
    columns from ``coordmin``: each point lands in at most 4 blocks,
    floor((d -/+ 0.2) / 1.5) on each axis; block_id = bx * ny + by."""
    xy = pts[:, :2] - coordmin[:2]
    blo = np.floor((xy - OVERLAP) / BLOCK).astype(np.int64)  # (N, 2)
    bhi = np.floor((xy + OVERLAP) / BLOCK).astype(np.int64)
    pid = np.arange(len(pts), dtype=np.int64)
    # the 4 (x, y) combinations cover every owner; one duplicates the first
    # exactly when its floor equals the low floor on that axis, so keeping
    # it only where they differ gives each pair once
    dx = blo[:, 0] != bhi[:, 0]
    dy = blo[:, 1] != bhi[:, 1]
    combos = [(blo[:, 0], blo[:, 1], None),
              (bhi[:, 0], blo[:, 1], dx),
              (blo[:, 0], bhi[:, 1], dy),
              (bhi[:, 0], bhi[:, 1], dx & dy)]
    pairs = []
    for bx, by, extra in combos:
        keep = (bx >= 0) & (bx < nx) & (by >= 0) & (by < ny)
        if extra is not None:
            keep &= extra
        pairs.append(np.stack([(bx * ny + by)[keep], pid[keep]], 1))
    pairs = np.concatenate(pairs)
    order = np.argsort(pairs[:, 0], kind="stable")
    return pairs[order]
