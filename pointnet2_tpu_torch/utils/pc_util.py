"""Surface-voxel label voting of the ScanNet voxel-accuracy protocol.

The port's copy of pointnet2_tpu/utils/pc_util.py:25-63 (the reference's
scannet/pc_util.py:23-51). The rest of that module (volumes, PLY IO,
rendering) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def _voxel_index(point_cloud, res):
    """Per-point voxel index and the grid's extent in voxels.

    The per-axis index can reach nvox (the max-coordinate point) while nvox
    is also the stride, so voxel (nvox0, y, z) aliases (0, y+1, z). The
    reference has the same formula; it is kept bit for bit, since the
    protocol's voxel accuracy depends on it."""
    coordmin = point_cloud.min(axis=0)
    nvox = np.ceil((point_cloud.max(axis=0) - coordmin) / res)
    vidx = np.ceil((point_cloud - coordmin) / res)
    vidx = vidx[:, 0] + vidx[:, 1] * nvox[0] + vidx[:, 2] * nvox[0] * nvox[1]
    return vidx, nvox


def point_cloud_label_to_surface_voxel_label(point_cloud, label, res=0.0484):
    """Majority label per occupied voxel. label: (N,) or (N, K).
    Returns (voxel ids, their labels, nvox)."""
    vidx, nvox = _voxel_index(point_cloud, res)
    uvidx, inverse = np.unique(vidx, return_inverse=True)
    label2d = label[:, None] if label.ndim == 1 else label
    uvlabel = np.zeros((len(uvidx), label2d.shape[1]), label2d.dtype)
    for k in range(label2d.shape[1]):
        # majority vote by a 2-D bincount over (voxel, class)
        ncls = int(label2d[:, k].max()) + 1
        counts = np.zeros((len(uvidx), ncls), np.int64)
        np.add.at(counts, (inverse, label2d[:, k].astype(np.int64)), 1)
        uvlabel[:, k] = counts.argmax(axis=1)
    return uvidx, (uvlabel[:, 0] if label.ndim == 1 else uvlabel), nvox


def point_cloud_label_to_surface_voxel_label_fast(point_cloud, label,
                                                  res=0.0484):
    """First point's label per occupied voxel (the variant behind the
    reference's ScanNet voxel accuracy). Returns (voxel ids, labels,
    nvox)."""
    vidx, nvox = _voxel_index(point_cloud, res)
    uvidx, vpidx = np.unique(vidx, return_index=True)
    uvlabel = label[vpidx] if label.ndim == 1 else label[vpidx, :]
    return uvidx, uvlabel, nvox
