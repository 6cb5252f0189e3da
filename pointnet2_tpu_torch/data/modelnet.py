"""ModelNet40 HDF5 loader (numpy, host side).

Port of pointnet2_tpu/data/modelnet.py:37-118, the multi-file HDF5 reader
of the reference (modelnet_h5_dataset.py:54-118): per-epoch shuffle of the
rows, slice to npoints, fixed-shape batches whose padded tail is marked by
``nvalid``. ``h5py`` is imported when a dataset is opened, not at import.

Not ported yet: the resampled-txt ``ModelNetDataset`` (normals), host-side
``augment_cls_batch`` (train with the on-device ``augment="cls"``), and
multi-host sharding (``process_shard``).
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Centroid-center + unit-sphere scale (the reference's normalization
    in both modelnet_dataset.py and part_dataset_all_normal.py)."""
    centroid = pc.mean(axis=0)
    pc = pc - centroid
    return pc / np.max(np.sqrt(np.sum(pc ** 2, axis=1)))


def _pad_batch(arrs: list[np.ndarray], batch_size: int):
    """Pad a short final batch with copies of its last row; returns the
    arrays and the count of real rows."""
    n = arrs[0].shape[0]
    if n == batch_size:
        return arrs, n
    reps = [arr[-1:].repeat(batch_size - n, axis=0) for arr in arrs]
    return [np.concatenate([a, r], 0) for a, r in zip(arrs, reps)], n


def _zero_cls_batch(batch_size: int, npoints: int, channels: int) -> dict:
    """All-padding classification batch (nvalid=0), from shape metadata."""
    return {"points": np.zeros((batch_size, npoints, channels), np.float32),
            "label": np.zeros((batch_size,), np.int32), "nvalid": 0}


class ModelNetH5Dataset:
    """Multi-file HDF5 ModelNet40 reader (XYZ, up to 2048 points/shape).

    ``list_filename`` names one .h5 file per line (the reference's
    train_files.txt); a relative name is looked up beside the list."""

    def __init__(self, list_filename: str, batch_size: int = 32,
                 npoints: int = 1024, shuffle: bool = True, seed: int = 0):
        import h5py  # deferred: only needed for the real dataset

        self.batch_size = batch_size
        self.npoints = npoints
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        base = os.path.dirname(list_filename)
        with open(list_filename) as f:
            files = [line.strip() for line in f if line.strip()]
        data, label = [], []
        for fn in files:
            path = (fn if os.path.isabs(fn)
                    else os.path.join(base, os.path.basename(fn)))
            with h5py.File(path, "r") as h5:
                data.append(np.asarray(h5["data"][:], np.float32))
                label.append(np.asarray(h5["label"][:], np.int32).reshape(-1))
        self.data = np.concatenate(data, 0)
        self.label = np.concatenate(label, 0)

    def __len__(self):
        return self.data.shape[0]

    def num_channel(self) -> int:
        return 3

    def num_batches(self) -> int:
        return -(-len(self) // self.batch_size)

    def zero_batch(self) -> dict:
        return _zero_cls_batch(self.batch_size, self.npoints,
                               self.num_channel())

    def epoch(self, augment: bool = False) -> Iterator[dict]:
        if augment:
            raise NotImplementedError(
                "host-side augment_cls_batch is not ported; augment on the "
                "device instead (TrainConfig(augment='cls'))")
        order = (self._rng.permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), self.batch_size):
            sel = order[start:start + self.batch_size]
            pts = self.data[sel, : self.npoints, :].copy()
            lbl = self.label[sel].copy()
            (pts, lbl), nvalid = _pad_batch([pts, lbl], self.batch_size)
            yield {"points": pts.astype(np.float32), "label": lbl,
                   "nvalid": nvalid}
