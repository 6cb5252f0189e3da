"""ModelNet40 loaders (numpy, host side): the HDF5 and resampled-txt
formats.

Port of pointnet2_tpu/data/modelnet.py:37-192, the reference's two readers:

- ``ModelNetH5Dataset``, the multi-file HDF5 reader
  (modelnet_h5_dataset.py:54-118): per-epoch shuffle of the rows, slice to
  npoints, and with ``epoch(augment=True)`` the host chain
  ``augment_cls_batch``;
- ``ModelNetDataset``, the resampled-txt reader with normals
  (modelnet_dataset.py:23-128): shape_names.txt and one CSV a shape
  (x,y,z,nx,ny,nz), normalised into the unit sphere, cached in memory, and
  with ``epoch(augment=True)`` the chain ``augment_cls_batch_with_normals``.

Both yield fixed-shape batches whose padded tail is marked by ``nvalid``.
``h5py`` is imported when an HDF5 set is opened, not at import. With
``process_shard=(rank, count)`` a reader keeps its contiguous share of the
items, by ``parallel.multihost.shard_bounds`` (JAX modelnet.py:28-35,85).
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np

from pointnet2_tpu_torch.data import augment as A
from pointnet2_tpu_torch.parallel.multihost import shard_bounds


def host_slice(n: int, shard: tuple[int, int] | None) -> slice:
    """The contiguous slice of n items that shard=(rank, count) owns; all
    of them without a shard."""
    if shard is None:
        return slice(None)
    return slice(*shard_bounds(n, *shard))


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
                 npoints: int = 1024, shuffle: bool = True, seed: int = 0,
                 process_shard: tuple[int, int] | None = None):
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
        sl = host_slice(len(self.label), process_shard)
        self.data, self.label = self.data[sl], self.label[sl]

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
        order = (self._rng.permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), self.batch_size):
            sel = order[start:start + self.batch_size]
            pts = self.data[sel, : self.npoints, :].copy()
            lbl = self.label[sel].copy()
            if augment:
                pts = A.augment_cls_batch(pts, self._rng)
            (pts, lbl), nvalid = _pad_batch([pts, lbl], self.batch_size)
            yield {"points": pts.astype(np.float32), "label": lbl,
                   "nvalid": nvalid}


class ModelNetDataset:
    """Resampled-txt ModelNet reader with optional normals (10k points a
    shape).

    Directory layout (modelnet40_normal_resampled)::

      <root>/modelnet40_shape_names.txt
      <root>/modelnet40_{train,test}.txt     (shape ids like airplane_0001)
      <root>/<class>/<shape_id>.txt          (CSV rows x,y,z,nx,ny,nz)

    The first ``npoints`` rows of a shape are kept and their xyz normalised
    into the unit sphere (modelnet_dataset.py:15-21); without
    ``normal_channel`` only xyz."""

    def __init__(self, root: str, batch_size: int = 32, npoints: int = 1024,
                 split: str = "train", normal_channel: bool = True,
                 modelnet10: bool = False, cache_size: int = 15000,
                 shuffle: bool | None = None, seed: int = 0,
                 process_shard: tuple[int, int] | None = None):
        self.root = root
        self.batch_size = batch_size
        self.npoints = npoints
        self.normal_channel = normal_channel
        self.shuffle = (split == "train") if shuffle is None else shuffle
        self._rng = np.random.default_rng(seed)
        prefix = "modelnet10" if modelnet10 else "modelnet40"
        with open(os.path.join(root, f"{prefix}_shape_names.txt")) as f:
            self.classes = {c.strip(): i for i, c in enumerate(f)
                            if c.strip()}
        with open(os.path.join(root, f"{prefix}_{split}.txt")) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.datapath = []
        for sid in ids:
            cls = "_".join(sid.split("_")[:-1])
            self.datapath.append((cls, os.path.join(root, cls, sid + ".txt")))
        self.datapath = self.datapath[host_slice(len(self.datapath),
                                                 process_shard)]
        self.cache_size = cache_size
        self._cache: dict[int, tuple[np.ndarray, np.int32]] = {}

    def __len__(self):
        return len(self.datapath)

    def num_channel(self) -> int:
        return 6 if self.normal_channel else 3

    def num_batches(self) -> int:
        return -(-len(self) // self.batch_size)

    def zero_batch(self) -> dict:
        return _zero_cls_batch(self.batch_size, self.npoints,
                               self.num_channel())

    def _get(self, index: int):
        if index in self._cache:
            return self._cache[index]
        cls, path = self.datapath[index]
        label = np.int32(self.classes[cls])
        pts = np.loadtxt(path, delimiter=",").astype(np.float32)
        pts = pts[: self.npoints, :]
        pts[:, 0:3] = pc_normalize(pts[:, 0:3])
        if not self.normal_channel:
            pts = pts[:, 0:3]
        if len(self._cache) < self.cache_size:
            self._cache[index] = (pts, label)
        return pts, label

    def epoch(self, augment: bool = False) -> Iterator[dict]:
        order = (self._rng.permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), self.batch_size):
            sel = order[start:start + self.batch_size]
            items = [self._get(i) for i in sel]  # one parse an item
            pts = np.stack([p for p, _ in items])
            lbl = np.asarray([lb for _, lb in items], np.int32)
            if augment:
                pts = A.augment_cls_batch_with_normals(pts, self._rng)
            (pts, lbl), nvalid = _pad_batch([pts, lbl], self.batch_size)
            yield {"points": pts.astype(np.float32), "label": lbl,
                   "nvalid": nvalid}
