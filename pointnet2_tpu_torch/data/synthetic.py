"""Synthetic classification and segmentation data for tests, smoke runs
and offline work.

Port of pointnet2_tpu/data/synthetic.py:23-127: each class is a fixed
arrangement of Gaussian blobs drawn from a per-class seed, so a classifier
can overfit quickly and accuracy means something. It stands in for
ModelNet40 where the HDF5 files are absent, as the JAX package's training
CLI does without ``--data``. For segmentation each point's label is its
nearest of ``num_classes`` fixed anchors. Both draw from
``np.random.default_rng`` streams in the JAX package's order, so the same
seed gives the same arrays.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from pointnet2_tpu_torch.data.augment import jitter_point_cloud
from pointnet2_tpu_torch.data.modelnet import _pad_batch, _zero_cls_batch


class SyntheticClassification:
    """Gaussian-blob shapes, one blob arrangement per class."""

    def __init__(self, num_classes: int = 8, samples_per_class: int = 16,
                 npoints: int = 256, channels: int = 3, batch_size: int = 8,
                 blobs: int = 4, noise: float = 0.05, shuffle: bool = True,
                 seed: int = 0):
        if channels not in (3, 6):
            raise ValueError(f"channels must be 3 or 6, got {channels}")
        self.batch_size = batch_size
        self.npoints = npoints
        self.channels = channels
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

        n = num_classes * samples_per_class
        self.label = np.repeat(np.arange(num_classes), samples_per_class
                               ).astype(np.int32)
        centers = np.stack([
            np.random.default_rng(1000 + c).uniform(-1, 1, (blobs, 3))
            for c in range(num_classes)
        ])  # (num_classes, blobs, 3)
        gen = np.random.default_rng(seed + 1)
        assign = gen.integers(0, blobs, (n, npoints))
        base = centers[self.label[:, None], assign]  # (n, npoints, 3)
        pts = base + noise * gen.standard_normal((n, npoints, 3))
        pts = pts.astype(np.float32)
        if channels == 6:
            normals = gen.standard_normal((n, npoints, 3)).astype(np.float32)
            normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
            pts = np.concatenate([pts, normals], axis=-1)
        self.data = pts

    def __len__(self):
        return self.data.shape[0]

    def num_channel(self) -> int:
        return self.channels

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
            pts = self.data[sel].copy()
            lbl = self.label[sel].copy()
            if augment:
                pts = jitter_point_cloud(pts, self._rng)
            (pts, lbl), nvalid = _pad_batch([pts, lbl], self.batch_size)
            yield {"points": pts, "label": lbl, "nvalid": nvalid}


class SyntheticSegmentation:
    """Per-point labels = nearest anchor id; tests the seg decoders.
    Batches hold ``points`` (B, N, 3 or 6), ``seg`` (B, N) int32, ``smpw``
    (B, N) f32 (all ones) and ``nvalid``."""

    def __init__(self, num_classes: int = 6, num_samples: int = 32,
                 npoints: int = 512, channels: int = 3, batch_size: int = 4,
                 shuffle: bool = True, seed: int = 0):
        if channels not in (3, 6):
            raise ValueError(f"channels must be 3 or 6, got {channels}")
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        gen = np.random.default_rng(seed + 2)
        anchors = np.random.default_rng(2000).uniform(-1, 1, (num_classes, 3))
        pts = gen.uniform(-1, 1, (num_samples, npoints, 3)).astype(np.float32)
        d = np.linalg.norm(pts[:, :, None, :] - anchors[None, None], axis=-1)
        self.seg = np.argmin(d, axis=-1).astype(np.int32)  # (S, N)
        if channels == 6:
            normals = gen.standard_normal((num_samples, npoints, 3)
                                          ).astype(np.float32)
            normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
            pts = np.concatenate([pts, normals], axis=-1)
        self.data = pts
        self.smpw = np.ones_like(self.seg, np.float32)

    def __len__(self):
        return self.data.shape[0]

    def num_batches(self) -> int:
        return -(-len(self) // self.batch_size)

    def epoch(self, augment: bool = False) -> Iterator[dict]:
        """One pass in a fresh order (host augmentation: none)."""
        order = (self._rng.permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), self.batch_size):
            sel = order[start:start + self.batch_size]
            pts, seg, smpw = (self.data[sel].copy(), self.seg[sel].copy(),
                              self.smpw[sel].copy())
            (pts, seg, smpw), nvalid = _pad_batch([pts, seg, smpw],
                                                  self.batch_size)
            yield {"points": pts, "seg": seg, "smpw": smpw, "nvalid": nvalid}

    def zero_batch(self) -> dict:
        B, (N, C) = self.batch_size, self.data.shape[1:]
        return {"points": np.zeros((B, N, C), np.float32),
                "seg": np.zeros((B, N), np.int32),
                "smpw": np.zeros((B, N), np.float32), "nvalid": 0}
