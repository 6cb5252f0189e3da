"""ShapeNet-part segmentation data (xyz + normal + part labels), numpy only.

Port of pointnet2_tpu/data/shapenet_part.py, the host-side loader of
the reference's PartNormalDataset (part_seg/part_dataset_all_normal.py:
19-112): json split files, a per-shape txt of x,y,z,nx,ny,nz,seg rows,
unit-sphere normalisation, resampling with replacement to ``npoints``. The
category -> part-label map (``SEG_CLASSES``) and the categories' one-hot
ids (alphabetical, ``CATEGORY_ORDER``) are the reference's.

Also :class:`SyntheticShapeNetPart`, a learnable stand-in with the same
label structure. Batches hold ``points`` (B, N, 6) f32, ``seg`` (B, N)
int32, ``cls_label`` (B,) int32 and ``nvalid``. Both draw from
``np.random.default_rng`` streams in the JAX package's order, so the same
seed gives the same batches.

``process_shard=(rank, count)`` keeps a process's contiguous share of the
shapes (JAX shapenet_part.py:89-93). :class:`PartDataset` reads the older
.pts/.seg layout.
"""

from __future__ import annotations

import json
import os
from collections.abc import Iterator

import numpy as np

from pointnet2_tpu_torch.data.modelnet import (
    _pad_batch,
    host_slice,
    pc_normalize,
)


def _zero_part_batch(batch_size: int, npoints: int) -> dict:
    """All-padding part-seg batch (nvalid=0) from shape metadata (points
    are always xyz+normal, 6 channels)."""
    return {"points": np.zeros((batch_size, npoints, 6), np.float32),
            "seg": np.zeros((batch_size, npoints), np.int32),
            "cls_label": np.zeros((batch_size,), np.int32), "nvalid": 0}


SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}

SEG_LABEL_TO_CAT = {label: cat for cat, labels in SEG_CLASSES.items()
                    for label in labels}

# category -> one-hot id: the real data set numbers its categories in the
# line order of synsetoffset2category.txt, which is alphabetical; every
# other source uses this order too, so a checkpoint sees the same one-hots
CATEGORY_ORDER = sorted(SEG_CLASSES)

NUM_PARTS = 50
NUM_CATEGORIES = 16


class PartNormalDataset:
    """Reads shapenetcore_partanno_segmentation_benchmark_v0_normal:
    ``<root>/synsetoffset2category.txt``, ``<root>/train_test_split/
    shuffled_{train,val,test}_file_list.json`` and ``<root>/<synset>/
    <id>.txt``. ``split="trainval"`` takes train and val."""

    def __init__(self, root: str, npoints: int = 2048, split: str = "train",
                 normalize: bool = True, batch_size: int = 16,
                 shuffle: bool | None = None, cache_size: int = 20000,
                 seed: int = 0, process_shard: tuple[int, int] | None = None):
        self.root = root
        self.npoints = npoints
        self.normalize = normalize
        self.batch_size = batch_size
        self.shuffle = (split in ("train", "trainval")) if shuffle is None \
            else shuffle
        self._rng = np.random.default_rng(seed)
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            self.cat = dict(line.strip().split() for line in f if line.strip())
        split_dir = os.path.join(root, "train_test_split")

        def _ids(name):
            with open(os.path.join(split_dir,
                                   f"shuffled_{name}_file_list.json")) as f:
                return {d.split("/")[2] for d in json.load(f)}

        wanted = (_ids("train") | _ids("val") if split == "trainval"
                  else _ids(split))
        self.datapath = []
        for item, synset in self.cat.items():
            d = os.path.join(root, synset)
            for fn in sorted(os.listdir(d)):
                if os.path.splitext(fn)[0] in wanted:
                    self.datapath.append((item, os.path.join(d, fn)))
        self.classes = {cat: i for i, cat in enumerate(self.cat)}
        self.datapath = self.datapath[host_slice(len(self.datapath),
                                                 process_shard)]
        self.cache_size = cache_size
        self._cache: dict[int, tuple] = {}

    def __len__(self):
        return len(self.datapath)

    def num_batches(self) -> int:
        return -(-len(self) // self.batch_size)

    def zero_batch(self) -> dict:
        return _zero_part_batch(self.batch_size, self.npoints)

    def _get(self, index: int):
        if index in self._cache:
            return self._cache[index]
        cat, path = self.datapath[index]
        cls = np.int32(self.classes[cat])
        data = np.loadtxt(path).astype(np.float32)
        pts = data[:, 0:3]
        if self.normalize:
            pts = pc_normalize(pts)
        normal = data[:, 3:6]
        seg = data[:, -1].astype(np.int32)
        item = (pts, normal, seg, cls)
        if len(self._cache) < self.cache_size:
            self._cache[index] = item
        return item

    def _sample(self, index: int):
        pts, normal, seg, cls = self._get(index)
        choice = self._rng.choice(len(seg), self.npoints, replace=True)
        return (np.concatenate([pts[choice], normal[choice]], -1),
                seg[choice], cls)

    def epoch(self, augment: bool = False) -> Iterator[dict]:
        """One pass (shuffled for train splits), each shape resampled to
        ``npoints`` (host augmentation: none)."""
        order = (self._rng.permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), self.batch_size):
            sel = order[start:start + self.batch_size]
            items = [self._sample(i) for i in sel]
            pts = np.stack([it[0] for it in items])
            seg = np.stack([it[1] for it in items])
            cls = np.asarray([it[2] for it in items], np.int32)
            (pts, seg, cls), nvalid = _pad_batch([pts, seg, cls],
                                                 self.batch_size)
            yield {"points": pts.astype(np.float32), "seg": seg,
                   "cls_label": cls, "nvalid": nvalid}


class SyntheticShapeNetPart:
    """Learnable stand-in with the real label structure: each category's
    parts are angular sectors about z of a uniform cube of points, with
    random unit normals."""

    def __init__(self, num_samples: int = 64, npoints: int = 512,
                 batch_size: int = 8, shuffle: bool = True, seed: int = 0,
                 categories: list[str] | None = None):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        gen = np.random.default_rng(seed + 3)
        cats = list(categories) if categories else CATEGORY_ORDER
        data, segs, clss = [], [], []
        for i in range(num_samples):
            cat = cats[i % len(cats)]
            labels = SEG_CLASSES[cat]
            pts = gen.uniform(-1, 1, (npoints, 3)).astype(np.float32)
            ang = np.arctan2(pts[:, 1], pts[:, 0]) + np.pi
            part = np.minimum((ang / (2 * np.pi) * len(labels)).astype(int),
                              len(labels) - 1)
            normals = gen.standard_normal((npoints, 3)).astype(np.float32)
            normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
            data.append(np.concatenate([pts, normals], -1))
            segs.append(np.asarray(labels, np.int32)[part])
            clss.append(np.int32(CATEGORY_ORDER.index(cat)))
        self.data = np.stack(data)
        self.seg = np.stack(segs)
        self.cls = np.asarray(clss, np.int32)

    def __len__(self):
        return self.data.shape[0]

    def num_batches(self) -> int:
        return -(-len(self) // self.batch_size)

    def zero_batch(self) -> dict:
        return _zero_part_batch(self.batch_size, self.data.shape[1])

    def epoch(self, augment: bool = False) -> Iterator[dict]:
        """One pass in a fresh order (host augmentation: none)."""
        order = (self._rng.permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), self.batch_size):
            sel = order[start:start + self.batch_size]
            pts, seg, cls = (self.data[sel].copy(), self.seg[sel].copy(),
                             self.cls[sel].copy())
            (pts, seg, cls), nvalid = _pad_batch([pts, seg, cls],
                                                 self.batch_size)
            yield {"points": pts, "seg": seg, "cls_label": cls,
                   "nvalid": nvalid}


class PartDataset:
    """The older ShapeNet-part format (.pts points and .seg per-point
    labels) of the reference's visual test driver (part_seg/
    part_dataset.py); JAX shapenet_part.py:196-260. ``dataset[i]`` is one
    shape resampled with replacement to ``npoints``: (points, seg), or
    (points, category id) with ``classification``.

    Directory layout: <root>/<synset>/points/<id>.pts and
    <root>/<synset>/points_label/<id>.seg, with the same json split files
    as PartNormalDataset. Per-category seg labels are 1-based local ids.
    """

    def __init__(self, root: str, npoints: int = 2500,
                 classification: bool = False, class_choice=None,
                 split: str = "train", normalize: bool = True,
                 cache_size: int = 10000, seed: int = 0):
        self.root = root
        self.npoints = npoints
        self.classification = classification
        self.normalize = normalize
        self._rng = np.random.default_rng(seed)
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            self.cat = dict(line.strip().split() for line in f if line.strip())
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items() if k in class_choice}
        split_dir = os.path.join(root, "train_test_split")

        def _ids(name):
            with open(os.path.join(split_dir,
                                   f"shuffled_{name}_file_list.json")) as f:
                return {d.split("/")[2] for d in json.load(f)}

        wanted = (_ids("train") | _ids("val")) if split == "trainval" \
            else _ids(split)
        self.datapath = []
        for item, synset in self.cat.items():
            dir_point = os.path.join(root, synset, "points")
            dir_seg = os.path.join(root, synset, "points_label")
            for fn in sorted(os.listdir(dir_point)):
                token = os.path.splitext(fn)[0]
                if token in wanted:
                    self.datapath.append(
                        (item, os.path.join(dir_point, token + ".pts"),
                         os.path.join(dir_seg, token + ".seg")))
        self.classes = {cat: i for i, cat in enumerate(self.cat)}
        self.cache_size = cache_size
        self._cache: dict[int, tuple] = {}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index: int):
        if index in self._cache:
            pts, seg, cls = self._cache[index]
        else:
            cat, pts_path, seg_path = self.datapath[index]
            cls = np.int32(self.classes[cat])
            pts = np.loadtxt(pts_path).astype(np.float32)
            seg = np.loadtxt(seg_path).astype(np.int32)
            if self.normalize:
                pts = pc_normalize(pts)
            if len(self._cache) < self.cache_size:
                self._cache[index] = (pts, seg, cls)
        choice = self._rng.choice(len(seg), self.npoints, replace=True)
        pts, seg = pts[choice], seg[choice]
        if self.classification:
            return pts, cls
        return pts, seg
