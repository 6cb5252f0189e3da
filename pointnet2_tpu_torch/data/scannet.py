"""ScanNet semantic-segmentation data, numpy only.

Port of pointnet2_tpu/data/scannet.py:

- :class:`ScannetDataset`, the training sampler of the reference
  (scannet/scannet_dataset.py:27-61): a random 1.5 x 1.5 m x full-height
  column around a scene point, up to 10 candidates until >= 70% of its
  points are annotated and >= 2% of its voxels occupied, ``npoints``
  resampled with replacement and weighted by the class-balancing weights
  (1/log(1.2 + freq), :17-24) masked to the strict interior; batches hold
  ``points`` (B, N, 3) f32, ``seg`` (B, N) int32, ``smpw`` (B, N) f32 and
  ``nvalid``, with the reference's input dropout (``wdp``) on train
  batches; with ``num_workers > 1`` the crops are sampled on a thread
  pool (``utils.prefetch.parallel_map``) from per-item seeds drawn up
  front, a stream of its own, as JAX's;
- :class:`ScannetDatasetWholeScene`, the evaluation tiler of the reference
  (scannet/scannet_dataset.py:64-120): 1.5 m columns, one ``npoints``
  sample a non-empty block;
- :class:`ScannetDatasetVirtualScan`, the reference's virtual-scan sampler
  (scannet/scannet_dataset.py:122-167): the points eight virtual cameras
  of a scene see (``utils.scene_util.virtual_scan``), each view resampled
  to ``npoints``, in the crop sampler's batch format;
- :func:`make_synthetic_scenes`, generated rooms for hermetic runs;
- :func:`block_members`, the 1.5 m columns with 0.2 m overlap that
  ``Predictor.predict_scene`` cuts a room into.

Scenes come from the reference pickle (``scannet_{split}.pickle``: two
pickled lists) or from an in-memory list of (points, labels). The random
streams are ``np.random.default_rng``'s, drawn in the JAX package's order,
so the same seed gives the same batches.

``process_shard=(rank, count)`` keeps a process's contiguous share of the
scenes after the class weights are computed on all of them (JAX
scannet.py:87-92), in every sampler.
"""

from __future__ import annotations

import os
import pickle
from collections.abc import Iterator

import numpy as np

from pointnet2_tpu_torch.data.modelnet import _pad_batch, host_slice
from pointnet2_tpu_torch.utils.prefetch import parallel_map
from pointnet2_tpu_torch.utils.scene_util import virtual_scan

NUM_CLASSES = 21

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


def compute_label_weights(labels_list) -> np.ndarray:
    """1/log(1.2+freq) class weights over the train histogram."""
    hist = np.zeros(NUM_CLASSES)
    for seg in labels_list:
        tmp, _ = np.histogram(seg, range(NUM_CLASSES + 1))
        hist += tmp
    freq = hist.astype(np.float32) / hist.sum()
    return (1.0 / np.log(1.2 + freq)).astype(np.float32)


def _load_scenes(root: str, split: str):
    path = os.path.join(root, f"scannet_{split}.pickle")
    with open(path, "rb") as fp:
        scene_points_list = pickle.load(fp, encoding="latin1")
        semantic_labels_list = pickle.load(fp, encoding="latin1")
    return scene_points_list, semantic_labels_list


class _ScannetBase:
    def __init__(self, root: str | None = None, npoints: int = 8192,
                 split: str = "train", scenes=None, batch_size: int = 16,
                 seed: int = 0, process_shard: tuple[int, int] | None = None,
                 num_workers: int = 0):
        if scenes is not None:
            pts = [p for p, _ in scenes]
            lbl = [l for _, l in scenes]
        else:
            pts, lbl = _load_scenes(root, split)
        # scenes are stored sorted by x (stable), so a crop's x slab is a
        # contiguous slice found by binary search; no sampler gives point
        # order a meaning (each resamples), but the wdp input dropout's
        # "point 0" is the scene's leftmost point
        self.scene_points_list = []
        self.semantic_labels_list = []
        for p, l in zip(pts, lbl):
            p = np.asarray(p, np.float32)
            l = np.asarray(l, np.int32)
            order = np.argsort(p[:, 0], kind="stable")
            self.scene_points_list.append(np.ascontiguousarray(p[order]))
            self.semantic_labels_list.append(np.ascontiguousarray(l[order]))
        self.npoints = npoints
        self.split = split
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self._meta_cache: dict[int, tuple] = {}
        if split == "train":
            self.labelweights = compute_label_weights(
                self.semantic_labels_list)
        else:
            self.labelweights = np.ones(NUM_CLASSES, np.float32)
        # the class weights are the whole train set's; then each process
        # keeps its shard of the scenes (JAX scannet.py:87-92)
        sl = host_slice(len(self.scene_points_list), process_shard)
        self.scene_points_list = self.scene_points_list[sl]
        self.semantic_labels_list = self.semantic_labels_list[sl]

    def __len__(self):
        return len(self.scene_points_list)

    def num_batches(self) -> int:
        return -(-len(self) // self.batch_size)

    def zero_batch(self) -> dict:
        """All-padding sem-seg batch (nvalid=0) from shape metadata."""
        B, N = self.batch_size, self.npoints
        return {"points": np.zeros((B, N, 3), np.float32),
                "seg": np.zeros((B, N), np.int32),
                "smpw": np.zeros((B, N), np.float32), "nvalid": 0}

    def scene_meta(self, index: int):
        """Cached (coordmin, coordmax) bounds of a stored scene."""
        meta = self._meta_cache.get(index)
        if meta is None:
            pts = self.scene_points_list[index]
            meta = (pts.min(axis=0), pts.max(axis=0))
            self._meta_cache[index] = meta
        return meta


def _batched_items(items, batch_size: int, rng,
                   input_dropout: bool = False) -> Iterator[dict]:
    """Stack (points, seg, smpw) items into fixed-shape sem_seg batches.
    `input_dropout` applies the reference's get_batch_wdp density
    augmentation (scannet/train.py:181-197): per cloud, a random <= 87.5%
    of points are replaced by point 0 with their weight zeroed."""
    buf = []

    def emit(buf):
        pts = np.stack([it[0] for it in buf])
        seg = np.stack([it[1] for it in buf])
        smpw = np.stack([it[2] for it in buf])
        if input_dropout:
            B, N = seg.shape
            ratios = rng.random((B, 1)) * 0.875
            drop = rng.random((B, N)) <= ratios
            first_pt = np.repeat(pts[:, 0:1, :], N, axis=1)
            first_lb = np.repeat(seg[:, 0:1], N, axis=1)
            pts[drop] = first_pt[drop]
            seg[drop] = first_lb[drop]
            smpw[drop] = 0.0
        (pts, seg, smpw), nvalid = _pad_batch([pts, seg, smpw], batch_size)
        return {"points": pts.astype(np.float32),
                "seg": seg.astype(np.int32),
                "smpw": smpw.astype(np.float32), "nvalid": nvalid}

    for item in items:
        buf.append(item)
        if len(buf) == batch_size:
            yield emit(buf)
            buf = []
    if buf:
        yield emit(buf)


class ScannetDataset(_ScannetBase):
    """Random-crop training sampler with occupancy/annotation acceptance.

    Candidate crops are 1.5 x 1.5 m x full-height columns around random
    scene points; a crop is accepted when >= 70% of its (0.2 m-expanded)
    member points are annotated and >= 2% of the 31x31x62 voxel grid over
    its strict (0.01 m) interior is occupied; up to 10 candidates are
    tried, the last non-empty one is used regardless. If every candidate
    is empty the whole scene is the crop. :meth:`_score_one` scores one
    candidate on the x-sorted storage (a binary-searched slab, then one y
    test), operation for operation the formulas of the reference's (K, N)
    matrix form (``pointnet2_tpu/data/scannet.py``, ``score_candidates``),
    which the tests hold it to bit for bit."""

    _HALF = np.array([0.75, 0.75, 1.5], np.float32)
    _GRID = np.array([31.0, 31.0, 62.0])

    def _score_one(self, pts, seg, center, meta):
        """Score one candidate column on the stored (x-sorted) arrays: the
        slab is the slice [l:r). Returns (member point ids, strict mask over
        members, annotated fraction, voxel occupancy), bit for bit those
        of the reference's matrix form."""
        coordmin, coordmax = meta
        lo = center - self._HALF
        hi = center + self._HALF
        lo[2], hi[2] = coordmin[2], coordmax[2]

        l = np.searchsorted(pts[:, 0], lo[0] - 0.2, "left")
        r = np.searchsorted(pts[:, 0], hi[0] + 0.2, "right")
        y = pts[l:r, 1]
        m = (y >= lo[1] - 0.2) & (y <= hi[1] + 0.2)
        member = l + np.flatnonzero(m)
        if len(member) == 0:
            return member, member.astype(bool), 0.0, 0.0
        nm = len(member)
        annotated = np.count_nonzero(m & (seg[l:r] > 0)) / nm

        px, py = pts[l:r, 0][m], y[m]
        strict = ((px >= lo[0] - 0.01) & (px <= hi[0] + 0.01)
                  & (py >= lo[1] - 0.01) & (py <= hi[1] + 0.01))
        v = np.ceil((pts[member[strict]] - lo) / (hi - lo) * self._GRID)
        keys = ((v[:, 0] * self._GRID[1] + v[:, 1]) * self._GRID[2]
                + v[:, 2]).astype(np.int64)
        nvox = float(self._GRID.prod())
        # occupied voxels by a bincount over the small key range (a key can
        # sit one cell outside the grid, from the 0.01 m strict margin)
        occupancy = np.count_nonzero(
            np.bincount(keys - keys.min() if keys.size else keys,
                        minlength=1)) / nvox
        return member, strict, annotated, occupancy

    def get_item(self, index: int, num_candidates: int = 10, rng=None):
        """(points (npoints, 3), seg (npoints,), weights (npoints,)) of
        one accepted crop of scene `index`."""
        pts = self.scene_points_list[index]
        seg = self.semantic_labels_list[index]
        meta = self.scene_meta(index)
        rng = self._rng if rng is None else rng

        centers = pts[rng.integers(len(pts), size=num_candidates)]
        chosen = last_nonempty = None
        for k in range(num_candidates):  # stop at the first acceptance
            member, strict, annotated, occupancy = self._score_one(
                pts, seg, centers[k].copy(), meta)
            if len(member) == 0:
                continue
            last_nonempty = (member, strict)
            if annotated >= 0.7 and occupancy >= 0.02:
                chosen = last_nonempty
                break
        if chosen is None:
            chosen = last_nonempty
        if chosen is None:  # no candidate saw any point
            member = np.arange(len(pts))
            strict = np.ones(len(pts), bool)
        else:
            member, strict = chosen
        sel_local = rng.integers(len(member), size=self.npoints)
        sel = member[sel_local]
        weight = self.labelweights[seg[sel]] * strict[sel_local]
        return pts[sel], seg[sel], weight.astype(np.float32)

    def epoch(self, augment: bool = False,
              input_dropout: bool = True) -> Iterator[dict]:
        """Fixed-shape batches of one crop a scene, in a fresh order;
        `input_dropout` applies the reference's get_batch_wdp density
        augmentation on the train split (scannet/train.py:181-197)."""
        order = self._rng.permutation(len(self))
        wdp = input_dropout and self.split == "train"
        if self.num_workers > 1:
            # per-item generators drawn up front keep the stream the same
            # for a seed whatever the threads' timing
            seeds = self._rng.integers(0, 2 ** 63, size=len(order))
            items = parallel_map(
                lambda t: self.get_item(
                    int(t[0]), rng=np.random.default_rng(int(t[1]))),
                list(zip(order, seeds)), self.num_workers)
        else:
            items = (self.get_item(i) for i in order)
        yield from _batched_items(items, self.batch_size, self._rng,
                                  input_dropout=wdp)


class ScannetDatasetWholeScene(_ScannetBase):
    """Tile each scene into 1.5 m x/y columns; one ``npoints`` sample a
    non-empty block. ``get_item`` returns (nblocks, npoints, ...) arrays.

    Protocol (scannet/scannet_dataset.py:83-118): a block's members lie in
    its x/y bounds grown by 0.2 m (full z range); ``npoints`` are
    resampled with replacement a block; the block is kept when >= 1% of the
    sample lies in the strict (0.001 m) interior, which also masks the
    weights. Points are binned to their (at most 4) blocks by
    :func:`block_members`, and the resample of all blocks is one batched
    draw, as in JAX."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._tiling_cache: dict[int, tuple] = {}

    def _scene_tiling(self, index: int):
        """The scene's static binning (member ids sorted by block and the
        block table), cached: every eval pass tiles the same scenes."""
        cached = self._tiling_cache.get(index)
        if cached is not None:
            return cached
        pts = self.scene_points_list[index]
        coordmin, coordmax = pts.min(axis=0), pts.max(axis=0)
        # `or 1`: a zero-extent axis still owns one block, as in
        # Predictor.predict_scene's tiling of the same geometry
        nx = int(np.ceil((coordmax[0] - coordmin[0]) / BLOCK)) or 1
        ny = int(np.ceil((coordmax[1] - coordmin[1]) / BLOCK)) or 1
        pairs = block_members(pts, coordmin, nx, ny)
        block_ids, starts = np.unique(pairs[:, 0], return_index=True)
        counts = np.append(starts[1:], len(pairs)) - starts
        tiling = (pairs[:, 1].astype(np.int32), block_ids, starts, counts,
                  ny, coordmin, coordmax)
        if len(self._tiling_cache) >= 256:  # bound host memory
            self._tiling_cache.pop(next(iter(self._tiling_cache)))
        self._tiling_cache[index] = tiling
        return tiling

    def get_item(self, index: int):
        """(points (nblocks, npoints, 3), seg (nblocks, npoints), weights
        (nblocks, npoints)) of the kept blocks of scene `index`."""
        pts = self.scene_points_list[index]
        seg = self.semantic_labels_list[index]
        member, block_ids, starts, counts, ny, coordmin, coordmax = \
            self._scene_tiling(index)
        nb = len(block_ids)
        # one resample with replacement for all blocks: uniform offsets
        # into each block's slice [start, start + count) of the members
        u = self._rng.random((nb, self.npoints))
        offs = (u * counts[:, None]).astype(np.int64)
        sel = member[starts[:, None] + offs]  # (nb, npoints)
        ps = pts[sel]
        sg = seg[sel]
        curmin = coordmin + np.stack(
            [(block_ids // ny) * BLOCK, (block_ids % ny) * BLOCK,
             np.zeros(nb)], 1)
        curmax = np.stack(
            [curmin[:, 0] + BLOCK, curmin[:, 1] + BLOCK,
             np.full(nb, coordmax[2])], 1)
        msk = ((ps >= curmin[:, None] - 0.001)
               & (ps <= curmax[:, None] + 0.001)).all(-1)
        keep = msk.mean(1) >= 0.01
        w = (self.labelweights[sg] * msk).astype(np.float32)
        return ps[keep], sg[keep], w[keep]

    def blocks(self) -> Iterator[tuple]:
        """Every block of every scene, flattened, for batched whole-scene
        evaluation (blocks are independent in eval mode)."""
        for i in range(len(self)):
            ps, seg, w = self.get_item(i)
            for b in range(ps.shape[0]):
                yield ps[b], seg[b], w[b]


class ScannetDatasetVirtualScan(_ScannetBase):
    """Eight virtual camera scans a scene (scannet/scannet_dataset.py:
    122-165 and scene_util.py): each scene gives up to 8 views, the points
    visible from a camera at one of 8 horizontal orientations, each
    resampled to ``npoints``; a view that sees fewer than 300 points is
    dropped. A scene's ray casts run once and are cached, so epochs after
    the first pay only the resampling."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._scan_cache: dict[int, list[np.ndarray]] = {}

    def view_indices(self, index: int) -> list[np.ndarray]:
        """The visible point ids of the >= 300-point views of a scene."""
        if index not in self._scan_cache:
            views = []
            for mode in range(8):
                smpidx = virtual_scan(self.scene_points_list[index],
                                      mode=mode)
                if len(smpidx) >= 300:
                    views.append(smpidx)
            self._scan_cache[index] = views
        return self._scan_cache[index]

    def _sample_view(self, index: int, smpidx: np.ndarray):
        idx = smpidx[self._rng.integers(len(smpidx), size=self.npoints)]
        seg = self.semantic_labels_list[index][idx]
        return (self.scene_points_list[index][idx], seg,
                self.labelweights[seg].astype(np.float32))

    def get_item(self, index: int):
        """(points (nviews, npoints, 3), seg (nviews, npoints), weights
        (nviews, npoints)) of the kept views of scene `index`."""
        views = [self._sample_view(index, s)
                 for s in self.view_indices(index)]
        return (np.stack([v[0] for v in views]),
                np.stack([v[1] for v in views]),
                np.stack([v[2] for v in views]))

    def _all_views(self) -> list[tuple[int, int]]:
        return [(i, v) for i in range(len(self))
                for v in range(len(self.view_indices(i)))]

    def num_batches(self) -> int:
        return -(-len(self._all_views()) // self.batch_size)

    def epoch(self, augment: bool = False,
              input_dropout: bool = True) -> Iterator[dict]:
        """Fixed-shape batches over the flattened (scene, view) pairs in a
        fresh order, in the crop sampler's format, with the reference's
        input dropout on the train split."""
        pairs = self._all_views()
        order = self._rng.permutation(len(pairs))
        wdp = input_dropout and self.split == "train"
        items = (self._sample_view(pairs[k][0],
                                   self.view_indices(pairs[k][0])[pairs[k][1]])
                 for k in order)
        yield from _batched_items(items, self.batch_size, self._rng,
                                  input_dropout=wdp)


def make_synthetic_scenes(num_scenes: int = 4, points_per_scene: int = 20000,
                          extent: float = 4.5, seed: int = 0):
    """Synthetic rooms with spatially coherent labels (nearest of 20
    anchors, 1-20, and about 10% unannotated, 0), for hermetic runs."""
    gen = np.random.default_rng(seed)
    scenes = []
    for _ in range(num_scenes):
        pts = gen.uniform(0, extent, (points_per_scene, 3)).astype(np.float32)
        pts[:, 2] *= 3.0 / extent  # room height ~3 m
        anchors = gen.uniform(0, extent, (NUM_CLASSES - 1, 3))
        anchors[:, 2] *= 3.0 / extent
        d = np.linalg.norm(pts[:, None, :] - anchors[None], axis=-1)
        labels = (np.argmin(d, axis=-1) + 1).astype(np.int32)
        unannotated = gen.random(points_per_scene) < 0.1
        labels[unannotated] = 0
        scenes.append((pts, labels))
    return scenes
