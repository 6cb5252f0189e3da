"""The inputs the benchmark takes from the port's data generators are held
to frozen copies, so that a change there shows here and not as a silent
change of what the cells measure: ``SyntheticClassification`` against a
frozen copy of its generator, the procedural ScanNet room against frozen
readings of two rooms (points, labels, coordinate sums and the draws it
takes), and the serving blocks' columns against the port's own tiling,
``data/scannet.block_members``."""

import numpy as np
import pytest

from pointnet2_tpu_torch.data import SyntheticClassification
from pointnet2_tpu_torch.data.procedural_scannet import make_scene
from pointnet2_tpu_torch.data.scannet import block_members

from portbench.harness import spec


def _frozen_blobs(num_classes, per_class, npoints, seed, blobs=4,
                  noise=0.05):
    """The generator of ``SyntheticClassification`` (three channels) as the
    benchmark measured it."""
    label = np.repeat(np.arange(num_classes), per_class).astype(np.int32)
    centers = np.stack([np.random.default_rng(1000 + c).uniform(
        -1, 1, (blobs, 3)) for c in range(num_classes)])
    gen = np.random.default_rng(seed + 1)
    assign = gen.integers(0, blobs, (len(label), npoints))
    pts = centers[label[:, None], assign] + noise * gen.standard_normal(
        (len(label), npoints, 3))
    return pts.astype(np.float32), label


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_classification_clouds_equal_a_frozen_copy(seed):
    ds = SyntheticClassification(num_classes=5, samples_per_class=6,
                                 npoints=64, channels=3, batch_size=4,
                                 seed=seed)
    pts, label = _frozen_blobs(5, 6, 64, seed)
    assert np.array_equal(ds.data, pts)
    assert np.array_equal(ds.label, label)
    order = np.random.default_rng(seed).permutation(30)
    batches = list(ds.epoch())
    assert len(batches) == 8
    first = batches[0]
    assert np.array_equal(first["points"], pts[order[:4]])
    assert np.array_equal(first["label"], label[order[:4]])


# (seed, points, label counts, coordinate sums, the next draw after it)
_ROOMS = [
    (7, 150266,
     [32006, 35043, 18845, 14819, 0, 0, 0, 0, 0, 14818, 0, 14805, 0, 615,
      1026, 669, 0, 2557, 255, 14808, 0],
     [360373.28, 424805.47, 120865.28], 0.596986495127),
    (2 ** 31 + 99, 60289,
     [8018, 17448, 6847, 0, 12753, 0, 0, 0, 0, 0, 0, 0, 6421, 0, 943, 1304,
      0, 0, 189, 0, 6366],
     [161743.29, 89276.4, 53063.56], 0.742353798594),
]


@pytest.mark.parametrize("seed,n,counts,sums,after", _ROOMS)
def test_rooms_equal_frozen_readings(seed, n, counts, sums, after):
    rng = np.random.default_rng(seed)
    pts, lbl = make_scene(rng, 60000, 180000)
    assert pts.shape == (n, 3) and pts.dtype == np.float32
    assert np.bincount(lbl, minlength=21).tolist() == counts
    assert pts.astype(np.float64).sum(0) == pytest.approx(sums, abs=0.05)
    assert rng.random() == pytest.approx(after, abs=1e-12)


def test_blocks_are_the_columns_predict_scene_cuts():
    bench = spec.load_benchmark()
    cfg = spec.config(bench, "pointnet2_sem_seg-scannet")
    tiling = spec.inputs(cfg["data"]["kind"])
    room, _ = make_scene(np.random.default_rng(5), 60000, 80000)
    lo, hi = room.min(0), room.max(0)
    nx = int(np.ceil((hi[0] - lo[0]) / cfg["block_size_m"])) or 1
    ny = int(np.ceil((hi[1] - lo[1]) / cfg["block_size_m"])) or 1
    pairs = block_members(room, lo, nx, ny)
    want = [set(pairs[pairs[:, 0] == b, 1].tolist())
            for b in np.unique(pairs[:, 0])]
    # one block a column: more points to a block than any column holds
    got = tiling.tile_room(room, cfg["block_size_m"], cfg["block_overlap_m"],
                           len(room), np.random.default_rng(0))
    got = [set(np.flatnonzero(np.isin(room.view("V12").ravel(),
                                      b.view("V12").ravel())).tolist())
           for b in got]
    assert got == want
