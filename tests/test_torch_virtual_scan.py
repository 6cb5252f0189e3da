"""The port's virtual scans against the JAX package's, bit for bit.

``utils.scene_util`` (``cart2sph``, ``virtual_scan``) and
``data.ScannetDatasetVirtualScan`` are numpy copies of JAX's: the same
rooms and seeds give the same visible points, views, items and batches
(``np.array_equal``). The rooms come from the procedural ScanNet
generator, cut to a few thousand points.
"""

import numpy as np
import pytest

from pointnet2_tpu.data.procedural_scannet import generate_scenes
from pointnet2_tpu.data.scannet import (
    ScannetDatasetVirtualScan as JScannetDatasetVirtualScan,
)
from pointnet2_tpu.utils import scene_util as jscene
from pointnet2_tpu_torch.data import ScannetDatasetVirtualScan
from pointnet2_tpu_torch.utils import scene_util


@pytest.fixture(scope="module")
def rooms():
    return generate_scenes(3, seed=2, min_points=3000, max_points=5000)


def _pair(rooms, **kw):
    kw = {"scenes": rooms, "npoints": 256, "batch_size": 4, "seed": 5, **kw}
    return ScannetDatasetVirtualScan(**kw), JScannetDatasetVirtualScan(**kw)


def test_cart2sph_equals_jax():
    xyz = np.random.default_rng(0).normal(size=(500, 3))
    xyz[:4] = [[0, 0, 0], [0, 0, 1], [1, 0, 0], [-1, 0, -1]]
    got = scene_util.cart2sph(xyz)
    assert got.dtype == xyz.dtype
    assert np.array_equal(got, jscene.cart2sph(xyz))


@pytest.mark.parametrize("mode", range(-1, 8))
def test_virtual_scan_equals_jax(rooms, mode):
    pts = rooms[0][0]
    ours, theirs = (np.random.default_rng(mode + 1),
                    np.random.default_rng(mode + 1))
    got = scene_util.virtual_scan(pts, mode=mode, rng=ours)
    want = jscene.virtual_scan(pts, mode=mode, rng=theirs)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ours.bit_generator.state == theirs.bit_generator.state
    assert len(got) >= 100  # the scan saw the room


def test_virtual_scan_needs_a_generator_for_a_random_view(rooms):
    with pytest.raises(TypeError, match="rng"):
        scene_util.virtual_scan(rooms[0][0])


def test_views_items_and_epoch_equal_jax(rooms):
    """view_indices of every room, get_item, and one epoch's batches (input
    dropout on the train split) equal JAX's from the same seed."""
    ours, theirs = _pair(rooms)
    for i in range(len(rooms)):
        got, want = ours.view_indices(i), theirs.view_indices(i)
        assert len(got) == len(want) > 0
        assert all(len(v) >= 300 for v in got)
        for x, y in zip(got, want):
            assert np.array_equal(x, y)
    for x, y in zip(ours.get_item(1), theirs.get_item(1)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ours.num_batches() == theirs.num_batches()
    batches = list(ours.epoch())
    assert len(batches) == ours.num_batches()
    for a, b in zip(batches, theirs.epoch(), strict=True):
        assert a.keys() == b.keys() == {"points", "seg", "smpw", "nvalid"}
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert (batches[0]["smpw"] == 0).any()  # the wdp input dropout ran


def test_process_shard_keeps_jax_scenes_and_views(rooms):
    """process_shard=(1, 2): the class weights of all rooms, the last two
    rooms (the remainder goes to the last rank), their views and batches,
    as JAX's."""
    ours, theirs = _pair(rooms, process_shard=(1, 2))
    whole = ScannetDatasetVirtualScan(scenes=rooms, npoints=256)
    assert len(ours) == len(theirs) == 2
    assert np.array_equal(ours.labelweights, whole.labelweights)
    for a, b in zip(ours.scene_points_list, theirs.scene_points_list):
        assert np.array_equal(a, b)
    assert np.array_equal(ours.scene_points_list[0],
                          whole.scene_points_list[1])
    for i in range(2):
        for x, y in zip(ours.view_indices(i), theirs.view_indices(i),
                        strict=True):
            assert np.array_equal(x, y)
    for a, b in zip(ours.epoch(), theirs.epoch(), strict=True):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
