"""The port's host-side augmentation and ModelNet txt reader against the
JAX package on the CPU.

The numpy helpers of data/augment.py and both ModelNet chains give JAX's
bits from the same ``np.random.default_rng`` seed, for xyz and xyz+normal
clouds; ``ModelNetDataset`` on a generated resampled-txt tree (two
classes, one with an underscore in its name, a few shapes) yields JAX's
batches, with augmentation off and on, with and without normals, over two
epochs; ``process_shard`` raises. ``ModelNetH5Dataset(augment=True)`` is in
tests/test_torch_train.py.
"""

import numpy as np
import pytest

from pointnet2_tpu.data import augment as JA
from pointnet2_tpu.data.modelnet import ModelNetDataset as JaxModelNet
from pointnet2_tpu_torch.data import ModelNetDataset
from pointnet2_tpu_torch.data import augment as TA

_RNG_FNS = ("shuffle_points", "rotate_point_cloud", "rotate_point_cloud_z",
            "rotate_point_cloud_with_normal",
            "rotate_perturbation_point_cloud",
            "rotate_perturbation_point_cloud_with_normal",
            "shift_point_cloud", "random_scale_point_cloud",
            "random_point_dropout", "jitter_point_cloud",
            "augment_cls_batch", "augment_cls_batch_with_normals")


def _clouds(C: int) -> np.ndarray:
    return np.random.RandomState(C).randn(5, 40, C).astype(np.float32)


@pytest.mark.parametrize("C", [3, 6])
@pytest.mark.parametrize("name", _RNG_FNS)
def test_host_augmentation_equals_jax(name, C):
    """The same seed, as a Generator and as an int: JAX's bits, the input
    untouched, the generators left in the same state."""
    x = _clouds(C)
    before = x.copy()
    got = getattr(TA, name)(x, 11)
    want = getattr(JA, name)(x, 11)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    ours, theirs = np.random.default_rng(11), np.random.default_rng(11)
    np.testing.assert_array_equal(getattr(TA, name)(x, ours),
                                  getattr(JA, name)(x, theirs))
    assert ours.random() == theirs.random()
    np.testing.assert_array_equal(x, before)


def test_fixed_angle_rotations_and_shuffle_data_equal_jax():
    x = _clouds(6)
    for angle in (0.0, np.pi / 6, 2.5):
        np.testing.assert_array_equal(
            TA.rotate_point_cloud_by_angle_with_normal(x, angle),
            JA.rotate_point_cloud_by_angle_with_normal(x, angle))
    labels = np.arange(5)
    got = TA.shuffle_data(x, labels, 3)
    want = JA.shuffle_data(x, labels, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _write_tree(root, n_points: int = 30) -> None:
    """modelnet40_shape_names.txt, the split lists and one CSV a shape:
    classes 'airplane' and 'night_stand', 7 train shapes and 3 test."""
    r = np.random.RandomState(0)
    classes = ["airplane", "night_stand"]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(classes)
                                                      + "\n")
    splits = {"train": [], "test": []}
    for i in range(10):
        cls = classes[i % 2]
        sid = f"{cls}_{i:04d}"
        (root / cls).mkdir(exist_ok=True)
        pts = r.randn(n_points, 6) * [2.0, 1.0, 0.5, 1, 1, 1] + [3, 0, 0,
                                                                  0, 0, 0]
        np.savetxt(root / cls / f"{sid}.txt", pts, delimiter=",",
                   fmt="%.6f")
        splits["train" if i < 7 else "test"].append(sid)
    for split, ids in splits.items():
        (root / f"modelnet40_{split}.txt").write_text("\n".join(ids) + "\n")


@pytest.mark.parametrize("normal_channel", [True, False])
def test_modelnet_txt_batches_equal_jax(tmp_path, normal_channel):
    _write_tree(tmp_path)
    for split in ("train", "test"):
        kw = dict(batch_size=3, npoints=20, split=split, seed=4,
                  normal_channel=normal_channel)
        ours, theirs = ModelNetDataset(str(tmp_path), **kw), \
            JaxModelNet(str(tmp_path), **kw)
        assert len(ours) == len(theirs) == {"train": 7, "test": 3}[split]
        assert ours.num_batches() == theirs.num_batches()
        assert ours.num_channel() == theirs.num_channel() == (
            6 if normal_channel else 3)
        assert ours.classes == theirs.classes
        for augment in (False, True, True):  # the rng advances alike
            got, want = list(ours.epoch(augment)), list(theirs.epoch(augment))
            assert len(got) == len(want) == ours.num_batches()
            for a, b in zip(got, want):
                assert a["nvalid"] == b["nvalid"]
                assert a["points"].dtype == np.float32
                np.testing.assert_array_equal(a["points"], b["points"])
                np.testing.assert_array_equal(a["label"], b["label"])
        for k in ("points", "label", "nvalid"):
            np.testing.assert_array_equal(ours.zero_batch()[k],
                                          theirs.zero_batch()[k])
    first = next(ModelNetDataset(str(tmp_path), npoints=20,
                                 shuffle=False).epoch())["points"][0]
    assert np.isclose(np.sqrt((first[:, :3] ** 2).sum(1)).max(), 1.0)


def test_modelnet_txt_process_shard_raises(tmp_path):
    """process_shard is ported (the name is the test's from before it
    was): each process's contiguous share of the shapes and its batches
    equal JAX's, the shares of 2 processes make up the split, and a share
    of 7 shapes over 8 processes leaves the first seven one each and the
    last none."""
    _write_tree(tmp_path)
    shares = []
    for shard in ((0, 2), (1, 2), (0, 8), (7, 8)):
        kw = dict(batch_size=2, npoints=20, seed=4, process_shard=shard)
        ours, theirs = (ModelNetDataset(str(tmp_path), **kw),
                        JaxModelNet(str(tmp_path), **kw))
        assert ours.datapath == theirs.datapath
        for a, b in zip(ours.epoch(True), theirs.epoch(True), strict=True):
            assert a["nvalid"] == b["nvalid"]
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["label"], b["label"])
        shares.append(len(ours))
    assert shares == [3, 4, 0, 7]
    assert ModelNetDataset(str(tmp_path), process_shard=(0, 2)).datapath + \
        ModelNetDataset(str(tmp_path), process_shard=(1, 2)).datapath == \
        ModelNetDataset(str(tmp_path)).datapath
