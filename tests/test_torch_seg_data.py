"""The port's segmentation data held against the JAX package on the CPU.

The synthetic data sets, the ScanNet crop sampler (with and without the
wdp input dropout, over two epochs), its class weights, the generated
rooms and the ShapeNet-part reader (on a directory this test writes) give
the JAX package's arrays bit for bit for the same seed. The on-device
augmentations of segmentation training (rotation about z, random input
dropout and the two chains) agree with JAX's transforms on the same
parameters, which are drawn on the JAX side and injected.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.data import augment_jax
from pointnet2_tpu.data import scannet as jscannet
from pointnet2_tpu.data import shapenet_part as jpart
from pointnet2_tpu.data.synthetic import (
    SyntheticSegmentation as JaxSyntheticSegmentation,
)
from pointnet2_tpu_torch import data as tdata
from pointnet2_tpu_torch.data import augment_device as aug
from pointnet2_tpu_torch.data import scannet as tscannet
from pointnet2_tpu_torch.data import shapenet_part as tpart
from pointnet2_tpu_torch.train.steps import AUGMENTATIONS

# f32 rotations: matmul summation order and FMA differ between XLA and
# PyTorch (last-ulp on unit-scale coordinates), as tests/test_torch_train.py
AUG_TOL = 1e-6


def _same_batches(ours, theirs, n_batches=None):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    if n_batches is not None:
        assert len(ours) == n_batches
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        assert a["nvalid"] == b["nvalid"]
        for k in a:
            if k != "nvalid":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return ours


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [3, 6])
def test_synthetic_segmentation_equals_jax(channels):
    kw = dict(num_classes=5, num_samples=7, npoints=24, channels=channels,
              batch_size=3, seed=4)
    ours, theirs = (tdata.SyntheticSegmentation(**kw),
                    JaxSyntheticSegmentation(**kw))
    for k in ("data", "seg", "smpw"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k))
    for _ in range(2):  # the order's generator advances alike
        got = _same_batches(ours.epoch(), theirs.epoch(), 3)
    assert got[-1]["nvalid"] == 1
    assert got[0]["points"].shape == (3, 24, channels)
    zb, jzb = ours.zero_batch(), theirs.zero_batch()
    for k in zb:
        np.testing.assert_array_equal(zb[k], jzb[k])
    with pytest.raises(ValueError, match="channels"):
        tdata.SyntheticSegmentation(channels=4)


@pytest.mark.parametrize("categories", [None, ["Chair", "Mug", "Lamp"]])
def test_synthetic_shapenet_part_equals_jax(categories):
    kw = dict(num_samples=10, npoints=32, batch_size=4, seed=2,
              categories=categories)
    ours, theirs = (tpart.SyntheticShapeNetPart(**kw),
                    jpart.SyntheticShapeNetPart(**kw))
    for k in ("data", "seg", "cls"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k))
    for _ in range(2):
        _same_batches(ours.epoch(), theirs.epoch(), 3)
    for k, v in ours.zero_batch().items():
        np.testing.assert_array_equal(v, theirs.zero_batch()[k])


def test_shapenet_part_label_maps_equal_jax():
    assert tpart.SEG_CLASSES == jpart.SEG_CLASSES
    assert tpart.SEG_LABEL_TO_CAT == jpart.SEG_LABEL_TO_CAT
    assert tpart.CATEGORY_ORDER == jpart.CATEGORY_ORDER
    assert (tpart.NUM_PARTS, tpart.NUM_CATEGORIES) == (
        jpart.NUM_PARTS, jpart.NUM_CATEGORIES) == (50, 16)
    parts = sorted(p for ps in tpart.SEG_CLASSES.values() for p in ps)
    assert parts == list(range(50))


# ---------------------------------------------------------------------------
# ShapeNet-part reader on a fixture directory
# ---------------------------------------------------------------------------


def _write_shapenet(root, rng):
    """Three categories of a few shapes each, split into train/val/test
    json lists as the benchmark's are; shapes of 30-60 rows."""
    cats = {"Airplane": "02691156", "Mug": "03797390", "Chair": "03001627"}
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{c}\t{s}\n" for c, s in cats.items()))
    splits = {"train": [], "val": [], "test": []}
    for cat, synset in cats.items():
        (root / synset).mkdir()
        for i in range(5):
            sid = f"{synset}{i:04d}"
            n = int(rng.integers(30, 60))
            xyz = rng.normal(size=(n, 3)) * 2 + 1
            nrm = rng.normal(size=(n, 3))
            seg = rng.choice(tpart.SEG_CLASSES[cat], n)
            np.savetxt(root / synset / f"{sid}.txt",
                       np.column_stack([xyz, nrm, seg]), fmt="%.6f")
            split = ("train", "train", "val", "test", "train")[i]
            splits[split].append(f"shape_data/{synset}/{sid}")
    (root / "train_test_split").mkdir()
    for name, ids in splits.items():
        (root / "train_test_split" / f"shuffled_{name}_file_list.json"
         ).write_text(json.dumps(ids))


@pytest.mark.parametrize("split", ["train", "trainval", "test"])
def test_part_normal_dataset_equals_jax(tmp_path, split):
    _write_shapenet(tmp_path, np.random.default_rng(0))
    kw = dict(npoints=40, split=split, batch_size=4, seed=6)
    ours, theirs = (tpart.PartNormalDataset(str(tmp_path), **kw),
                    jpart.PartNormalDataset(str(tmp_path), **kw))
    assert ours.datapath == theirs.datapath
    assert ours.classes == theirs.classes
    assert len(ours) == {"train": 9, "trainval": 12, "test": 3}[split]
    assert ours.shuffle == (split != "test")
    for _ in range(2):  # the resampling generator advances alike
        got = _same_batches(ours.epoch(), theirs.epoch())
    pts = got[0]["points"][:got[0]["nvalid"], :, :3]
    assert np.linalg.norm(pts, axis=-1).max() <= 1.0 + 1e-6  # unit sphere
    # process_shard: each process's contiguous share of the shapes, and its
    # batches, as JAX's (the remainder to the last; a share may be empty)
    shares = []
    for shard in ((0, 2), (1, 2), (0, 4), (3, 4)):
        ours, theirs = (
            tpart.PartNormalDataset(str(tmp_path), process_shard=shard, **kw),
            jpart.PartNormalDataset(str(tmp_path), process_shard=shard,
                                    **kw))
        assert ours.datapath == theirs.datapath
        if ours.datapath:
            _same_batches(ours.epoch(), theirs.epoch())
        shares.append(ours.datapath)
    whole = tpart.PartNormalDataset(str(tmp_path), **kw).datapath
    assert shares[0] + shares[1] == whole


# ---------------------------------------------------------------------------
# ScanNet crops
# ---------------------------------------------------------------------------


def test_synthetic_scenes_and_label_weights_equal_jax():
    ours = tscannet.make_synthetic_scenes(3, 500, seed=5)
    theirs = jscannet.make_synthetic_scenes(3, 500, seed=5)
    for (p, l), (jp, jl) in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(l, jl)
    labels = [l for _, l in ours]
    w = tscannet.compute_label_weights(labels)
    assert w.dtype == np.float32 and w.shape == (tscannet.NUM_CLASSES,)
    np.testing.assert_array_equal(w, jscannet.compute_label_weights(labels))
    assert tscannet.NUM_CLASSES == jscannet.NUM_CLASSES == 21


@pytest.fixture(scope="module")
def scenes():
    """Four generated rooms of 3000 points, one of them a thin strip (most
    candidate columns hold too few points to be accepted)."""
    out = tscannet.make_synthetic_scenes(4, 3000, seed=3)
    strip = out[3][0].copy()
    strip[:, 1] *= 0.05
    out[3] = (strip, out[3][1])
    return out


@pytest.mark.parametrize("input_dropout", [True, False])
def test_scannet_epochs_equal_jax(scenes, input_dropout):
    """Two epochs of crops (B=3 over 4 scenes: a padded final batch), with
    and without the wdp input dropout, and the eval split (no dropout,
    unit weights)."""
    for split in ("train", "test"):
        kw = dict(npoints=64, split=split, scenes=scenes, batch_size=3,
                  seed=8)
        ours, theirs = (tscannet.ScannetDataset(**kw),
                        jscannet.ScannetDataset(**kw))
        np.testing.assert_array_equal(ours.labelweights, theirs.labelweights)
        for a, b in zip(ours.scene_points_list, theirs.scene_points_list,
                        strict=True):
            np.testing.assert_array_equal(a, b)
        for _ in range(2):
            got = _same_batches(ours.epoch(input_dropout=input_dropout),
                                theirs.epoch(input_dropout=input_dropout), 2)
        assert got[-1]["nvalid"] == 1
        zeroed = float((got[0]["smpw"] == 0).mean())
        if split == "train" and input_dropout:
            assert zeroed > 0.05  # wdp zeroes dropped points' weights
        if split == "test":
            assert set(np.unique(got[0]["smpw"])) <= {0.0, 1.0}


def test_scannet_score_one_equals_score_candidates(scenes):
    """The port's single-candidate scorer gives the members, strict mask,
    annotated fraction and occupancy of JAX's (K, N) matrix form
    (``score_candidates``), bit for bit, an empty candidate included."""
    ds = tscannet.ScannetDataset(npoints=64, scenes=scenes, batch_size=2)
    rng = np.random.default_rng(1)
    for i in range(len(ds)):
        pts = ds.scene_points_list[i]
        seg = ds.semantic_labels_list[i]
        centers = pts[rng.integers(len(pts), size=6)]
        centers = np.concatenate([centers, [[-50.0, -50.0, 0.0]]])  # empty
        centers = centers.astype(np.float32)
        exp, strict, ann, occ = jscannet.ScannetDataset.score_candidates(
            pts, seg, centers.copy())
        for k, c in enumerate(centers):
            member, smask, a1, o1 = ds._score_one(pts, seg, c.copy(),
                                                 ds.scene_meta(i))
            np.testing.assert_array_equal(member, np.flatnonzero(exp[k]))
            np.testing.assert_array_equal(smask, strict[k][member])
            assert a1 == ann[k] and o1 == occ[k]
        assert not exp[-1].any()


def test_scannet_refuses_what_is_not_ported(scenes):
    # the thread pool is ported (tests/test_torch_eval_protocols.py holds
    # its stream to JAX's); so is multi-host sharding: each process keeps
    # its contiguous share of the scenes, the class weights the whole
    # train set's, and its crops and whole-scene blocks are JAX's
    assert tscannet.ScannetDataset(scenes=scenes, num_workers=2).num_workers \
        == 2
    for shard in ((0, 3), (2, 3)):
        kw = dict(scenes=scenes, npoints=32, batch_size=2, seed=8,
                  process_shard=shard)
        ours, theirs = (tscannet.ScannetDataset(**kw),
                        jscannet.ScannetDataset(**kw))
        assert len(ours) == len(theirs) == (1 if shard[0] < 2 else 2)
        np.testing.assert_array_equal(ours.labelweights, theirs.labelweights)
        for a, b in zip(ours.scene_points_list, theirs.scene_points_list,
                        strict=True):
            np.testing.assert_array_equal(a, b)
        _same_batches(ours.epoch(), theirs.epoch())
        kw["split"] = "test"
        for a, b in zip(tscannet.ScannetDatasetWholeScene(**kw).blocks(),
                        jscannet.ScannetDatasetWholeScene(**kw).blocks(),
                        strict=True):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x, y)
    zb = tscannet.ScannetDataset(scenes=scenes, npoints=16,
                                 batch_size=2).zero_batch()
    assert zb["points"].shape == (2, 16, 3) and zb["nvalid"] == 0


# ---------------------------------------------------------------------------
# on-device augmentation on the same parameters
# ---------------------------------------------------------------------------


def _points(seed, B=3, N=40, C=3):
    return np.random.default_rng(seed).normal(size=(B, N, C)).astype(
        np.float32)


@pytest.mark.parametrize("C", [3, 6])
def test_rotate_z_and_dropout_match_jax(C):
    x = _points(0, C=C)
    B, N = x.shape[:2]
    key = jax.random.PRNGKey(5)
    angles = jax.random.uniform(key, (B,), maxval=2 * jnp.pi)
    want = np.asarray(augment_jax.rotate_z(key, jnp.asarray(x)))
    got = aug.rotate_z(torch.from_numpy(x), torch.from_numpy(np.array(angles)))
    np.testing.assert_allclose(got.numpy(), want, rtol=AUG_TOL, atol=AUG_TOL)
    # a rotation about z keeps z and the norms
    np.testing.assert_array_equal(got[..., 2].numpy(), x[..., 2])

    k1, k2 = jax.random.split(key)
    ratios = jax.random.uniform(k1, (B, 1)) * 0.875
    drop = np.array(jax.random.uniform(k2, (B, N)) <= ratios)
    assert 0 < drop.sum() < drop.size
    want = np.asarray(augment_jax.random_point_dropout(key, jnp.asarray(x)))
    got = aug.random_point_dropout(torch.from_numpy(x),
                                   torch.from_numpy(drop))
    np.testing.assert_array_equal(got.numpy(), want)  # a copy, exact


def test_augment_cls_normals_chain_matches_jax():
    """The whole chain, parameters drawn as augment_jax.augment_cls_normals
    draws them (seven split keys, in order; the dropout's key split in
    two), on clouds with normals."""
    x = _points(1, B=4, N=48, C=6)
    B, N = x.shape[:2]
    key = jax.random.PRNGKey(13)
    ks = jax.random.split(key, 7)
    d1, d2 = jax.random.split(ks[6])
    params = [
        jax.random.uniform(ks[0], (B,), maxval=2 * jnp.pi),
        jnp.clip(0.06 * jax.random.normal(ks[1], (B, 3)), -0.18, 0.18),
        jax.random.uniform(ks[2], (B, 1, 1), minval=0.8, maxval=1.25),
        jax.random.uniform(ks[3], (B, 1, 3), minval=-0.1, maxval=0.1),
        jnp.clip(0.01 * jax.random.normal(ks[4], (B, N, 3)), -0.05, 0.05),
        jax.random.permutation(ks[5], N),
        jax.random.uniform(d2, (B, N)) <= jax.random.uniform(d1, (B, 1))
        * 0.875,
    ]
    want = np.asarray(augment_jax.augment_cls_normals(key, jnp.asarray(x)))
    got = torch.from_numpy(x)
    assert len(aug.CLS_NORMALS_CHAIN) == len(params)
    for (_, apply), p in zip(aug.CLS_NORMALS_CHAIN, params):
        got = apply(got, torch.from_numpy(np.array(p)))
    np.testing.assert_allclose(got.numpy(), want, rtol=AUG_TOL, atol=AUG_TOL)


def test_augment_scannet_matches_jax_and_draws_from_the_generator():
    x = _points(2, B=3, N=32)
    key = jax.random.PRNGKey(21)
    angles = jax.random.uniform(key, (3,), maxval=2 * jnp.pi)
    want = np.asarray(augment_jax.augment_scannet(key, jnp.asarray(x)))
    got = aug.rotate_z(torch.from_numpy(x), torch.from_numpy(np.array(angles)))
    np.testing.assert_allclose(got.numpy(), want, rtol=AUG_TOL, atol=AUG_TOL)
    t = torch.from_numpy(x)
    for fn in (aug.augment_scannet, aug.augment_cls_normals):
        a = fn(torch.Generator().manual_seed(1), t)
        b = fn(torch.Generator().manual_seed(1), t)
        assert torch.equal(a, b) and a.shape == t.shape
    g = torch.Generator().manual_seed(2)
    drop = aug.draw_random_point_dropout(g, t)
    assert drop.dtype == torch.bool and drop.shape == t.shape[:2]
    assert float(drop.float().mean()) <= 0.875
    r = aug.augment_scannet(g, t)
    torch.testing.assert_close(r.norm(dim=-1), t.norm(dim=-1), rtol=1e-5,
                               atol=1e-6)
    assert AUGMENTATIONS["scannet"] is aug.augment_scannet
    assert AUGMENTATIONS["cls_normals"] is aug.augment_cls_normals
