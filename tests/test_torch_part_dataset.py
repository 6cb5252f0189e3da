"""The port's ``PartDataset`` (the older .pts/.seg ShapeNet-part layout)
against the JAX package's, item for item, on a small generated tree: the
same files, seed and options give the same resampled points, labels and
category ids (``np.array_equal``)."""

import json
import os

import numpy as np
import pytest

from pointnet2_tpu.data.shapenet_part import PartDataset as JPartDataset
from pointnet2_tpu_torch.data import PartDataset

SYNSETS = {"Airplane": "02691156", "Chair": "03001627", "Mug": "03797390"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three categories of four shapes of 40-70 points: .pts xyz rows and
    .seg 1-based local part ids, split train / val / test 2 / 1 / 1."""
    root = tmp_path_factory.mktemp("part_pts")
    gen = np.random.default_rng(0)
    with open(root / "synsetoffset2category.txt", "w") as f:
        f.write("".join(f"{c}\t{s}\n" for c, s in SYNSETS.items()))
    splits = {"train": [], "val": [], "test": []}
    for c, synset in SYNSETS.items():
        for sub in ("points", "points_label"):
            os.makedirs(root / synset / sub)
        for k, split in enumerate(("train", "train", "val", "test")):
            sid = f"{c.lower()}{k}"
            n = int(gen.integers(40, 70))
            np.savetxt(root / synset / "points" / f"{sid}.pts",
                       gen.normal(size=(n, 3)) * 3.0 + 1.0, fmt="%.5f")
            np.savetxt(root / synset / "points_label" / f"{sid}.seg",
                       gen.integers(1, 4, n), fmt="%d")
            splits[split].append(f"shape_data/{synset}/{sid}")
    os.makedirs(root / "train_test_split")
    for split, ids in splits.items():
        with open(root / "train_test_split"
                  / f"shuffled_{split}_file_list.json", "w") as f:
            json.dump(ids, f)
    return str(root)


@pytest.mark.parametrize("split", ["trainval", "test"])
@pytest.mark.parametrize("class_choice", [None, ["Chair", "Mug"]])
@pytest.mark.parametrize("classification", [False, True])
def test_part_dataset_equals_jax(tree, classification, class_choice, split):
    kw = {"npoints": 32, "classification": classification,
          "class_choice": class_choice, "split": split, "seed": 3}
    ours, theirs = PartDataset(tree, **kw), JPartDataset(tree, **kw)
    assert len(ours) == len(theirs) == {"trainval": 3, "test": 1}[split] * (
        3 if class_choice is None else 2)
    assert ours.classes == theirs.classes
    for _ in range(2):  # the second pass reads the cache
        for i in range(len(ours)):
            for x, y in zip(ours[i], theirs[i], strict=True):
                assert np.asarray(x).dtype == np.asarray(y).dtype
                assert np.array_equal(x, y)
    pts = ours[0][0]
    assert pts.shape == (32, 3)
    assert np.linalg.norm(pts, axis=1).max() <= 1.0 + 1e-6  # normalized
