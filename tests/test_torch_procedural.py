"""The port's procedural stand-ins against the JAX package's, bit for bit.

``pointnet2_tpu_torch.data.procedural_{modelnet,shapenet_part,scannet}``
are copies of the JAX package's numpy generators: the same seed draws the
same ``np.random.default_rng`` stream in the same order, so every cloud,
label, file and pickle equals JAX's exactly (``np.array_equal``, and the
text files byte for byte). The sizes are cut (a shape a class, a few
hundred points, rooms of a few thousand points); the generators and the
readers see the full sizes only on the card. Each ``python -m`` entry
point takes JAX's flags with JAX's defaults, and each written layout loads
through the port's reader with the batches JAX's reader gives.
"""

import argparse
import filecmp
import json
import os
import pickle
import sys

import numpy as np
import pytest

from pointnet2_tpu.data import procedural_modelnet as jmn
from pointnet2_tpu.data import procedural_scannet as jsc
from pointnet2_tpu.data import procedural_shapenet_part as jsp
from pointnet2_tpu.data.modelnet import ModelNetDataset as JModelNetDataset
from pointnet2_tpu.data.modelnet import ModelNetH5Dataset as JModelNetH5Dataset
from pointnet2_tpu.data.scannet import ScannetDataset as JScannetDataset
from pointnet2_tpu.data.shapenet_part import (
    PartNormalDataset as JPartNormalDataset,
)
from pointnet2_tpu_torch.data import (
    ModelNetDataset,
    ModelNetH5Dataset,
    PartNormalDataset,
    ScannetDataset,
)
from pointnet2_tpu_torch.data import procedural_modelnet as mn
from pointnet2_tpu_torch.data import procedural_scannet as sc
from pointnet2_tpu_torch.data import procedural_shapenet_part as sp

# rooms cut to a few thousand points (JAX's default: 60-180k)
ROOM = {"min_points": 2000, "max_points": 3000}


def _same_tree(a, b) -> None:
    """Every file of two trees byte for byte (the same names too)."""
    walk_a, walk_b = list(os.walk(a)), list(os.walk(b))
    assert [(os.path.relpath(r, a), sorted(d), sorted(f))
            for r, d, f in walk_a] == [(os.path.relpath(r, b), sorted(d),
                                        sorted(f)) for r, d, f in walk_b]
    for root, _, files in walk_a:
        rel = os.path.relpath(root, a)
        _, mismatch, errors = filecmp.cmpfiles(root, os.path.join(b, rel),
                                               files, shallow=False)
        assert not mismatch and not errors, (rel, mismatch, errors)


def _equal_batches(ours, theirs) -> None:
    a, b = list(ours.epoch()), list(theirs.epoch())
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Both packages' generators at small sizes, each into its own tree."""
    out = {}
    for name, mods in (("port", (mn, sp, sc)), ("jax", (jmn, jsp, jsc))):
        root = tmp_path_factory.mktemp(name)
        m, p, s = mods
        m.generate(str(root / "h5"), 1, 1, npoints=128, seed=3)
        m.generate_txt(str(root / "txt"), 1, 1, npoints=64, seed=4)
        p.generate(str(root / "part"), 1, 1, 1, npoints=128, seed=5)
        s.generate(str(root / "scannet"), train=2, test=1, seed=6, **ROOM)
        out[name] = root
    return out


@pytest.mark.parametrize("with_normals", [False, True])
@pytest.mark.parametrize("cls", range(40))
def test_make_shape_equals_jax(cls, with_normals):
    ours, theirs = np.random.default_rng(cls), np.random.default_rng(cls)
    got = mn.make_shape(cls, ours, 256, with_normals=with_normals)
    want = jmn.make_shape(cls, theirs, 256, with_normals=with_normals)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ours.bit_generator.state == theirs.bit_generator.state
    assert mn.CLASS_NAMES == jmn.CLASS_NAMES


def test_generate_h5_equals_jax(layouts):
    import h5py

    a, b = layouts["port"] / "h5", layouts["jax"] / "h5"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for fn in os.listdir(a):
        if fn.endswith(".txt"):  # the list and name files
            assert filecmp.cmp(a / fn, b / fn, shallow=False), fn
            continue
        with h5py.File(a / fn) as x, h5py.File(b / fn) as y:
            assert x.keys() == y.keys() == {"data", "label"}
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert np.array_equal(x[k][:], y[k][:]), (fn, k)


def test_generate_txt_equals_jax(layouts):
    _same_tree(layouts["port"] / "txt", layouts["jax"] / "txt")


@pytest.mark.parametrize("category", sorted(jsp.CATEGORY_SYNSETS))
def test_make_part_shape_equals_jax(category):
    ours, theirs = np.random.default_rng(7), np.random.default_rng(7)
    got = sp.make_part_shape(category, ours, 256)
    want = jsp.make_part_shape(category, theirs, 256)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ours.bit_generator.state == theirs.bit_generator.state


def test_shapenet_part_generate_equals_jax(layouts):
    """The synset list, each shape's 7-column txt and the three json
    splits, byte for byte."""
    _same_tree(layouts["port"] / "part", layouts["jax"] / "part")
    split = (layouts["port"] / "part" / "train_test_split"
             / "shuffled_test_file_list.json")
    assert len(json.load(open(split))) == 16


def test_make_scene_equals_jax():
    ours, theirs = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        got = sc.make_scene(ours, **ROOM)
        want = jsc.make_scene(theirs, **ROOM)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert sc.LABEL_NAMES == jsc.LABEL_NAMES and sc.FURNITURE == jsc.FURNITURE


def test_scannet_generate_equals_jax(layouts):
    for split, n in (("train", 2), ("test", 1)):
        lists = []
        for name in ("port", "jax"):
            path = layouts[name] / "scannet" / f"scannet_{split}.pickle"
            with open(path, "rb") as fp:
                lists.append((pickle.load(fp), pickle.load(fp)))
        (pa, la), (pb, lb) = lists
        assert len(pa) == len(pb) == len(la) == n
        for x, y in zip(pa + la, pb + lb):
            assert x.dtype == y.dtype and np.array_equal(x, y)


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch) -> list:
    """The flags of a ``main`` that builds its parser inside: parse_args is
    stopped and the parser's actions read as (flags, dest, default, type,
    choices, required)."""
    def stop(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as e:
        main()
    return [(a.option_strings, a.dest, a.default, a.type, a.choices,
             a.required) for a in e.value.args[0]._actions]


@pytest.mark.parametrize("which", ["modelnet", "shapenet_part", "scannet"])
def test_entry_point_parsers_equal_jax(which, monkeypatch):
    ours, theirs = {"modelnet": (mn, jmn), "shapenet_part": (sp, jsp),
                    "scannet": (sc, jsc)}[which]
    assert _parser_of(ours.main, monkeypatch) == \
        _parser_of(theirs.main, monkeypatch)


def test_entry_points_write_what_generate_writes(tmp_path, monkeypatch):
    """Each port ``main`` (``python -m``'s body) writes the files of the
    JAX package's ``generate`` with its flags' values."""
    runs = [
        (mn.main, ["--out", "a", "--train_per_class", "1",
                   "--test_per_class", "1", "--npoints", "32", "--seed", "2"],
         lambda d: jmn.generate(d, 1, 1, 32, 2)),
        (mn.main, ["--out", "a", "--format", "txt", "--train_per_class", "1",
                   "--test_per_class", "1", "--npoints", "16"],
         lambda d: jmn.generate_txt(d, 1, 1, 16, 0)),
        (sp.main, ["--out", "a", "--train_per_class", "1",
                   "--val_per_class", "0", "--test_per_class", "1",
                   "--npoints", "32"],
         lambda d: jsp.generate(d, 1, 0, 1, 32, 0)),
    ]
    for k, (main, argv, reference) in enumerate(runs):
        ours, theirs = str(tmp_path / f"o{k}"), str(tmp_path / f"t{k}")
        monkeypatch.setattr(sys, "argv", ["x", *argv[:1], ours, *argv[2:]])
        main()
        reference(theirs)
        if k == 0:  # HDF5: the list files; the arrays are held above
            assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
            assert filecmp.cmp(os.path.join(ours, "train_files.txt"),
                               os.path.join(theirs, "train_files.txt"))
        else:
            _same_tree(ours, theirs)


def test_layouts_load_through_the_port_readers(layouts):
    """ModelNetH5Dataset, ModelNetDataset, PartNormalDataset and
    ScannetDataset read the generated trees and give JAX's readers'
    batches."""
    a, b = layouts["port"], layouts["jax"]
    h5 = ModelNetH5Dataset(str(a / "h5" / "train_files.txt"), batch_size=8,
                           npoints=64)
    assert len(h5) == 40
    _equal_batches(h5, JModelNetH5Dataset(str(b / "h5" / "train_files.txt"),
                                          batch_size=8, npoints=64))
    txt = ModelNetDataset(str(a / "txt"), batch_size=8, npoints=32,
                          split="test", normal_channel=True)
    assert len(txt) == 40
    _equal_batches(txt, JModelNetDataset(str(b / "txt"), batch_size=8,
                                         npoints=32, split="test",
                                         normal_channel=True))
    part = PartNormalDataset(str(a / "part"), npoints=64, split="trainval",
                             batch_size=8)
    assert len(part) == 32
    _equal_batches(part, JPartNormalDataset(str(b / "part"), npoints=64,
                                            split="trainval", batch_size=8))
    scan = ScannetDataset(root=str(a / "scannet"), npoints=128, batch_size=2,
                          split="train")
    assert len(scan) == 2
    _equal_batches(scan, JScannetDataset(root=str(b / "scannet"),
                                         npoints=128, batch_size=2,
                                         split="train"))
