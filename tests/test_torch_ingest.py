"""The port's parity-day tools against the JAX package's: ``data.ingest``
(the four layout validators, the zip and wrapper-directory sources, the
install by copy or link, ``--check-only``, the ``INVALID:`` exit) and
``data.scannet_preprocessing`` (raw ScanNet export -> per-scene arrays).

The fixtures are the port's procedural generators in the real layouts,
cut small, and miniature raw ScanNet scenes written here in ascii and in
binary PLY. Every validator's stats, and every ``IngestError`` message on
a broken tree, equal JAX's on the same tree. ``collect_one_scene`` equals
JAX's bit for bit: JAX's module reads PLY through ``plyfile``, which is
not installed, so its one reader function is replaced (monkeypatch) by this
file's numpy reader; nothing of the JAX package changes.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from pointnet2_tpu.data import ingest as jing
from pointnet2_tpu.data import scannet_preprocessing as jpre
from pointnet2_tpu_torch.data import ingest as ing
from pointnet2_tpu_torch.data import procedural_modelnet as mn
from pointnet2_tpu_torch.data import procedural_shapenet_part as sp
from pointnet2_tpu_torch.data import scannet_preprocessing as pre
from pointnet2_tpu_torch.data.scannet import make_synthetic_scenes


def _quiet(_msg):
    pass


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The four layouts, generated small."""
    base = tmp_path_factory.mktemp("layouts")
    out = {k: str(base / k) for k in ("h5", "txt", "part", "scannet")}
    mn.generate(out["h5"], train_per_class=1, test_per_class=1, npoints=32,
                seed=0)
    mn.generate_txt(out["txt"], train_per_class=1, test_per_class=1,
                    npoints=16, seed=0)
    sp.generate(out["part"], train_per_class=1, val_per_class=1,
                test_per_class=1, npoints=24, seed=0)
    os.makedirs(out["scannet"])
    for split, n in (("train", 3), ("test", 2)):
        scenes = make_synthetic_scenes(n, points_per_scene=300, seed=1)
        with open(os.path.join(out["scannet"], f"scannet_{split}.pickle"),
                  "wb") as fp:
            pickle.dump([p for p, _ in scenes], fp)
            pickle.dump([lb for _, lb in scenes], fp)
    return out


VALIDATORS = [("validate_modelnet40_h5", "h5", {"train": 40, "test": 40}),
              ("validate_modelnet40_normal", "txt", {"train": 40,
                                                     "test": 40}),
              ("validate_shapenet_part", "part", {"train": 16, "val": 16,
                                                  "test": 16}),
              ("validate_scannet", "scannet", {"train": 3, "test": 2})]


@pytest.mark.parametrize("name,layout,stats", VALIDATORS)
def test_validators_equal_jax(roots, name, layout, stats):
    ours, theirs = [], []
    assert getattr(ing, name)(roots[layout], log=ours.append) == stats
    assert getattr(jing, name)(roots[layout], log=theirs.append) == stats
    assert ours == theirs


def _break(root, layout, how, tmp):
    """A copy of a layout under tmp, broken one way; returns its root."""
    dst = os.path.join(tmp, f"{layout}-{how}")
    shutil.copytree(root, dst)
    if how == "no_list":
        name = {"h5": "train_files.txt", "txt": "modelnet40_train.txt",
                "part": "synsetoffset2category.txt",
                "scannet": "scannet_train.pickle"}[layout]
        os.remove(os.path.join(dst, name))
    elif how == "empty_list":
        name = {"h5": "test_files.txt",
                "txt": "modelnet40_test.txt"}[layout]
        open(os.path.join(dst, name), "w").close()
    elif how == "missing_file":
        if layout == "h5":
            os.remove(os.path.join(dst, "ply_data_train0.h5"))
        elif layout == "txt":
            shutil.rmtree(os.path.join(dst, "airplane"))
        else:  # part: every synset directory gone
            for d in os.listdir(dst):
                if d.isdigit():
                    shutil.rmtree(os.path.join(dst, d))
    elif how == "bad_shape":
        if layout == "h5":
            import h5py

            with h5py.File(os.path.join(dst, "ply_data_test0.h5"), "w") as h5:
                h5.create_dataset("data", data=np.zeros((3, 8, 2), "f4"))
                h5.create_dataset("label", data=np.zeros((3, 1), "u1"))
        elif layout == "txt":
            with open(os.path.join(dst, "modelnet40_shape_names.txt"),
                      "a") as f:
                f.write("extra_class\n")
        elif layout == "part":
            with open(os.path.join(dst, "synsetoffset2category.txt"),
                      "a") as f:
                f.write("Extra\t99999999\n")
        else:  # scannet: one label list short
            with open(os.path.join(dst, "scannet_test.pickle"), "wb") as fp:
                pickle.dump([np.zeros((5, 3), np.float32)] * 2, fp)
                pickle.dump([np.zeros(5, np.int32)], fp)
    return dst


BREAKS = [("h5", "no_list"), ("h5", "empty_list"), ("h5", "missing_file"),
          ("h5", "bad_shape"), ("txt", "no_list"), ("txt", "empty_list"),
          ("txt", "missing_file"), ("txt", "bad_shape"), ("part", "no_list"),
          ("part", "missing_file"), ("part", "bad_shape"),
          ("scannet", "no_list"), ("scannet", "bad_shape")]
_LAYOUT_VALIDATOR = {"h5": "validate_modelnet40_h5",
                     "txt": "validate_modelnet40_normal",
                     "part": "validate_shapenet_part",
                     "scannet": "validate_scannet"}


@pytest.mark.parametrize("layout,how", BREAKS)
def test_broken_layouts_raise_as_jax(roots, tmp_path, layout, how):
    dst = _break(roots[layout], layout, how, str(tmp_path))
    name = _LAYOUT_VALIDATOR[layout]
    with pytest.raises(ing.IngestError) as ours:
        getattr(ing, name)(dst, log=_quiet)
    with pytest.raises(jing.IngestError) as theirs:
        getattr(jing, name)(dst, log=_quiet)
    assert str(ours.value) == str(theirs.value)


def test_h5_validator_names_h5py_when_missing(roots, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        ing.validate_modelnet40_h5(roots["h5"], log=_quiet)


def test_install_copy_refuses_to_clobber(roots, tmp_path):
    dest = tmp_path / "installed" / "modelnet40_ply_hdf5_2048"
    out = ing.ingest("modelnet40_h5", roots["h5"], dest=str(dest),
                     log=_quiet)
    assert out == str(dest) and not os.path.islink(out)
    assert sorted(os.listdir(out)) == sorted(os.listdir(roots["h5"]))
    from pointnet2_tpu_torch.data import ModelNetH5Dataset

    ds = ModelNetH5Dataset(os.path.join(out, "train_files.txt"),
                           batch_size=8, npoints=32)
    assert next(iter(ds.epoch()))["points"].shape == (8, 32, 3)
    with pytest.raises(ing.IngestError, match="destination exists"):
        ing.ingest("modelnet40_h5", roots["h5"], dest=str(dest), log=_quiet)


def test_install_link(roots, tmp_path):
    out = ing.ingest("shapenet_part", roots["part"],
                     dest=str(tmp_path / "ln"), link=True, log=_quiet)
    assert os.path.islink(out)
    assert os.path.realpath(out) == os.path.realpath(roots["part"])


def test_zip_with_wrapper_directory_check_only_and_install(roots, tmp_path):
    zp = shutil.make_archive(str(tmp_path / "scannet_download"), "zip",
                             root_dir=os.path.dirname(roots["scannet"]),
                             base_dir=os.path.basename(roots["scannet"]))
    msgs, jmsgs = [], []
    assert ing.ingest("scannet", zp, check_only=True, log=msgs.append) == zp
    assert jing.ingest("scannet", zp, check_only=True,
                       log=jmsgs.append) == zp
    assert "ok (check only)" in msgs and "  train: 3 scenes" in msgs
    # the extracted root is a temporary directory: compare past its name
    assert msgs[1:] == jmsgs[1:]
    # a zip installs by copy even with --link (its extraction is temporary)
    dest = str(tmp_path / "data" / "scannet_pickles")
    assert ing.ingest("scannet", zp, dest=dest, link=True,
                      log=_quiet) == dest
    assert not os.path.islink(dest)
    assert sorted(os.listdir(dest)) == ["scannet_test.pickle",
                                        "scannet_train.pickle"]


def test_main_exit_codes(roots, tmp_path, capsys):
    dest = str(tmp_path / "mn")
    ing.main(["--dataset", "modelnet40_normal", "--src", roots["txt"],
              "--dest", dest])
    assert os.path.isfile(os.path.join(dest, "modelnet40_train.txt"))
    with pytest.raises(SystemExit) as e:
        ing.main(["--dataset", "scannet", "--src", roots["txt"],
                  "--check-only"])
    assert e.value.code == 1
    assert capsys.readouterr().err.startswith(
        "INVALID: missing scannet_train.pickle")
    with pytest.raises(SystemExit):
        ing.main(["--dataset", "scannet", "--src",
                  str(tmp_path / "nowhere")])
    assert "INVALID: source not found" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# ScanNet preprocessing
# ---------------------------------------------------------------------------


def _numpy_read_xyzrgb(filename):
    """This file's own reader of the scenes written below (xyz float,
    rgb + alpha uchar, ascii or binary_little_endian), for JAX's module."""
    with open(filename, "rb") as f:
        fmt = n = None
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        if fmt == "ascii":
            v = np.loadtxt(f, max_rows=n)
            return np.concatenate([v[:, :3].astype(np.float32),
                                   v[:, 3:6].astype(np.uint8)],
                                  axis=1).astype(np.float32)
        dt = np.dtype([("xyz", "<f4", 3), ("rgba", "u1", 4)])
        v = np.frombuffer(f.read(n * dt.itemsize), dt, n)
        return np.concatenate([v["xyz"], v["rgba"][:, :3]],
                              axis=1).astype(np.float32)


def _raw_scene(root, name, fmt, seed):
    """A miniature raw ScanNet scene: cleaned PLY, over-segmentation and
    aggregation jsons, with raw labels some of which map to no class."""
    rng = np.random.default_rng(seed)
    n, n_seg = 60, 9
    folder = os.path.join(root, name)
    os.makedirs(folder)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nproperty uchar alpha\n"
              "element face 1\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    with open(os.path.join(folder, f"{name}_vh_clean_2.ply"), "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            for p, c in zip(xyz, rgb):
                x, y, z = (repr(float(v)) for v in p)
                f.write(f"{x} {y} {z} {c[0]} {c[1]} {c[2]} 255\n".encode())
            f.write(b"3 0 1 2\n")
        else:
            dt = np.dtype([("xyz", "<f4", 3), ("rgba", "u1", 4)])
            v = np.empty(n, dt)
            v["xyz"] = xyz
            v["rgba"][:, :3] = rgb
            v["rgba"][:, 3] = 255
            f.write(v.tobytes() + b"\x03" + np.arange(3, dtype="<i4")
                    .tobytes())
    seg = rng.integers(0, n_seg, n).tolist()
    with open(os.path.join(folder,
                           f"{name}_vh_clean_2.0.010000.segs.json"),
              "w") as f:
        json.dump({"segIndices": seg}, f)
    labels = ["chair", "office table", "wall", "mystery object", "floor"]
    groups = [{"label": labels[i % len(labels)],
               "segments": [s for s in range(n_seg) if s % 4 == i]}
              for i in range(4)]
    with open(os.path.join(folder, f"{name}.aggregation.json"), "w") as f:
        json.dump({"segGroups": groups}, f)


@pytest.fixture(scope="module")
def raw_scannet(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw_scannet"))
    _raw_scene(root, "scene0000_00", "ascii", 0)
    _raw_scene(root, "scene0001_00", "binary_little_endian", 1)
    tsv = os.path.join(root, "scannet-labels.combined.tsv")
    rows = [("chair", "chair"), ("office table", "table"),
            ("wall", "wall"), ("floor", "floor"), ("lamp", "lamp")]
    with open(tsv, "w") as f:
        f.write("\t".join(f"col{i}" for i in range(8)) + "\n")
        for raw, nyu in rows:
            f.write(f"{raw}\t1\t{raw}\tx\tx\tx\t{nyu}\tx\n")
    return root, tsv, ["scene0000_00", "scene0001_00"]


def test_label_map_equal_jax(raw_scannet):
    _, tsv, _ = raw_scannet
    got = pre.load_raw2scannet_label_map(tsv)
    assert got == jpre.load_raw2scannet_label_map(tsv)
    assert got["lamp"] == "unannotated" and got["office table"] == "table"
    assert pre.CLASS_NAMES == jpre.CLASS_NAMES


@pytest.mark.parametrize("scene", ["scene0000_00", "scene0001_00"])
def test_collect_one_scene_bit_for_bit(raw_scannet, monkeypatch, scene):
    root, tsv, _ = raw_scannet
    monkeypatch.setattr(jpre, "read_ply_xyzrgb", _numpy_read_xyzrgb)
    mapping = pre.load_raw2scannet_label_map(tsv)
    got = pre.collect_one_scene(root, scene, mapping)
    want = jpre.collect_one_scene(root, scene, mapping)
    assert got.dtype == want.dtype == np.float64 and got.shape[1] == 8
    np.testing.assert_array_equal(got, want)


def test_collect_scenes_pickles_and_labels(raw_scannet, monkeypatch,
                                           tmp_path):
    root, tsv, scenes = raw_scannet
    monkeypatch.setattr(jpre, "read_ply_xyzrgb", _numpy_read_xyzrgb)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    log = []
    pre.collect_scenes(root, scenes + ["scene9999_00"], tsv, ours,
                       log_fn=log.append)
    jpre.collect_scenes(root, scenes, tsv, theirs, log_fn=_quiet)
    assert log[:2] == scenes and "scene9999_00 ERROR!!" in log[-1]
    for s in scenes:
        np.testing.assert_array_equal(
            np.load(os.path.join(ours, s + ".npy")),
            np.load(os.path.join(theirs, s + ".npy")))
    pts, lbl = pre.scenes_to_pickle_lists(ours, scenes)
    jpts, jlbl = jpre.scenes_to_pickle_lists(theirs, scenes)
    for a, b in zip(pts + lbl, jpts + jlbl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pre.collect_label_names(root, scenes) == \
        jpre.collect_label_names(root, scenes) == [
            "chair", "mystery object", "office table", "wall"]


def test_export_demo_scene_equal_jax(raw_scannet, monkeypatch, tmp_path):
    root, tsv, scenes = raw_scannet
    monkeypatch.setattr(jpre, "read_ply_xyzrgb", _numpy_read_xyzrgb)
    npy = str(tmp_path / "scene.npy")
    np.save(npy, pre.collect_one_scene(
        root, scenes[1], pre.load_raw2scannet_label_map(tsv)))
    pre.export_demo_scene(npy, str(tmp_path / "ours"))
    jpre.export_demo_scene(npy, str(tmp_path / "theirs"))
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == ["scene.ply", "scene_instance.ply",
                     "scene_semantic.ply"]
    for name in names:
        assert (open(tmp_path / "ours" / name, "rb").read()
                == open(tmp_path / "theirs" / name, "rb").read())
