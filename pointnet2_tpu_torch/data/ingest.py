"""Dataset ingestion: validate and install the three real datasets.

The port's copy of pointnet2_tpu/data/ingest.py, standard library and
numpy (h5py only for the ModelNet HDF5 layout, imported when that layout
is validated). The reference auto-downloads ModelNet40 on first import
(modelnet_h5_dataset.py:21-26) — impossible here (no egress) and
undesirable (silent network side effect at import time). This CLI is the
explicit replacement: point it at a zip or an extracted directory you
obtained out of band, it validates the layout against what the loaders
expect, and installs (copy or symlink) into the canonical location so the
training/eval command lines in pointnet2_tpu_torch/artifacts/ACCURACY.md
run unchanged.

Datasets and their canonical destinations:
  modelnet40_h5      -> data/modelnet40_ply_hdf5_2048
     (ModelNetH5Dataset; train_files.txt/test_files.txt + ply_data_*.h5,
      reference modelnet_h5_dataset.py:21-33)
  modelnet40_normal  -> data/modelnet40_normal_resampled
     (ModelNetDataset txt layout, reference modelnet_dataset.py:23-40)
  shapenet_part      -> data/shapenetcore_partanno_segmentation_benchmark_v0_normal
     (PartNormalDataset, reference part_seg/part_dataset_all_normal.py:19-43)
  scannet            -> data/scannet_pickles
     (ScannetDataset; scannet_train.pickle + scannet_test.pickle,
      reference scannet/scannet_dataset.py:13-16)

Usage:
  python -m pointnet2_tpu_torch.data.ingest --dataset modelnet40_h5 \
      --src /path/to/modelnet40_ply_hdf5_2048[.zip] [--dest data/...] \
      [--link] [--check-only]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import zipfile


class IngestError(Exception):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise IngestError(msg)


def _listed_files(root: str, list_name: str) -> list[str]:
    path = os.path.join(root, list_name)
    _require(os.path.isfile(path), f"missing {list_name} in {root}")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def validate_modelnet40_h5(root: str, log=print) -> dict:
    """train_files.txt / test_files.txt naming h5 files with
    data (M, N, 3) float and label (M, 1) entries. Needs h5py, imported
    here: a machine without it cannot check this layout (the txt layout,
    ``modelnet40_normal``, needs none)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("validating the ModelNet40 HDF5 layout needs "
                          "h5py, which is not installed; the txt layout "
                          "(--dataset modelnet40_normal) needs none") from e

    stats = {}
    for split in ("train", "test"):
        entries = _listed_files(root, f"{split}_files.txt")
        _require(entries, f"{split}_files.txt is empty")
        n = 0
        for e in entries:
            # the official lists carry 'data/modelnet40_ply_hdf5_2048/x.h5'
            fn = os.path.join(root, os.path.basename(e))
            _require(os.path.isfile(fn), f"listed file missing: {fn}")
            with h5py.File(fn, "r") as h5:
                _require("data" in h5 and "label" in h5,
                         f"{fn}: needs 'data' and 'label' datasets")
                d, l = h5["data"], h5["label"]
                _require(d.ndim == 3 and d.shape[2] == 3,
                         f"{fn}: data shape {d.shape}, want (M, N, 3)")
                _require(l.shape[0] == d.shape[0],
                         f"{fn}: label count {l.shape} != data {d.shape}")
                n += d.shape[0]
        stats[split] = n
        log(f"  {split}: {len(entries)} files, {n} clouds")
    return stats


def validate_modelnet40_normal(root: str, log=print) -> dict:
    """modelnet40_shape_names.txt + modelnet40_{train,test}.txt id lists +
    <class>/<id>.txt CSVs with 6 columns (xyz + normal)."""
    import numpy as np

    names = _listed_files(root, "modelnet40_shape_names.txt")
    _require(len(names) == 40, f"want 40 shape names, got {len(names)}")
    stats = {}
    for split in ("train", "test"):
        ids = _listed_files(root, f"modelnet40_{split}.txt")
        _require(ids, f"modelnet40_{split}.txt is empty")
        probe = os.path.join(root, "_".join(ids[0].split("_")[0:-1]),
                             ids[0] + ".txt")
        _require(os.path.isfile(probe), f"missing shape file {probe}")
        row = np.loadtxt(probe, delimiter=",", max_rows=1)
        _require(row.shape == (6,), f"{probe}: want 6 CSV cols, got "
                                    f"{row.shape}")
        stats[split] = len(ids)
        log(f"  {split}: {len(ids)} shapes")
    return stats


def validate_shapenet_part(root: str, log=print) -> dict:
    """synsetoffset2category.txt + train_test_split jsons + per-synset
    7-column txt files (PartNormalDataset layout)."""
    import json

    import numpy as np

    path = os.path.join(root, "synsetoffset2category.txt")
    _require(os.path.isfile(path), f"missing synsetoffset2category.txt")
    with open(path) as f:
        cat = dict(line.strip().split() for line in f if line.strip())
    _require(len(cat) == 16, f"want 16 categories, got {len(cat)}")
    stats = {}
    for split in ("train", "val", "test"):
        jp = os.path.join(root, "train_test_split",
                          f"shuffled_{split}_file_list.json")
        _require(os.path.isfile(jp), f"missing {jp}")
        with open(jp) as f:
            entries = json.load(f)
        _require(entries, f"{jp} is empty")
        synset, sid = entries[0].split("/")[1:3]
        probe = os.path.join(root, synset, sid + ".txt")
        _require(os.path.isfile(probe), f"missing shape file {probe}")
        row = np.loadtxt(probe, max_rows=1)
        _require(row.shape == (7,), f"{probe}: want 7 cols "
                                    f"(xyz nx ny nz seg), got {row.shape}")
        stats[split] = len(entries)
        log(f"  {split}: {len(entries)} shapes")
    return stats


def validate_scannet(root: str, log=print) -> dict:
    """scannet_train.pickle / scannet_test.pickle, each two pickled lists
    (scene points f32 (N,3); labels (N,))."""
    import pickle

    import numpy as np

    stats = {}
    for split in ("train", "test"):
        path = os.path.join(root, f"scannet_{split}.pickle")
        _require(os.path.isfile(path), f"missing scannet_{split}.pickle")
        with open(path, "rb") as fp:
            pts = pickle.load(fp, encoding="latin1")
            lbl = pickle.load(fp, encoding="latin1")
        _require(len(pts) == len(lbl),
                 f"{path}: {len(pts)} scenes vs {len(lbl)} label lists")
        p0 = np.asarray(pts[0])
        l0 = np.asarray(lbl[0])
        _require(p0.ndim == 2 and p0.shape[1] == 3,
                 f"{path}: scene 0 shape {p0.shape}, want (N, 3)")
        _require(len(l0) == len(p0),
                 f"{path}: scene 0 labels {l0.shape} vs points {p0.shape}")
        stats[split] = len(pts)
        log(f"  {split}: {len(pts)} scenes")
    return stats


DATASETS = {
    "modelnet40_h5": ("data/modelnet40_ply_hdf5_2048",
                      validate_modelnet40_h5),
    "modelnet40_normal": ("data/modelnet40_normal_resampled",
                          validate_modelnet40_normal),
    "shapenet_part": (
        "data/shapenetcore_partanno_segmentation_benchmark_v0_normal",
        validate_shapenet_part),
    "scannet": ("data/scannet_pickles", validate_scannet),
}


def _resolve_src(src: str, tmp: str) -> str:
    """Extract zips; descend into a single-directory wrapper (zips of the
    official datasets wrap everything in one top-level dir)."""
    if os.path.isfile(src) and src.endswith(".zip"):
        with zipfile.ZipFile(src) as z:
            z.extractall(tmp)
        src = tmp
    _require(os.path.isdir(src), f"source not found: {src}")
    entries = [e for e in os.listdir(src) if not e.startswith(".")]
    if len(entries) == 1 and os.path.isdir(os.path.join(src, entries[0])):
        return os.path.join(src, entries[0])
    return src


def ingest(dataset: str, src: str, dest: str | None = None,
           link: bool = False, check_only: bool = False,
           log=print) -> str:
    """Validate `src` as `dataset` and install at `dest`. Returns the
    installed root (or the validated source in check_only mode)."""
    default_dest, validator = DATASETS[dataset]
    dest = dest or default_dest
    with tempfile.TemporaryDirectory() as tmp:
        root = _resolve_src(src, tmp)
        log(f"validating {dataset} at {root}")
        validator(root, log=log)
        if check_only:
            log("ok (check only)")
            # a zip's extracted root is ephemeral — return the source
            return src
        dest = os.path.abspath(dest)
        _require(not os.path.exists(dest),
                 f"destination exists: {dest} (remove it first)")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        if link and root != tmp and not root.startswith(tmp):
            os.symlink(os.path.abspath(root), dest)
            log(f"linked {dest} -> {root}")
        else:
            shutil.copytree(root, dest)
            log(f"copied to {dest}")
    return dest


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    ap.add_argument("--src", required=True,
                    help="extracted directory or .zip")
    ap.add_argument("--dest", default=None,
                    help=f"install location (defaults per dataset)")
    ap.add_argument("--link", action="store_true",
                    help="symlink instead of copying (directory src only)")
    ap.add_argument("--check-only", action="store_true",
                    help="validate without installing")
    args = ap.parse_args(argv)
    try:
        ingest(args.dataset, args.src, args.dest, link=args.link,
               check_only=args.check_only)
    except IngestError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
