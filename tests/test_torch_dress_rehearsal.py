"""The port's parity-day dress rehearsal: ingest -> train -> evaluate.

The port's counterpart of tests/test_dress_rehearsal.py (and of
docs/ACCURACY.md's parity-day checklist, written for the port in
pointnet2_tpu_torch/artifacts/ACCURACY.md). Each case writes a miniature
data set with the port's generators in the real data set's on-disk layout
(ModelNet40 HDF5, ShapeNet-part v0_normal, ScanNet pickles), zips it as
downloaded (one wrapper directory), runs the port's ``data.ingest`` CLI to
validate and install it, then the port's ``cli.train`` and
``cli.evaluate`` against the installed root, on the CPU, and checks the
evaluation record for the metrics JAX's rehearsal asks for.

Sized for tier 1 (one intra-op thread, 128 points a cloud, 1 epoch): the
classifier is the PointNet baseline and the part segmenter the SSG one,
since the PointNet++ models take seconds a step on the CPU's plain point
ops; the ShapeNet-part split lists keep 4 shapes each. On the card,
chip_smoke.py phase 33 rehearses ``pointnet2_cls_ssg``,
``pointnet2_part_seg_msg_one_hot`` and ``pointnet2_sem_seg``.
"""

import json
import os
import shutil

import pytest
import torch

from pointnet2_tpu_torch.cli import evaluate as cli_evaluate
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.data import ingest


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zip_of(src_dir: str, tmp_path, name: str) -> str:
    return shutil.make_archive(str(tmp_path / name), "zip",
                               root_dir=os.path.dirname(src_dir),
                               base_dir=os.path.basename(src_dir))


def _assert_metrics(path: str, *keys):
    with open(path) as f:
        rec = json.load(f)
    m = rec["metrics"]
    for k in keys:
        node = m
        for part in k.split("."):
            assert part in node, f"{k} missing from {path}: {m.keys()}"
            node = node[part]
    return rec


def _rehearse(tmp_path, raw, dataset, dest_name, model, train_flags,
              eval_flags, keys):
    """Zip ``raw``, ingest it, train one epoch, evaluate; returns the
    evaluation record."""
    zip_path = _zip_of(raw, tmp_path, f"{dataset}_download")
    shutil.rmtree(raw)
    dest = str(tmp_path / "data" / dest_name)
    ingest.main(["--dataset", dataset, "--src", zip_path, "--dest", dest])
    log_dir = str(tmp_path / "log")
    common = ["--model", model, "--data", dest, "--batch_size", "8",
              "--log_dir", log_dir, "--device", "cpu"]
    cli_train.main(common + ["--max_epoch", "1", *train_flags])
    assert os.path.isdir(os.path.join(log_dir, "ckpt"))
    out = str(tmp_path / "eval.json")
    cli_evaluate.main(common + ["--out", out, *eval_flags])
    rec = _assert_metrics(out, *keys)
    assert rec["model"] == model and rec["step"] >= 1
    return rec


def test_dress_rehearsal_modelnet40_h5(tmp_path):
    from pointnet2_tpu_torch.data.procedural_modelnet import generate

    raw = str(tmp_path / "modelnet40_ply_hdf5_2048")
    generate(raw, train_per_class=1, test_per_class=1, npoints=256, seed=0)
    rec = _rehearse(tmp_path, raw, "modelnet40_h5",
                    "modelnet40_ply_hdf5_2048", "pointnet_cls_basic",
                    ["--num_point", "128"],
                    ["--num_point", "128", "--num_votes", "2"],
                    ("accuracy", "avg_class_accuracy"))
    assert rec["step"] == 5  # 40 clouds at 8 a batch


def test_dress_rehearsal_shapenet_part(tmp_path):
    from pointnet2_tpu_torch.data.procedural_shapenet_part import generate

    raw = str(tmp_path /
              "shapenetcore_partanno_segmentation_benchmark_v0_normal")
    generate(raw, train_per_class=1, val_per_class=1, test_per_class=1,
             npoints=384, seed=0)
    for split in ("train", "val", "test"):  # 4 shapes a split list
        path = os.path.join(raw, "train_test_split",
                            f"shuffled_{split}_file_list.json")
        with open(path) as f:
            entries = json.load(f)
        with open(path, "w") as f:
            json.dump(entries[:4], f)
    _rehearse(tmp_path, raw, "shapenet_part", "snp_v0_normal",
              "pointnet2_part_seg", ["--num_point", "128"],
              ["--num_point", "128", "--num_votes", "2"],
              ("accuracy", "instance_miou", "category_miou"))


def test_dress_rehearsal_scannet(tmp_path):
    from pointnet2_tpu_torch.data.procedural_scannet import generate

    raw = str(tmp_path / "scannet_data_pointnet2")
    generate(raw, train=2, test=1, seed=0, min_points=3000,
             max_points=4000)
    _rehearse(tmp_path, raw, "scannet", "scannet_pickles",
              "pointnet2_sem_seg", ["--num_point", "512"],
              ["--num_point", "512"],
              ("chopped.point_accuracy",
               "whole_scene.calibrated_accuracy_vox"))
