"""The benchmark is driven by data: every name in BENCHMARK.json finds its
files, a new configuration, traffic mix, cell or per-layer metric is
found by name with no edit to a file that is there, and a checkout with
new files alone runs cells whose model, task and data kind the runners
have not run (on the CPU, at a small size, ``correct`` against the
limits of the cells there)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import spec


def test_every_name_finds_its_files():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert hasattr(spec.reference(c["name"]), "forward")
        for key in c["reduced"]:
            assert key in cfg
    for cell in bench["workloads"]:
        mix = spec.traffic(cell["traffic"])
        assert hasattr(spec.runner(mix["kind"]), "run")
        assert spec.limits(cell["name"])
        assert spec.cell_metrics(bench, cell, False)
        assert spec.cell_metrics(bench, cell, True)
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("kind", ["config", "traffic", "cell", "metric"])
def test_new_files_are_found_by_name(tmp_path, kind):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "portbench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench_dir = root / "portbench"
    bench = spec.load_benchmark(root)
    old = bench["workloads"][0]
    if kind == "config":
        src = spec.config(bench, old["config"])
        (bench_dir / "configs" / "new_cfg.json").write_text(json.dumps(src))
        shutil.copy(bench_dir / "configs" / f"{old['config']}.ref.py",
                    bench_dir / "configs" / "new_cfg.ref.py")
        bench["configs"].append({"name": "new_cfg", "source": "x",
                                 "file": "portbench/configs/new_cfg.json",
                                 "reduced": [], "why": "x"})
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        assert spec.config(spec.load_benchmark(root), "new_cfg",
                           root)["model"] == src["model"]
        assert hasattr(spec.reference("new_cfg", bench_dir), "forward")
    elif kind == "traffic":
        mix = spec.traffic(old["traffic"], bench_dir)
        mix["trace_batches"] = 7
        (bench_dir / "traffic" / "new_mix.json").write_text(json.dumps(mix))
        assert spec.traffic("new_mix", bench_dir)["trace_batches"] == 7
    elif kind == "cell":
        cell = dict(old, name="new.cell")
        bench["workloads"].append(cell)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if old["name"] in m.get("workloads", []):
                m["workloads"].append("new.cell")
        (bench_dir / "limits" / "new.cell.json").write_text(
            json.dumps(spec.limits(old["name"], bench_dir)))
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        bench = spec.load_benchmark(root)
        got = spec.workload(bench, "new.cell")
        assert spec.cell_metrics(bench, got, False) == \
            spec.cell_metrics(bench, old, False)
        assert spec.limits("new.cell", bench_dir)
    else:
        (bench_dir / "metrics" / "new_metric.x.py").write_text(
            "def read(run):\n    return 42.0\n")
        assert spec.reader("new_metric.x", bench_dir).read(None) == 42.0


_SEG_REF = '''
"""A segmenter trained on per-point labels: the reference forward, and
the port's weighted per-point cross-entropy, no augmentation."""
import torch

from portbench.harness.counts import forward_flops, fps_shapes
from portbench.reference.model import layout, pointnet2

forward = pointnet2
augment = None


def loss(logits, batch):
    ce = -torch.log_softmax(logits.float(), -1).gather(
        -1, batch["seg"].long()[..., None])[..., 0]
    w = batch["smpw"].float()
    return (ce * w).sum() / (w != 0).sum().clamp_min(1)
'''

_SEG_INPUTS = '''
def train_set(cfg, batch, seed):
    from pointnet2_tpu_torch.data import SyntheticSegmentation

    return SyntheticSegmentation(
        num_classes=cfg["num_classes"], num_samples=cfg["data"]["samples"],
        npoints=cfg["num_point"], channels=cfg["in_channels"],
        batch_size=batch, seed=seed)
'''

_CLS_REF = '''
from portbench.harness.counts import forward_flops, fps_shapes
from portbench.reference.model import layout, pointnet2

forward = pointnet2
'''

_BLOB_INPUTS = '''
import numpy as np


def blocks(cfg, count, npoints, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (count, npoints, 3)).astype(np.float32)
'''

_RUN = r"""
import json, sys
from portbench.harness import device, spec
bench = spec.load_benchmark()
cell = spec.workload(bench, sys.argv[1])
cfg = spec.config(bench, cell["config"])
mix = spec.traffic(cell["traffic"])
res = spec.runner(mix["kind"]).run(cell, cfg, mix, 2 ** 31 + 41, 0.2, False,
                                   device.Clock(), device_name="cpu")
print(json.dumps({"correct": res["correct"], "checks": res["checks"],
                  "attempted": res["attempted"]}))
"""


def _new_cells(bench, root, bench_dir):
    """Files of two cells whose model, task and data kind their runner
    has not run: a sem_seg segmenter trained on per-point labels, and an
    SSG classifier served on blocks of a new kind."""
    sem = spec.config(bench, "pointnet2_sem_seg-scannet")
    seg = dict(sem, num_point=2048, dtype="float32",
               data={"kind": "toy_segmentation", "samples": 4},
               train=dict(spec.config(bench, "pointnet2_cls_ssg-modelnet40")
                          ["train"], augment="none"))
    cls = dict(spec.config(bench, "pointnet2_cls_ssg-modelnet40"),
               dtype="float32", data={"kind": "toy_blobs"})
    files = {
        "configs/toy_seg.json": json.dumps(seg),
        "configs/toy_seg.ref.py": _SEG_REF,
        "inputs/toy_segmentation.py": _SEG_INPUTS,
        "traffic/toy_seg_b2.json": json.dumps({
            "kind": "train_epochs", "batch_per_chip": 2, "steps_per_call": 2,
            "setup_single_steps": 1, "trace_batches": 1}),
        "limits/toy_seg.train.json": json.dumps(
            spec.limits("cls_ssg.train")),
        "configs/toy_cls.json": json.dumps(cls),
        "configs/toy_cls.ref.py": _CLS_REF,
        "inputs/toy_blobs.py": _BLOB_INPUTS,
        "traffic/toy_blobs2.json": json.dumps({
            "kind": "serve_blocks", "blocks_per_request": 2,
            "points_per_block": 1024, "pool_requests": 2,
            "sampled_requests": 1, "trace_requests": 1}),
        "limits/toy_cls.serve.json": json.dumps(
            spec.limits("sem_seg.serve_blocks")),
    }
    for rel, text in files.items():
        (bench_dir / rel).write_text(text)
    for name in ("toy_seg", "toy_cls"):
        bench["configs"].append({"name": name, "source": "x", "reduced": [],
                                 "file": f"portbench/configs/{name}.json",
                                 "why": "x"})
    bench["workloads"] += [
        {"name": "toy_seg.train", "config": "toy_seg",
         "traffic": "toy_seg_b2", "chips": 1, "why": "x"},
        {"name": "toy_cls.serve", "config": "toy_cls",
         "traffic": "toy_blobs2", "chips": 1, "why": "x"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("cell", ["toy_seg.train", "toy_cls.serve"])
def test_a_new_model_task_and_data_kind_run_from_files_alone(tmp_path, cell):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    _new_cells(spec.load_benchmark(root), root, root / "portbench")
    # the copy of portbench first, the port from this checkout
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                        str(spec.ROOT)]),
               OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", _RUN, cell], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["attempted"] > 0
    assert res["correct"], res["checks"]
