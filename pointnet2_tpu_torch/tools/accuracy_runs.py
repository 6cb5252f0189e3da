#!/usr/bin/env python3
"""The port's accuracy trajectories on the procedural stand-ins.

Generates the three stand-ins (seed 0, full size) with the port's
``python -m`` entry points, trains the four recipes of the JAX package's
committed runs (``docs/artifacts/``) under ``cli.supervise``, evaluates each
with ``cli.evaluate``, and copies each run's small files (``config.json``,
``metrics.jsonl``, ``log_train.txt``, the evaluation's JSON and text, and
``run.json``: the command lines, K, wall times, the card) into
``--out/<run>/``. Checkpoints and data stay under ``--runs`` and ``--data``.

- ``procmn40v2_ssg_bf16``: pointnet2_cls_ssg, ModelNet 246 / 62 a class,
  2048 points, B=16, 1024 points, 41 epochs; ``cli.evaluate`` with 12
  votes on the final checkpoint. Without h5py the clouds are written in the
  txt layout (``generate_txt``, 2048 points) and the run trains and votes
  through ``ModelNetDataset`` without normals, in this script
  (``txt_cls``), with the same configuration;
- ``procsnp_msg1hot_bf16``: pointnet2_part_seg_msg_one_hot, ShapeNet-part
  110 / 20 / 33 a category, B=32, 2048 points, ``--decay_step 41600
  --decay_rate 0.5``, 41 epochs; 12-vote part mIoU on the final checkpoint;
- ``procscannet_semseg_bf16``: pointnet2_sem_seg, ScanNet 80 / 24 rooms,
  B=32, 8192 points, ``--decay_step 13280``, 201 epochs, the whole-scene
  protocol every 5; ``cli.evaluate`` on ``best``;
- ``procscannet_vscan_bf16``: the same with ``--virtual_scan``.

All in bfloat16 with the fused chain off, as the JAX runs, and K = 4
batches a CUDA graph replay (``--steps_per_call 4``; ``chip_smoke.py``
phase 28 holds a replay bit for bit K single steps), on the card.

Usage, from the repository root, on one NVIDIA GPU:

    python3 pointnet2_tpu_torch/tools/accuracy_runs.py --out log/acc

``--max_epoch E`` cuts every run to E epochs (a rehearsal);
``--runs_only a,b`` picks runs; ``summary ART`` prints the eval curves of
the runs under ART against the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PY = sys.executable

MODELNET, PART, SCANNET = ("procedural_modelnet40", "procedural_shapenet_part",
                           "procedural_scannet")
GENERATORS = {
    MODELNET: ("procedural_modelnet", ["--train_per_class", "246",
                                       "--test_per_class", "62"]),
    PART: ("procedural_shapenet_part", []),
    SCANNET: ("procedural_scannet", ["--train", "80", "--test", "24"]),
}
SEM = ["--model", "pointnet2_sem_seg", "--num_point", "8192",
       "--batch_size", "32"]
# run -> (data, the model's flags (cli.train and cli.evaluate), cli.train's
#         own, cli.evaluate's own, epochs, the epochs the account compares)
RECIPES = {
    "procmn40v2_ssg_bf16": (
        MODELNET, ["--model", "pointnet2_cls_ssg", "--num_point", "1024",
                   "--batch_size", "16"], [],
        ["--ckpt", "ckpt", "--num_votes", "12"], 41, (0, 10, 20, 30, 40)),
    "procsnp_msg1hot_bf16": (
        PART, ["--model", "pointnet2_part_seg_msg_one_hot", "--num_point",
               "2048", "--batch_size", "32"],
        ["--decay_step", "41600", "--decay_rate", "0.5"],
        ["--ckpt", "ckpt", "--num_votes", "12"], 41, (0, 10, 20, 30, 40)),
    "procscannet_semseg_bf16": (
        SCANNET, SEM, ["--decay_step", "13280"], ["--ckpt", "best"], 201,
        (0, 10, 20, 30, 40, 100, 150, 200)),
    "procscannet_vscan_bf16": (
        SCANNET, SEM, ["--decay_step", "13280", "--virtual_scan"],
        ["--ckpt", "best"], 201, (0, 10, 20, 30, 40, 100, 150, 200)),
}
# the bounds the runs are held to, written before the first run: (metric
# of the eval record at the last epoch or of cli.evaluate, least value)
BOUNDS = {
    "procmn40v2_ssg_bf16": [("eval accuracy, epoch 40", 0.985),
                            ("cli.evaluate 12-vote accuracy", 0.985)],
    "procsnp_msg1hot_bf16": [("eval accuracy, epoch 40", 0.985)],
    "procscannet_semseg_bf16": [
        ("cli.evaluate whole-scene calibrated voxel accuracy", 0.82)],
    "procscannet_vscan_bf16": [
        ("cli.evaluate whole-scene calibrated voxel accuracy", 0.72)],
}
STEPS_PER_CALL = 4
DEVICE = "cuda"
# the JAX package's run each is compared with (docs/artifacts/): the
# ScanNet runs of the regenerated rooms, which these runs' data equals
JAX_RUNS = {"procscannet_semseg_bf16": "procscannet_semseg_bf16_r5",
            "procscannet_vscan_bf16": "procscannet_vscan_bf16_r5"}
SMALL_FILES = ("config.json", "metrics.jsonl", "log_train.txt", "eval.json",
               "eval.txt")


def has_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def generate(data: str, names: set) -> dict:
    """The stand-ins the runs need, generated together (each skipped when
    its directory is there); returns each one's seconds."""
    jobs = []
    for name in sorted(names):
        mod, flags = GENERATORS[name]
        out = os.path.join(data, name)
        if name == MODELNET and not has_h5py():
            out += "_txt"
            flags = flags + ["--format", "txt", "--npoints", "2048"]
        if os.path.isdir(out):
            continue
        jobs.append((name, subprocess.Popen(
            [_PY, "-m", f"pointnet2_tpu_torch.data.{mod}", "--out", out,
             "--seed", "0", *flags]), time.perf_counter()))
    secs = {}
    while len(secs) < len(jobs):
        for name, proc, t0 in jobs:
            if name in secs or proc.poll() is None:
                continue
            if proc.returncode != 0:
                raise SystemExit(f"generating {name} failed: rc "
                                 f"{proc.returncode}")
            secs[name] = time.perf_counter() - t0
        time.sleep(0.2)
    return secs


def txt_cls(log_dir: str, data: str, epochs: int, out: str) -> None:
    """cls_ssg's recipe on the txt layout without normals: what cli.train
    and cli.evaluate run for it, through ``ModelNetDataset``."""
    from pointnet2_tpu_torch.cli.evaluate import _clean
    from pointnet2_tpu_torch.data import ModelNetDataset
    from pointnet2_tpu_torch.evaluation import evaluate_cls_voting
    from pointnet2_tpu_torch.train import TrainConfig, Trainer
    from pointnet2_tpu_torch.train import checkpoint as ckpt

    def ds(split):
        return ModelNetDataset(data, batch_size=16, npoints=1024,
                               split=split, normal_channel=False)

    cfg = TrainConfig(model="pointnet2_cls_ssg", num_point=1024,
                      batch_size=16, max_epoch=epochs, augment="cls",
                      log_dir=log_dir, eval_every=1,
                      compute_dtype="bfloat16",
                      steps_per_call=STEPS_PER_CALL)
    with Trainer(cfg, device=DEVICE) as tr:
        tr.fit(ds("train"), eval_dataset=ds("test"))
    cfg = TrainConfig(model="pointnet2_cls_ssg", num_point=1024,
                      batch_size=16, log_dir=log_dir)
    with Trainer(cfg, device=DEVICE) as tr:
        state = ckpt.restore_checkpoint(log_dir, tr.init_state(),
                                        name="ckpt")
        tr.log(f"restored ckpt at step {state.step}")
        logits_fn = tr.eval_logits_fn(state)
        res = evaluate_cls_voting(lambda p: logits_fn({"points": p}),
                                  ds("test"), num_votes=12, rng=0,
                                  log_fn=tr.log)
        with open(out, "w") as f:
            json.dump({"model": "pointnet2_cls_ssg", "ckpt": "ckpt",
                       "step": state.step, "num_votes": 12,
                       "metrics": _clean(res)}, f, indent=1)


def run_one(name: str, args) -> dict:
    """Train, evaluate and collect one run; returns its run.json."""
    data_name, model_flags, train_flags, eval_flags, epochs, _ = \
        RECIPES[name]
    epochs = args.max_epoch or epochs
    data = os.path.join(args.data, data_name)
    run_dir = os.path.join(args.runs, name)
    os.makedirs(run_dir, exist_ok=True)
    if name.startswith("procmn40") and not has_h5py():
        data += "_txt"
        train_cmd = [_PY, "-m", "pointnet2_tpu_torch.tools.accuracy_runs",
                     "txt_cls", run_dir, data, str(epochs),
                     os.path.join(run_dir, "eval.json")]
        eval_cmd = None
    else:
        common = [*model_flags, "--data", data, "--log_dir", run_dir,
                  "--device", DEVICE]
        train_cmd = [_PY, "-m", "pointnet2_tpu_torch.cli.supervise",
                     "--max_restarts", "3", "--backoff_secs", "10", "--",
                     *common, *train_flags, "--max_epoch", str(epochs),
                     "--dtype", "bfloat16", "--steps_per_call",
                     str(STEPS_PER_CALL)]
        eval_cmd = [_PY, "-m", "pointnet2_tpu_torch.cli.evaluate", *common,
                    *eval_flags, "--out", os.path.join(run_dir, "eval.json")]
    record = {"run": name, "gpu": gpu_line(), "h5py": has_h5py(),
              "data": data, "steps_per_call": STEPS_PER_CALL,
              "epochs": epochs, "train_command": ["python", *train_cmd[1:]],
              "eval_command": eval_cmd and ["python", *eval_cmd[1:]]}
    t0 = time.perf_counter()
    with open(os.path.join(run_dir, "train_stdout.txt"), "w") as f:
        record["train_rc"] = subprocess.run(train_cmd, stdout=f,
                                            stderr=subprocess.STDOUT
                                            ).returncode
    record["train_s"] = time.perf_counter() - t0
    if eval_cmd is not None and record["train_rc"] == 0:
        t0 = time.perf_counter()
        with open(os.path.join(run_dir, "eval.txt"), "w") as f:
            record["eval_rc"] = subprocess.run(eval_cmd, stdout=f,
                                               stderr=subprocess.STDOUT
                                               ).returncode
        record["eval_s"] = time.perf_counter() - t0
    elif eval_cmd is None:  # txt_cls voted in the train command
        shutil.copy(os.path.join(run_dir, "train_stdout.txt"),
                    os.path.join(run_dir, "eval.txt"))
    dest = os.path.join(args.out, name)
    os.makedirs(dest, exist_ok=True)
    for fn in SMALL_FILES + ("train_stdout.txt",):
        src = os.path.join(run_dir, fn)
        if os.path.isfile(src) and not (fn == "train_stdout.txt"
                                        and record["train_rc"] == 0):
            shutil.copy(src, dest)
    with open(os.path.join(dest, "run.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items()
                      if not k.endswith("command")}), flush=True)
    return record


def eval_rows(path: str) -> dict:
    """epoch -> the eval record a run logged (sem_seg: its whole-scene
    protocol's)."""
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r["split"] in ("eval", "eval_whole_scene"):
                rows[r["epoch"]] = r
    return rows


def summary(art: str) -> dict:
    """Each run's eval curve at the compared epochs against the JAX
    package's run of the same name, its evaluation record and its bounds."""
    out = {}
    for name, (*_, epochs) in RECIPES.items():
        path = os.path.join(art, name, "metrics.jsonl")
        if not os.path.isfile(path):
            continue
        key = ("calibrated_accuracy_vox" if "scannet" in name
               else "accuracy")
        ours = eval_rows(path)
        theirs = eval_rows(os.path.join(_ROOT, "docs", "artifacts",
                                        JAX_RUNS.get(name, name),
                                        "metrics.jsonl"))
        curve = {e: (ours.get(e, {}).get(key), theirs.get(e, {}).get(key))
                 for e in epochs}
        train = [json.loads(line) for line in open(path)
                 if '"split": "train"' in line]
        res = {"curve (epoch: port, jax)": curve,
               "last train loss": train[-1]["loss"] if train else None,
               "last epoch": max(ours) if ours else None}
        ev = os.path.join(art, name, "eval.json")
        if os.path.isfile(ev):
            m = json.load(open(ev))["metrics"]
            res["cli.evaluate"] = (m["whole_scene"]["calibrated_accuracy_vox"]
                                   if "whole_scene" in m else
                                   {k: m[k] for k in m
                                    if not isinstance(m[k], list)})
        res["bounds"] = BOUNDS[name]
        out[name] = res
    return out


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "txt_cls":
        log_dir, data, epochs, out = sys.argv[2:6]
        return txt_cls(log_dir, data, int(epochs), out)
    if len(sys.argv) > 1 and sys.argv[1] == "summary":
        print(json.dumps(summary(sys.argv[2]), indent=1))
        return None
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", default="data",
                    help="the stand-ins' root (relative: to the repository)")
    ap.add_argument("--runs", default="runs",
                    help="the runs' root (relative: to the repository)")
    ap.add_argument("--out", required=True,
                    help="directory for each run's small files")
    ap.add_argument("--runs_only", default=None,
                    help="comma-separated run names (default: all four)")
    ap.add_argument("--max_epoch", type=int, default=None,
                    help="cut every run to this many epochs")
    args = ap.parse_args()
    os.chdir(_ROOT)  # relative paths, in the records too, are the repo's
    names = (args.runs_only.split(",") if args.runs_only
             else list(RECIPES))
    print(f"gpu: {gpu_line()}; h5py: {has_h5py()}", flush=True)
    t0 = time.perf_counter()
    secs = generate(args.data, {RECIPES[n][0] for n in names})
    print(f"generated {secs} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    records = [run_one(name, args) for name in names]
    print(json.dumps(summary(args.out), indent=1), flush=True)
    if any(r["train_rc"] or r.get("eval_rc") for r in records):
        raise SystemExit(1)
    return None


if __name__ == "__main__":
    main()
