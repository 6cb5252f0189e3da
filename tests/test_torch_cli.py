"""The port's train and evaluate CLIs on the CPU (``--device cpu``).

The user journey of tests/test_cli_journey.py:20 without ``cli.visualize``
(not ported): ``cli.train`` writes checkpoints and metrics,
``cli.evaluate --out`` restores one and writes the JAX package's record,
and ``Predictor.from_checkpoint`` serves it; the same for sem_seg with its
whole-scene protocol and two loader threads. The parsers take the JAX
package's flags with its defaults, ``parse_model_kwargs`` gives JAX's
kwargs, and every flag runs (``--virtual_scan`` on generated rooms). The
trainer's switches run: ``--steps_per_call`` and ``--remat`` write the
checkpoint of the run without them bit for bit, ``--watchdog_secs`` arms the watchdog,
``--normal`` trains and evaluates a classifier on 6-channel synthetic
clouds and on a generated ModelNet txt tree; every run's config.json,
metrics.jsonl and sidecar laid out as JAX's CLI writes them.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pointnet2_tpu.cli import evaluate as jax_evaluate
from pointnet2_tpu.cli import train as jax_train
from pointnet2_tpu.evaluation import cls_vote as jcls_vote
from pointnet2_tpu.evaluation import scannet_eval as jscan_eval
from pointnet2_tpu.data.synthetic import (
    SyntheticClassification as JaxSyntheticClassification,
)
from pointnet2_tpu_torch import Predictor
from pointnet2_tpu_torch.cli import evaluate as cli_evaluate
from pointnet2_tpu.train.trainer import TrainConfig as JaxTrainConfig
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.train import checkpoint as ckpt
from pointnet2_tpu_torch.train import trainer as trainer_mod
from tests.test_torch_multi_step import one_thread  # noqa: F401


def _rows(log_dir):
    return [json.loads(line)
            for line in open(os.path.join(log_dir, "metrics.jsonl"))]


def test_cli_train_evaluate_serve(tmp_path):
    log_dir = str(tmp_path / "log")
    common = ["--model", "pointnet2_cls_ssg", "--synthetic",
              "--synthetic_size", "1", "--num_point", "128",
              "--batch_size", "8", "--log_dir", log_dir, "--device", "cpu"]
    cli_train.main(common + ["--max_epoch", "1", "--eval_every", "1"])
    for name in ("ckpt", "best"):
        assert os.path.isfile(os.path.join(log_dir, name, "state.pt"))
    assert json.load(open(os.path.join(log_dir, "ckpt.meta.json"))) == {
        "step": 5, "epoch": 1}
    assert "score" in json.load(open(os.path.join(log_dir,
                                                  "best.meta.json")))
    assert [r["split"] for r in _rows(log_dir)] == ["train", "eval"]
    cfg = json.load(open(os.path.join(log_dir, "config.json")))
    assert cfg["model"] == "pointnet2_cls_ssg" and cfg["augment"] == "cls"

    out = str(tmp_path / "metrics.json")
    cli_evaluate.main(common + ["--num_votes", "2", "--out", out])
    record = json.load(open(out))
    assert record["model"] == "pointnet2_cls_ssg" and record["ckpt"] == "ckpt"
    assert record["step"] == 5 and record["num_votes"] == 2
    # the metrics' keys are JAX's protocol's
    want = jcls_vote.evaluate_cls_voting(
        lambda p: np.zeros((len(p), 40)),
        JaxSyntheticClassification(num_classes=40, samples_per_class=1,
                                   npoints=128, batch_size=8),
        num_votes=1, rng=0, log_fn=lambda s: None)
    assert record["metrics"].keys() == want.keys()
    assert len(record["metrics"]["class_accuracy"]) == 40
    assert sum(record["metrics"]["per_class_seen"]) == 40

    pred = Predictor.from_checkpoint("pointnet2_cls_ssg", log_dir,
                                     num_point=128, buckets=(4,), dtype=None,
                                     device="cpu")
    logits = pred(np.random.RandomState(0).rand(3, 128, 3)
                  .astype(np.float32))
    assert logits.shape == (3, 40) and np.isfinite(logits).all()


def test_cli_sem_seg_journey_with_whole_scene_protocol(tmp_path):
    log_dir = str(tmp_path / "log")
    common = ["--model", "pointnet2_sem_seg", "--synthetic", "--num_point",
              "128", "--batch_size", "4", "--log_dir", log_dir,
              "--device", "cpu"]
    cli_train.main(common + ["--max_epoch", "1", "--loader_workers", "2"])
    splits = [r["split"] for r in _rows(log_dir)]
    assert splits == ["train", "eval_chopped", "eval_whole_scene"]
    best = json.load(open(os.path.join(log_dir, "best.meta.json")))
    assert best["score"] == _rows(log_dir)[2]["calibrated_accuracy_vox"]
    out = str(tmp_path / "metrics.json")
    cli_evaluate.main(common + ["--out", out])
    record = json.load(open(out))
    assert record["metrics"].keys() == {"chopped", "whole_scene"}
    keys = jscan_eval.ScanNetMetrics().result(log_fn=lambda s: None).keys()
    for part in record["metrics"].values():
        assert part.keys() == keys


def _args(parser, argv):
    return vars(parser.parse_args(argv))


@pytest.mark.parametrize("which", ["train", "evaluate"])
def test_parsers_take_jax_flags_and_defaults(which):
    ours = {"train": cli_train, "evaluate": cli_evaluate}[which]
    theirs = {"train": jax_train, "evaluate": jax_evaluate}[which]
    got = _args(ours.build_parser(), [])
    want = _args(theirs.build_parser(), [])
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", [
    [],
    ["--num_classes", "13"],
    ["--model_kwargs", '{"sa1_nsample": [8, 8, 8], "x": [[1, 2], [3]]}'],
    ["--model", "pointnet2_part_seg", "--num_classes", "7",
     "--model_kwargs", '{"dtype": null}'],
])
def test_parse_model_kwargs_equals_jax(argv):
    args = jax_train.build_parser().parse_args(argv)
    task = {"pointnet2_part_seg": "part_seg"}.get(args.model, "cls")
    got = cli_train.parse_model_kwargs(
        cli_train.build_parser().parse_args(argv), task)
    assert got == jax_train.parse_model_kwargs(args, task)
    assert all(not isinstance(v, list) for v in got.values())


@pytest.mark.parametrize("flags, item", [
    (["--num_devices", "2"], "item 6"),
    (["--multihost"], "item 6"),
    (["--model", "pointnet2_sem_seg", "--virtual_scan"], "item 7"),
])
def test_unported_flags_raise(tmp_path, flags, item):
    """Every flag once refused as not ported now runs. --virtual_scan
    (ROADMAP item 7) trains one epoch of sem_seg on the virtual scans of two
    generated rooms, with the chopped and whole-scene protocols on a third,
    and writes metrics.jsonl. The flags of item 6 (scale-out): --num_devices
    2 trains on two gloo ranks, --multihost outside a torchrun job as one
    process; cli.evaluate takes the same flag and reads the checkpoint (one
    epoch of 40 clouds in batches of 8: step 5)."""
    base = ["--synthetic", "--device", "cpu", "--log_dir",
            str(tmp_path / "log")]
    if item == "item 7":
        from pointnet2_tpu_torch.data import ScannetDatasetVirtualScan
        from pointnet2_tpu_torch.data.procedural_scannet import generate

        data = str(tmp_path / "rooms")
        generate(data, train=2, test=1, seed=2, min_points=3000,
                 max_points=4000)
        views = ScannetDatasetVirtualScan(root=data, npoints=64,
                                          batch_size=8)
        cli_train.main(base[1:] + flags + [
            "--data", data, "--num_point", "64", "--batch_size", "8",
            "--max_epoch", "1", "--eval_every", "1"])
        rows = _rows(str(tmp_path / "log"))
        assert [r["split"] for r in rows] == [
            "train", "eval_chopped", "eval_whole_scene"]
        assert np.isfinite(rows[0]["loss"])
        assert rows[0]["step"] == views.num_batches() > 1
        return
    small = ["--model", "pointnet_cls_basic", "--synthetic_size", "1",
             "--num_point", "64", "--batch_size", "8"]
    cli_train.main(base + small + ["--max_epoch", "1"] + flags)
    out = tmp_path / "eval.json"
    cli_evaluate.main(base + small + ["--num_votes", "1", "--out", str(out)]
                      + flags)
    with open(out) as f:
        assert json.load(f)["step"] == 5


# --- the trainer's switches and --normal ------------------------------------

# pointnet_cls_basic: BN and dropout as the other classifiers, a fraction
# of their work a cloud
_SMALL = ["--model", "pointnet_cls_basic", "--synthetic", "--synthetic_size",
          "1", "--num_point", "32", "--batch_size", "16", "--max_epoch", "1",
          "--device", "cpu"]


def _train(log_dir, *flags) -> dict:
    """cli.train of cls_basic (40 synthetic clouds of 32 points, 3 steps
    of 16, one epoch); returns the final checkpoint's model and the run's records,
    after checking they are laid out as JAX's CLI writes them."""
    cli_train.main(_SMALL + ["--log_dir", str(log_dir), *flags])
    cfg = json.load(open(os.path.join(log_dir, "config.json")))
    assert cfg.keys() == {f.name for f in dataclasses.fields(
        JaxTrainConfig)}
    rows = _rows(log_dir)
    assert [r["split"] for r in rows] == ["train", "eval"]
    assert rows[0].keys() == {"epoch", "split", "loss", "accuracy",
                              "examples_per_sec", "step", "learning_rate",
                              "bn_momentum"}
    assert json.load(open(os.path.join(log_dir, "ckpt.meta.json"))) == {
        "step": 3, "epoch": 1}
    saved = ckpt.read_checkpoint(str(log_dir))
    return {"config": cfg, "model": saved["model"],
            "optimizer": saved["optimizer"]}


def _same_run(a: dict, b: dict) -> bool:
    return (a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k])
                    for k in a["model"])
            and all(torch.equal(x, y) for k in ("mu", "nu")
                    for x, y in zip(a["optimizer"][k], b["optimizer"][k])))


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _train(tmp_path_factory.mktemp("plain"))
    finally:
        torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("flags", [["--steps_per_call", "2"],
                                   ["--remat", "full"]])
def test_cli_switches_train_the_same_run(tmp_path, plain_run, flags):
    """--steps_per_call 2 (3 steps: a call of 2, then a single step) and
    --remat write the checkpoint of the run without them, bit for bit;
    config.json records the flag under JAX's field name."""
    got = _train(tmp_path, *flags)
    field, value = flags[0][2:], flags[1]
    assert str(got["config"][field]) == value
    assert plain_run["config"][field] in (1, "none")
    assert _same_run(got, plain_run)


@pytest.mark.usefixtures("one_thread")
def test_cli_watchdog_secs_arms_and_closes_the_watchdog(tmp_path,
                                                         monkeypatch):
    made = []

    class Recorder:
        def __init__(self, timeout_s, log_fn=print):
            self.timeout_s, self.beats, self.closed = timeout_s, 0, False
            made.append(self)

        def beat(self):
            self.beats += 1

        def close(self):
            self.closed = True

    monkeypatch.setattr(trainer_mod, "Watchdog", Recorder)
    got = _train(tmp_path, "--watchdog_secs", "600")
    assert got["config"]["watchdog_secs"] == 600.0
    (wd,) = made
    assert wd.timeout_s == 600.0 and wd.closed and wd.beats >= 3


@pytest.mark.usefixtures("one_thread")
def test_cli_normal_synthetic_trains_and_evaluates(tmp_path):
    """--normal on synthetic data: 6-channel clouds, the cls_normals
    augmentation, a 6-channel model; cli.evaluate --normal restores it."""
    got = _train(tmp_path, "--normal")
    assert got["config"]["augment"] == "cls_normals"
    assert got["config"]["model_kwargs"] == {"in_channels": 6}
    assert got["model"]["point_mlp.conv0.dense.weight"].shape[1] == 6
    out = str(tmp_path / "metrics.json")
    cli_evaluate.main(_SMALL[:-4] + ["--device", "cpu", "--normal",
                                     "--log_dir", str(tmp_path),
                                     "--num_votes", "2", "--out", out])
    record = json.load(open(out))
    assert record["step"] == 3 and record["num_votes"] == 2
    assert sum(record["metrics"]["per_class_seen"]) == 40


@pytest.mark.usefixtures("one_thread")
def test_cli_normal_reads_the_modelnet_txt_data(tmp_path):
    """--normal --data: the resampled-txt tree (two classes) with normals
    and the host data's shapes, trained and evaluated (cls_ssg)."""
    from tests.test_torch_host_data import _write_tree

    data = tmp_path / "modelnet40_normal_resampled"
    data.mkdir()
    _write_tree(data, n_points=64)
    log_dir = str(tmp_path / "log")
    flags = ["--model", "pointnet2_cls_ssg", "--normal", "--data", str(data),
             "--num_point", "64", "--batch_size", "4", "--device", "cpu",
             "--log_dir", log_dir, "--num_classes", "2"]
    cli_train.main(flags + ["--max_epoch", "1", "--steps_per_call", "2"])
    assert [r["split"] for r in _rows(log_dir)] == ["train", "eval"]
    assert json.load(open(os.path.join(log_dir, "ckpt.meta.json"))) == {
        "step": 2, "epoch": 1}
    cfg = json.load(open(os.path.join(log_dir, "config.json")))
    assert cfg["augment"] == "cls_normals"
    assert cfg["model_kwargs"] == {"num_classes": 2, "in_channels": 6}
    out = str(tmp_path / "metrics.json")
    cli_evaluate.main(flags + ["--num_votes", "1", "--out", out])
    record = json.load(open(out))
    assert record["step"] == 2
    assert sum(record["metrics"]["per_class_seen"]) == 3  # the test split


def test_clis_run_on_the_card_by_default(tmp_path):
    """Without --device the CLIs ask for CUDA, and without a card they
    raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    base = ["--synthetic", "--log_dir", str(tmp_path / "log")]
    for main in (cli_train.main, cli_evaluate.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(base)
