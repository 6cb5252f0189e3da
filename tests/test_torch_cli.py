"""The port's train and evaluate CLIs on the CPU (``--device cpu``).

The user journey of tests/test_cli_journey.py:20 without ``cli.visualize``
(not ported): ``cli.train`` writes checkpoints and metrics,
``cli.evaluate --out`` restores one and writes the JAX package's record,
and ``Predictor.from_checkpoint`` serves it; the same for sem_seg with its
whole-scene protocol and two loader threads. The parsers take the JAX
package's flags with its defaults, ``parse_model_kwargs`` gives JAX's
kwargs, and each flag whose code is not ported raises.
"""

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
from pointnet2_tpu_torch.cli import train as cli_train


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
    (["--steps_per_call", "25"], "item 5"),
    (["--remat", "full"], "item 5"),
    (["--watchdog_secs", "600"], "item 5"),
    (["--normal"], "item 5"),
    (["--model", "pointnet2_sem_seg", "--virtual_scan"], "item 7"),
])
def test_unported_flags_raise(tmp_path, flags, item):
    base = ["--synthetic", "--device", "cpu", "--log_dir",
            str(tmp_path / "log")]
    with pytest.raises(NotImplementedError, match=item):
        cli_train.main(base + flags)
    if flags[0] in ("--num_devices", "--multihost", "--normal"):
        with pytest.raises(NotImplementedError, match=item):
            cli_evaluate.main(base + flags)
    assert not os.path.exists(tmp_path / "log")  # nothing ran


def test_clis_run_on_the_card_by_default(tmp_path):
    """Without --device the CLIs ask for CUDA, and without a card they
    raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    base = ["--synthetic", "--log_dir", str(tmp_path / "log")]
    for main in (cli_train.main, cli_evaluate.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(base)
