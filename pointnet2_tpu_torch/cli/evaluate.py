"""Evaluation CLI of the port: restore a checkpoint and run the task's
protocol, on the card.

Port of pointnet2_tpu/cli/evaluate.py: the vote for ``cls``
(evaluate.py), the part vote and mIoU for the part tasks
(part_seg/evaluate.py), the chopped and whole-scene ScanNet evaluations
for ``sem_seg`` (scannet/train.py's eval passes). ``--out`` writes the
JAX package's JSON record: ``model``, ``ckpt``, ``step``, ``num_votes``,
``metrics``. ``--device`` is ``cuda`` by default; ``cpu`` runs the plain
PyTorch versions. ``--normal`` evaluates a classifier on the ModelNet
txt data with normals (or 6-channel synthetic clouds), as in ``cli.train``.

On several ranks (``--num_devices N``, N processes on this host; or
``--multihost``, one rank of a torchrun job; JAX cli/evaluate.py:34-42,
57-147) every rank restores the same checkpoint, scores its
``process_shard`` of the test set at ``--batch_size`` / ranks a batch, and
the protocols sum their counters over the ranks; the primary writes
``--out``. The synthetic classification and part sets take no shard (as
in the JAX package): each rank scores all of them, and every counter then
counts each item once a rank, which leaves the metrics, all ratios, as
they are.

Usage:
  python -m pointnet2_tpu_torch.cli.evaluate --model pointnet2_cls_ssg \\
      --log_dir log --num_votes 12 [--synthetic | --data ROOT] [--out m.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from pointnet2_tpu_torch.models import MODEL_REGISTRY
from pointnet2_tpu_torch.parallel import launch, multihost


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="pointnet2_cls_ssg",
                   choices=sorted(MODEL_REGISTRY))
    p.add_argument("--data", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=8)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--ckpt", default="ckpt", help="checkpoint name in log_dir")
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_votes", type=int, default=12)
    p.add_argument("--normal", action="store_true")
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks: N > 1 starts N processes on this host, one "
                        "a card, each scoring its shard of the test set")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--model_kwargs", type=str, default=None,
                   help="JSON dict of extra model constructor kwargs "
                        "(must match the trained config)")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a torchrun job: --batch_size is the "
                        "GLOBAL batch, the test set is sharded over ranks")
    p.add_argument("--out", default=None,
                   help="write the protocol metrics as JSON here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the plain PyTorch "
                        "versions of the kernels)")
    return p


def _clean(v):
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if (args.num_devices or 1) > 1 and not args.multihost:
        rc = launch.spawn(run_rank, args.num_devices, device=args.device,
                          args=(argv,))
        if rc:
            raise SystemExit(rc)
        return
    if args.multihost:
        multihost.initialize(backend="gloo" if args.device == "cpu"
                             else None)
    evaluate(args)
    if multihost.process_count() > 1:
        launch.leave()


def run_rank(argv: list[str]) -> None:
    """One rank of ``--num_devices N`` (parallel.launch.spawn)."""
    evaluate(build_parser().parse_args(argv))


def evaluate(args) -> None:
    from pointnet2_tpu_torch.cli.train import (
        make_datasets,
        parse_model_kwargs,
        rank_shard,
        whole_scene_dataset,
    )
    from pointnet2_tpu_torch.evaluation import (
        evaluate_cls_voting,
        evaluate_part_seg_voting,
        evaluate_scannet_chopped,
        evaluate_scannet_whole_scene,
    )
    from pointnet2_tpu_torch.train import TrainConfig, Trainer
    from pointnet2_tpu_torch.train import checkpoint as ckpt

    task = MODEL_REGISTRY[args.model].task
    local, shard = rank_shard(args, True)
    _, test_ds, _ = make_datasets(local, test_only=True, shard=shard)
    config = TrainConfig(model=args.model, num_point=args.num_point,
                         batch_size=args.batch_size,
                         num_devices=args.num_devices, log_dir=args.log_dir,
                         model_kwargs=parse_model_kwargs(args, task))
    with Trainer(config, device=args.device) as trainer:
        state = ckpt.restore_checkpoint(args.log_dir, trainer.init_state(),
                                        name=args.ckpt)
        trainer.log(f"restored {args.ckpt} at step {state.step}")
        logits_fn = trainer.eval_logits_fn(state)
        if task == "cls":
            results = evaluate_cls_voting(
                lambda points: logits_fn({"points": points}), test_ds,
                num_votes=args.num_votes,
                num_classes=(args.num_classes
                             if args.num_classes is not None else 40),
                rng=0, log_fn=trainer.log)
        elif task in ("part_seg", "part_seg_one_hot"):
            results = evaluate_part_seg_voting(
                logits_fn, test_ds, num_votes=args.num_votes, rng=0,
                log_fn=trainer.log)
        else:  # sem_seg
            chopped = evaluate_scannet_chopped(logits_fn, test_ds, rng=0,
                                               log_fn=trainer.log)
            whole = evaluate_scannet_whole_scene(
                logits_fn, whole_scene_dataset(local, shard),
                batch_size=local.batch_size, log_fn=trainer.log)
            results = {"chopped": chopped, "whole_scene": whole}
        if args.out and multihost.is_primary():
            record = {"model": args.model, "ckpt": args.ckpt,
                      "step": state.step, "num_votes": args.num_votes,
                      "metrics": _clean(results)}
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1)
            trainer.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
