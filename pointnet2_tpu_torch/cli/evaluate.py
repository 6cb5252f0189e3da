"""Evaluation CLI of the port: restore a checkpoint and run the task's
protocol, on the card.

Port of pointnet2_tpu/cli/evaluate.py: the vote for ``cls``
(evaluate.py), the part vote and mIoU for the part tasks
(part_seg/evaluate.py), the chopped and whole-scene ScanNet evaluations
for ``sem_seg`` (scannet/train.py's eval passes). ``--out`` writes the
JAX package's JSON record: ``model``, ``ckpt``, ``step``, ``num_votes``,
``metrics``. ``--device`` is ``cuda`` by default; ``cpu`` runs the plain
PyTorch versions. ``--normal`` evaluates a classifier on the ModelNet
txt data with normals (or 6-channel synthetic clouds), as in ``cli.train``;
``--num_devices`` and ``--multihost`` raise, as there.

Usage:
  python -m pointnet2_tpu_torch.cli.evaluate --model pointnet2_cls_ssg \\
      --log_dir log --num_votes 12 [--synthetic | --data ROOT] [--out m.json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from pointnet2_tpu_torch.models import MODEL_REGISTRY


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
                   help="not ported: one device")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--model_kwargs", type=str, default=None,
                   help="JSON dict of extra model constructor kwargs "
                        "(must match the trained config)")
    p.add_argument("--multihost", action="store_true",
                   help="not ported: one process")
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
    from pointnet2_tpu_torch.cli.train import (
        make_datasets,
        parse_model_kwargs,
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

    args = build_parser().parse_args(argv)
    task = MODEL_REGISTRY[args.model].task
    _, test_ds, _ = make_datasets(args, test_only=True)
    config = TrainConfig(model=args.model, num_point=args.num_point,
                         batch_size=args.batch_size, log_dir=args.log_dir,
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
                logits_fn, whole_scene_dataset(args),
                batch_size=args.batch_size, log_fn=trainer.log)
            results = {"chopped": chopped, "whole_scene": whole}
        if args.out:
            record = {"model": args.model, "ckpt": args.ckpt,
                      "step": state.step, "num_votes": args.num_votes,
                      "metrics": _clean(results)}
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1)
            trainer.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
