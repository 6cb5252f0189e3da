"""Training CLI of the port, on the card.

Port of pointnet2_tpu/cli/train.py: one entry point for every model of
the registry, the task from the model; the same flags and defaults, plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch
versions). A rerun with the same ``--log_dir`` resumes from its
checkpoint. Flags whose code is not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item instead of running
another configuration: ``--num_devices`` and ``--multihost`` (item 6),
``--steps_per_call``, ``--remat``, ``--watchdog_secs`` and ``--normal``
for a classifier (item 5), ``--virtual_scan`` (item 7).

Usage:
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_cls_ssg \\
      --data data/modelnet40_ply_hdf5_2048 --num_point 1024 --batch_size 16
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_cls_ssg --synthetic
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_sem_seg \\
      --synthetic --num_point 8192 --max_epoch 10
"""

from __future__ import annotations

import argparse
import json
import os

from pointnet2_tpu_torch.models import MODEL_REGISTRY

# flag -> (the value that runs ported code, the ROADMAP.md item that ports
# the rest)
_NOT_PORTED = {
    "num_devices": (None, "Queue 1 item 6 (scale-out)"),
    "multihost": (False, "Queue 1 item 6 (scale-out)"),
    "steps_per_call": (1, "Queue 1 item 5 (the trainer's switches)"),
    "remat": ("none", "Queue 1 item 5 (the trainer's switches)"),
    "watchdog_secs": (None, "Queue 1 item 5 (the trainer's switches)"),
    "virtual_scan": (False, "Queue 1 item 7 (ScannetDatasetVirtualScan)"),
}


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag set to what is not ported."""
    for flag, (ported, item) in _NOT_PORTED.items():
        value = getattr(args, flag, ported)
        if value != ported:
            raise NotImplementedError(
                f"--{flag} {value!r} is not ported yet: ROADMAP.md {item}")
    if getattr(args, "normal", False) and \
            MODEL_REGISTRY[args.model].task == "cls":
        raise NotImplementedError(
            "--normal for a classifier (the ModelNet txt data with "
            "normals) is not ported yet: ROADMAP.md Queue 1 item 5")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="pointnet2_cls_ssg",
                   choices=sorted(MODEL_REGISTRY))
    p.add_argument("--data", default=None,
                   help="dataset root (task-specific layout)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic dataset (hermetic)")
    p.add_argument("--synthetic_size", type=int, default=8,
                   help="samples per class for the synthetic cls dataset")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--max_epoch", type=int, default=251)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=200000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--normal", action="store_true",
                   help="use XYZ+normal input (txt dataset for cls; not "
                        "ported for cls)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="not ported: one device")
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the model's class count (e.g. sem_seg)")
    p.add_argument("--model_kwargs", type=str, default=None,
                   help="JSON dict of extra model constructor kwargs, e.g. "
                        "'{\"sa1_nsample\": [128,128,128]}'")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (params/stats stay float32)")
    p.add_argument("--eval_every", type=int, default=None,
                   help="epochs between evals (default 1; sem_seg defaults "
                        "to 5 like scannet/train.py:167)")
    p.add_argument("--no_whole_scene_eval", action="store_true",
                   help="sem_seg: skip the whole-scene sliding-block eval "
                        "and caliacc best-ckpt selection during training")
    p.add_argument("--loader_workers", type=int, default=2,
                   help="sem_seg: threads producing crop samples in "
                        "parallel (0/1 = in-line)")
    p.add_argument("--virtual_scan", action="store_true",
                   help="sem_seg: 8-view virtual-scan samples (not ported)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="not ported: one step a dispatch")
    p.add_argument("--remat", default="none",
                   choices=["none", "full", "dots", "dots_nobatch"],
                   help="not ported: no rematerialization")
    p.add_argument("--watchdog_secs", type=float, default=None,
                   help="not ported: no stall watchdog")
    p.add_argument("--multihost", action="store_true",
                   help="not ported: one process")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the plain PyTorch "
                        "versions of the kernels)")
    return p


def make_datasets(args, test_only: bool = False):
    """(train, eval, on-device augmentation name) for the model's task;
    `test_only` skips loading the train split (None in its place)."""
    check_ported(args)
    task = MODEL_REGISTRY[args.model].task
    if task == "cls":
        if args.synthetic or args.data is None:
            from pointnet2_tpu_torch.data import SyntheticClassification

            def mk(seed):
                return SyntheticClassification(
                    num_classes=40, samples_per_class=args.synthetic_size,
                    npoints=args.num_point, batch_size=args.batch_size,
                    seed=seed)
            return mk(0), mk(1), "cls"
        from pointnet2_tpu_torch.data import ModelNetH5Dataset

        train = None if test_only else ModelNetH5Dataset(
            os.path.join(args.data, "train_files.txt"),
            batch_size=args.batch_size, npoints=args.num_point)
        test = ModelNetH5Dataset(os.path.join(args.data, "test_files.txt"),
                                 batch_size=args.batch_size,
                                 npoints=args.num_point, shuffle=False)
        return train, test, "cls"
    if task in ("part_seg", "part_seg_one_hot"):
        if args.synthetic or args.data is None:
            from pointnet2_tpu_torch.data import SyntheticShapeNetPart

            def mk(seed):
                return SyntheticShapeNetPart(
                    num_samples=64, npoints=args.num_point,
                    batch_size=args.batch_size, seed=seed)
            return mk(0), mk(1), "none"
        from pointnet2_tpu_torch.data import PartNormalDataset

        train = None if test_only else PartNormalDataset(
            args.data, npoints=args.num_point, split="trainval",
            batch_size=args.batch_size)
        test = PartNormalDataset(args.data, npoints=args.num_point,
                                 split="test", batch_size=args.batch_size)
        return train, test, "none"
    # sem_seg
    from pointnet2_tpu_torch.data import ScannetDataset

    workers = getattr(args, "loader_workers", 2)  # cli.evaluate has none
    if args.synthetic or args.data is None:
        from pointnet2_tpu_torch.data import make_synthetic_scenes

        train = ScannetDataset(scenes=make_synthetic_scenes(4),
                               npoints=args.num_point, split="train",
                               batch_size=args.batch_size,
                               num_workers=workers)
        test = ScannetDataset(scenes=make_synthetic_scenes(2, seed=9),
                              npoints=args.num_point, split="test",
                              batch_size=args.batch_size)
        return train, test, "scannet"
    train = None if test_only else ScannetDataset(
        root=args.data, npoints=args.num_point, split="train",
        batch_size=args.batch_size, num_workers=workers)
    test = ScannetDataset(root=args.data, npoints=args.num_point,
                          split="test", batch_size=args.batch_size)
    return train, test, "scannet"


def whole_scene_dataset(args):
    """The whole-scene tiler over the test scenes (the pickle root or the
    synthetic set)."""
    from pointnet2_tpu_torch.data import ScannetDatasetWholeScene

    if args.synthetic or args.data is None:
        from pointnet2_tpu_torch.data import make_synthetic_scenes

        return ScannetDatasetWholeScene(
            scenes=make_synthetic_scenes(2, seed=9), npoints=args.num_point,
            split="test", batch_size=args.batch_size)
    return ScannetDatasetWholeScene(root=args.data, npoints=args.num_point,
                                    split="test", batch_size=args.batch_size)


def parse_model_kwargs(args, task) -> dict:
    """--model_kwargs JSON (and --num_classes) -> model constructor kwargs,
    lists turned into tuples recursively, as the JAX package's (so the same
    flags give the same kwargs in train and evaluate)."""
    model_kwargs = {}
    if getattr(args, "model_kwargs", None):
        def _tuplify(v):
            return tuple(_tuplify(x) for x in v) if isinstance(v, list) else v

        model_kwargs.update({
            k: _tuplify(v)
            for k, v in json.loads(args.model_kwargs).items()})
    if getattr(args, "num_classes", None) is not None:
        key = "num_classes" if task in ("cls", "sem_seg") else "num_parts"
        model_kwargs[key] = args.num_classes
    return model_kwargs


def make_sem_seg_eval_protocol(args, test_ds):
    """Whole-scene + calibrated-voxel-accuracy best-checkpoint selection
    (scannet/train.py:167-174): the chopped evaluation on `test_ds`, the
    whole-scene one on the same scenes."""
    from pointnet2_tpu_torch.evaluation.scannet_eval import (
        make_scannet_eval_protocol,
    )

    return make_scannet_eval_protocol(test_ds, whole_scene_dataset(args),
                                      batch_size=args.batch_size)


def main(argv=None) -> None:
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    args = build_parser().parse_args(argv)
    train_ds, test_ds, augment = make_datasets(args)
    task = MODEL_REGISTRY[args.model].task
    eval_every = args.eval_every
    if eval_every is None:
        eval_every = 5 if task == "sem_seg" else 1
    config = TrainConfig(
        model=args.model, num_point=args.num_point,
        batch_size=args.batch_size, max_epoch=args.max_epoch,
        learning_rate=args.learning_rate, momentum=args.momentum,
        optimizer=args.optimizer, decay_step=args.decay_step,
        decay_rate=args.decay_rate, augment=augment, log_dir=args.log_dir,
        eval_every=eval_every, compute_dtype=args.dtype,
        model_kwargs=parse_model_kwargs(args, task))
    with Trainer(config, device=args.device) as trainer:
        trainer.log(f"config: {vars(args)}")
        eval_protocol = None
        if task == "sem_seg" and not args.no_whole_scene_eval:
            eval_protocol = make_sem_seg_eval_protocol(args, test_ds)
        trainer.fit(train_ds, eval_dataset=test_ds,
                    eval_protocol=eval_protocol)


if __name__ == "__main__":
    main()
