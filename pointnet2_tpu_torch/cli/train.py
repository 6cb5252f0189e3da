"""Training CLI of the port, on the card.

Port of pointnet2_tpu/cli/train.py: one entry point for every model of
the registry, the task from the model; the same flags and defaults, plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch
versions). A rerun with the same ``--log_dir`` resumes from its
checkpoint. ``--steps_per_call K`` trains K batches a CUDA graph replay,
``--remat`` checkpoints the forward, ``--watchdog_secs`` exits 75 on a
stall (run under ``cli.supervise`` to resume), and ``--normal`` trains a
classifier on xyz+normal clouds (the ModelNet txt data with the
``cls_normals`` augmentation, or 6-channel synthetic clouds).

Data parallelism (JAX cli/train.py:46,81-105,239-267):

- ``--num_devices N`` starts N ranks on this host (``parallel.launch``:
  NCCL on cards 0..N-1, gloo with ``--device cpu``). Every rank reads the
  whole data set with the same seed and trains on its rows of each global
  batch of ``--batch_size``; the sem_seg evaluation protocol scores each
  rank's share of the test scenes and sums the counters. A rank's non-zero
  exit code (the watchdog's 75) is this command's.
- ``--multihost`` makes this process one rank of a group that torchrun
  started (``multihost.initialize()`` from its environment): it loads its
  ``process_shard`` of each data set, at ``--batch_size`` / ranks a batch.

``--virtual_scan`` trains sem_seg on the eight virtual camera scans a
scene (``ScannetDatasetVirtualScan``) instead of random crops; the test
set and the whole-scene protocol stay the same.

Usage:
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_cls_ssg \\
      --data data/modelnet40_ply_hdf5_2048 --num_point 1024 --batch_size 16
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_cls_ssg --synthetic
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_sem_seg \\
      --synthetic --num_point 8192 --max_epoch 10 --steps_per_call 4
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_cls_ssg \\
      --normal --data data/modelnet40_normal_resampled
  python -m pointnet2_tpu_torch.cli.train --model pointnet2_sem_seg \\
      --data data/procedural_scannet --num_point 8192 --virtual_scan
  python -m pointnet2_tpu_torch.cli.train --synthetic --num_devices 4 \\
      --batch_size 128 --steps_per_call 4
  torchrun --nproc_per_node 4 -m pointnet2_tpu_torch.cli.train \\
      --multihost --data data/modelnet40_ply_hdf5_2048 --batch_size 128
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

from pointnet2_tpu_torch.models import MODEL_REGISTRY
from pointnet2_tpu_torch.parallel import launch, multihost

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
                   help="use XYZ+normal input (txt dataset for cls)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks: N > 1 starts N processes on "
                        "this host, one a card")
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
                   help="sem_seg: train on 8-view virtual-scan samples "
                        "instead of random crops")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train K prefetched batches a call: one CUDA graph "
                        "replay of K steps on the card")
    p.add_argument("--remat", default="none",
                   choices=["none", "full", "dots", "dots_nobatch"],
                   help="checkpoint the model forward: save nothing (full) "
                        "or only the matrix products (dots, dots_nobatch), "
                        "recompute the rest in the backward")
    p.add_argument("--watchdog_secs", type=float, default=None,
                   help="exit 75 (retryable) if no step or eval batch "
                        "completes for this long; cli.supervise restarts "
                        "the run, which resumes (train/watchdog.py)")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a torchrun job: --batch_size is the "
                        "GLOBAL batch, data is sharded over the ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the plain PyTorch "
                        "versions of the kernels)")
    return p


def rank_shard(args, sharded: bool):
    """(args with the rank's --batch_size, (rank, ranks)) when the data
    sets are to be sharded over several ranks, else (args, None)."""
    count = multihost.process_count()
    if not sharded or count == 1:
        return args, None
    args = copy.copy(args)
    args.batch_size = multihost.local_batch_size(args.batch_size)
    return args, (multihost.process_index(), count)


def make_datasets(args, test_only: bool = False, shard=None):
    """(train, eval, on-device augmentation name) for the model's task;
    `test_only` skips loading the train split (None in its place). With
    ``shard=(rank, ranks)`` every reader that takes ``process_shard`` keeps
    its share, the generated ScanNet scenes too (the synthetic
    classification and part sets are every rank's, as in the JAX
    package). ``--virtual_scan`` makes the sem_seg train set the
    virtual-scan sampler."""
    task = MODEL_REGISTRY[args.model].task
    if task == "cls":
        if args.synthetic or args.data is None:
            from pointnet2_tpu_torch.data import SyntheticClassification

            def mk(seed):
                return SyntheticClassification(
                    num_classes=40, samples_per_class=args.synthetic_size,
                    npoints=args.num_point,
                    channels=6 if args.normal else 3,
                    batch_size=args.batch_size, seed=seed)
            return mk(0), mk(1), "cls_normals" if args.normal else "cls"
        if args.normal:
            from pointnet2_tpu_torch.data import ModelNetDataset

            train = None if test_only else ModelNetDataset(
                args.data, batch_size=args.batch_size,
                npoints=args.num_point, split="train", process_shard=shard)
            test = ModelNetDataset(args.data, batch_size=args.batch_size,
                                   npoints=args.num_point, split="test",
                                   process_shard=shard)
            return train, test, "cls_normals"
        from pointnet2_tpu_torch.data import ModelNetH5Dataset

        train = None if test_only else ModelNetH5Dataset(
            os.path.join(args.data, "train_files.txt"),
            batch_size=args.batch_size, npoints=args.num_point,
            process_shard=shard)
        test = ModelNetH5Dataset(os.path.join(args.data, "test_files.txt"),
                                 batch_size=args.batch_size,
                                 npoints=args.num_point, shuffle=False,
                                 process_shard=shard)
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
            batch_size=args.batch_size, process_shard=shard)
        test = PartNormalDataset(args.data, npoints=args.num_point,
                                 split="test", batch_size=args.batch_size,
                                 process_shard=shard)
        return train, test, "none"
    # sem_seg
    from pointnet2_tpu_torch.data import (
        ScannetDataset,
        ScannetDatasetVirtualScan,
    )

    train_cls = (ScannetDatasetVirtualScan
                 if getattr(args, "virtual_scan", False) else ScannetDataset)
    workers = getattr(args, "loader_workers", 2)  # cli.evaluate has none
    if args.synthetic or args.data is None:
        from pointnet2_tpu_torch.data import make_synthetic_scenes

        train = train_cls(scenes=make_synthetic_scenes(4),
                          npoints=args.num_point, split="train",
                          batch_size=args.batch_size,
                          num_workers=workers, process_shard=shard)
        test = ScannetDataset(scenes=make_synthetic_scenes(2, seed=9),
                              npoints=args.num_point, split="test",
                              batch_size=args.batch_size,
                              process_shard=shard)
        return train, test, "scannet"
    train = None if test_only else train_cls(
        root=args.data, npoints=args.num_point, split="train",
        batch_size=args.batch_size, num_workers=workers,
        process_shard=shard)
    test = ScannetDataset(root=args.data, npoints=args.num_point,
                          split="test", batch_size=args.batch_size,
                          process_shard=shard)
    return train, test, "scannet"


def whole_scene_dataset(args, shard=None):
    """The whole-scene tiler over the test scenes (the pickle root or the
    synthetic set), ``shard``'s share of them."""
    from pointnet2_tpu_torch.data import ScannetDatasetWholeScene

    if args.synthetic or args.data is None:
        from pointnet2_tpu_torch.data import make_synthetic_scenes

        return ScannetDatasetWholeScene(
            scenes=make_synthetic_scenes(2, seed=9), npoints=args.num_point,
            split="test", batch_size=args.batch_size, process_shard=shard)
    return ScannetDatasetWholeScene(root=args.data, npoints=args.num_point,
                                    split="test", batch_size=args.batch_size,
                                    process_shard=shard)


def parse_model_kwargs(args, task) -> dict:
    """--model_kwargs JSON (and --num_classes) -> model constructor kwargs,
    lists turned into tuples recursively, as the JAX package's (so the same
    flags give the same kwargs in train and evaluate). With --normal a
    classifier also gets ``in_channels=6``: the port builds its model before
    it sees a batch, where Flax infers the width from one."""
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
    if getattr(args, "normal", False) and task == "cls":
        model_kwargs.setdefault("in_channels", 6)
    return model_kwargs


def make_sem_seg_eval_protocol(args, test_ds):
    """Whole-scene + calibrated-voxel-accuracy best-checkpoint selection
    (scannet/train.py:167-174): the chopped evaluation on `test_ds`, the
    whole-scene one on the same scenes. On several ranks each scores its
    share of the scenes (the protocols sum their counters): under
    ``--num_devices`` the chopped set is rebuilt sharded, since the one the
    trainer cuts into rows is every rank's."""
    from pointnet2_tpu_torch.evaluation.scannet_eval import (
        make_scannet_eval_protocol,
    )

    local, shard = rank_shard(args, True)
    if shard is not None and not args.multihost:
        test_ds = make_datasets(local, test_only=True, shard=shard)[1]
    return make_scannet_eval_protocol(test_ds,
                                      whole_scene_dataset(local, shard),
                                      batch_size=local.batch_size)


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
    train(args)
    if multihost.process_count() > 1:
        launch.leave()


def run_rank(argv: list[str]) -> None:
    """One rank of ``--num_devices N`` (parallel.launch.spawn)."""
    train(build_parser().parse_args(argv))


def train(args) -> None:
    from pointnet2_tpu_torch.parallel.mesh import make_mesh
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    local, shard = rank_shard(args, args.multihost)
    train_ds, test_ds, augment = make_datasets(local, shard=shard)
    mesh = (make_mesh(args.num_devices, args.device, host_sharded=True)
            if shard is not None else None)
    task = MODEL_REGISTRY[args.model].task
    eval_every = args.eval_every
    if eval_every is None:
        eval_every = 5 if task == "sem_seg" else 1
    config = TrainConfig(
        model=args.model, num_point=args.num_point,
        batch_size=args.batch_size, max_epoch=args.max_epoch,
        learning_rate=args.learning_rate, momentum=args.momentum,
        optimizer=args.optimizer, decay_step=args.decay_step,
        decay_rate=args.decay_rate, augment=augment,
        num_devices=args.num_devices, log_dir=args.log_dir,
        eval_every=eval_every, compute_dtype=args.dtype,
        watchdog_secs=args.watchdog_secs, remat=args.remat,
        steps_per_call=args.steps_per_call,
        model_kwargs=parse_model_kwargs(args, task))
    with Trainer(config, device=args.device, mesh=mesh) as trainer:
        trainer.log(f"config: {vars(args)}")
        eval_protocol = None
        if task == "sem_seg" and not args.no_whole_scene_eval:
            eval_protocol = make_sem_seg_eval_protocol(args, test_ds)
        trainer.fit(train_ds, eval_dataset=test_ds,
                    eval_protocol=eval_protocol)


if __name__ == "__main__":
    main()
