"""The trainer: one host loop of train epochs, evaluation and checkpoints.

Port of pointnet2_tpu/train/trainer.py for every task of the registry
(``cls``, ``part_seg``, ``part_seg_one_hot``, ``sem_seg``; the dataset
yields the task's keys, see train/steps.py): ``TrainConfig`` keeps the JAX
package's field names and defaults (``pointnet2_cls_ssg`` defaults: batch
16, 1024 points, Adam at 1e-3 on the clipped staircase LR, BN momentum 0.5
-> 0.99).

Data parallelism (``num_devices``, JAX trainer.py:81-119,190-246): the
trainer runs as one rank of a mesh (parallel/mesh.py), one process a rank
as ``parallel.launch.spawn`` or torchrun start them; ``num_devices`` must
be the process group's size (without a group, None or 1). The device is
the rank's card. ``batch_size`` is the global batch: each host batch is
cut to the rank's rows (``shard_batch``), unless the mesh is
``host_sharded`` and the data set already yields them (``process_shard``,
``--multihost``). The parameters are broadcast from rank 0, the epoch
length is the ranks' least batch count, eval counts are summed over the
ranks, and only the primary writes logs, metrics and checkpoints. Every
rank's generator draws for the global batch, so all of them stay equal and
one checkpoint resumes every rank exactly.

``steps_per_call=K`` trains K batches a call of ``TrainMultiStep`` (on the
card one CUDA graph replay of K steps, captured at the first call; the
epoch's remainder as single steps), bit for bit what K single steps give.
``remat`` checkpoints the model forward (``steps.REMAT_POLICIES``).
``watchdog_secs`` arms a stall watchdog (train/watchdog.py) for ``fit``:
it is beaten after every call of the step and every eval batch, and exits
the process with 75 when no beat lands in time (``cli.supervise`` restarts
the run, which resumes from its checkpoint).

``Trainer(config, device="cuda")`` runs on the card; without one it raises
unless ``device="cpu"`` is passed, which runs the plain PyTorch versions of
the kernels. Host batches are loaded ``config.prefetch`` ahead on a
background thread. Each run writes ``config.json`` (never overwritten),
``log_train.txt`` and ``metrics.jsonl`` into ``log_dir``, and checkpoints
(train/checkpoint.py): ``best`` when the eval score improves, ``ckpt``
every ``ckpt_every_epochs`` epochs and after the last. ``fit`` resumes
from ``ckpt`` when ``log_dir`` holds one: model, optimizer, step and the
trainer's generator, so an interrupted run ends where the uninterrupted
one does, bit for bit. ``eval_protocol(trainer, state, epoch) -> score``
replaces the eval accuracy as the best-checkpoint score (the ScanNet
protocol, evaluation/scannet_eval.py).

Usage::

    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.serving import Predictor
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    ds = SyntheticClassification(num_classes=40, npoints=1024,
                                 batch_size=16)
    with Trainer(TrainConfig(augment="cls", max_epoch=10,
                             steps_per_call=4)) as trainer:
        state = trainer.fit(ds, eval_dataset=ds)  # rerun: resumes
    pred = Predictor.from_checkpoint("pointnet2_cls_ssg", "log",
                                     num_point=1024, name="best")

    # semantic segmentation on ScanNet crops with the wdp input dropout,
    # best checkpoint by the whole-scene calibrated voxel accuracy
    from pointnet2_tpu_torch.data.scannet import (
        ScannetDataset, ScannetDatasetWholeScene, make_synthetic_scenes)
    from pointnet2_tpu_torch.evaluation import make_scannet_eval_protocol

    rooms = ScannetDataset(scenes=make_synthetic_scenes(), batch_size=16)
    test = ScannetDataset(scenes=make_synthetic_scenes(2, seed=9),
                          split="test", batch_size=16)
    whole = ScannetDatasetWholeScene(scenes=make_synthetic_scenes(2, seed=9),
                                     split="test")
    cfg = TrainConfig(model="pointnet2_sem_seg", num_point=8192,
                      augment="scannet", max_epoch=10)
    with Trainer(cfg) as trainer:
        state = trainer.fit(rooms, eval_dataset=test,
                            eval_protocol=make_scannet_eval_protocol(
                                test, whole))
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pointnet2_tpu_torch.evaluation.lockstep import lockstep_batches
from pointnet2_tpu_torch.models import get_spec
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.parallel.mesh import (
    local_rows,
    make_mesh,
    replicate,
    shard_batch,
)
from pointnet2_tpu_torch.train import checkpoint as ckpt
from pointnet2_tpu_torch.train.schedules import (
    bn_momentum_schedule,
    exponential_decay_clipped,
)
from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.train.steps import (
    AUGMENTATIONS,
    TrainMultiStep,
    check_remat,
    eval_counts,
    model_inputs,
    run_one_step,
)
from pointnet2_tpu_torch.train.watchdog import Watchdog
from pointnet2_tpu_torch.utils.prefetch import Prefetcher
from pointnet2_tpu_torch.utils.profiling import span


@dataclass
class TrainConfig:
    model: str = "pointnet2_cls_ssg"
    num_point: int = 1024
    batch_size: int = 16  # global batch, split across the ranks
    max_epoch: int = 251
    learning_rate: float = 1e-3
    momentum: float = 0.9
    optimizer: str = "adam"
    decay_step: int = 200000
    decay_rate: float = 0.7
    bn_init_decay: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_clip: float = 0.99
    augment: str = "none"  # none | cls | cls_normals | scannet (device)
    host_augment: bool = False  # the dataset's numpy augmentation instead
    steps_per_call: int = 1  # K batches a call of the step (a CUDA graph)
    num_devices: int | None = None  # ranks of the data-parallel mesh
    log_dir: str = "log"
    ckpt_every_epochs: int = 10
    eval_every: int = 1  # epochs between evals
    prefetch: int = 2  # host batches loaded ahead of the step
    seed: int = 0
    compute_dtype: str = "float32"  # float32 | bfloat16 (params stay f32)
    model_kwargs: dict = field(default_factory=dict)
    # stall watchdog (train/watchdog.py): exit 75 when no step or eval
    # batch completes for this many seconds (None: off)
    watchdog_secs: float | None = None
    remat: str = "none"  # none | full | dots | dots_nobatch (steps.py)


def _check_config(cfg: TrainConfig) -> None:
    if cfg.augment not in AUGMENTATIONS:
        raise NotImplementedError(
            f"augment={cfg.augment!r} is not ported; ported: "
            f"{sorted(AUGMENTATIONS)}")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype!r}")
    check_remat(cfg.remat)
    if cfg.steps_per_call < 1:
        raise ValueError(f"steps_per_call must be at least 1, got "
                         f"{cfg.steps_per_call}")


class Trainer:
    """Train-epoch / eval-epoch / fit loop around ``run_one_step``."""

    def __init__(self, config: TrainConfig, device="cuda", mesh=None):
        _check_config(config)
        self.mesh = mesh if mesh is not None else make_mesh(
            config.num_devices, device)
        if config.num_devices not in (None, self.mesh.size):
            raise ValueError(f"num_devices={config.num_devices} on a mesh "
                             f"of {self.mesh.size} ranks")
        if config.batch_size % self.mesh.size:
            raise ValueError(f"global batch {config.batch_size} not "
                             f"divisible by {self.mesh.size} ranks")
        self.device = self.mesh.device
        self.config = config
        spec = get_spec(config.model)
        self.task = spec.task
        self.model_cls = spec.cls
        self.loss_fn = spec.loss
        self.model_kwargs = dict(config.model_kwargs)
        if config.compute_dtype == "bfloat16":
            self.model_kwargs.setdefault("dtype", torch.bfloat16)
        self.lr_schedule = exponential_decay_clipped(
            config.learning_rate, config.batch_size, config.decay_step,
            config.decay_rate)
        self.bn_schedule = bn_momentum_schedule(
            config.batch_size, config.decay_step, config.bn_init_decay,
            config.bn_decay_rate, config.bn_decay_clip)
        self.augment_fn = AUGMENTATIONS[config.augment]
        # augmentation parameters and dropout masks, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        os.makedirs(config.log_dir, exist_ok=True)
        # only the primary writes the shared log dir (several ranks
        # appending to one file tear each other's lines)
        primary = multihost.is_primary()
        if primary:
            self._snapshot_sources()
        self._log_file = open(os.path.join(config.log_dir, "log_train.txt")
                              if primary else os.devnull, "a")
        self._metrics_file = open(
            os.path.join(config.log_dir, "metrics.jsonl")
            if primary else os.devnull, "a")
        self.best_score = -float("inf")
        self._multi: TrainMultiStep | None = None  # K steps on one state
        self._watchdog: Watchdog | None = None  # armed by fit()

    def _snapshot_sources(self) -> None:
        """The model's source file and the run's config.json (written once,
        so a rerun in the same log_dir keeps the first record)."""
        cfg = self.config
        src = inspect.getsourcefile(self.model_cls)
        if src and os.path.isfile(src):
            shutil.copyfile(src, os.path.join(cfg.log_dir,
                                              os.path.basename(src)))
        cfg_path = os.path.join(cfg.log_dir, "config.json")
        if not os.path.exists(cfg_path):
            with open(cfg_path, "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    def close(self) -> None:
        self._log_file.close()
        self._metrics_file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def log(self, msg: str) -> None:
        if multihost.is_primary():
            print(msg, flush=True)
            self._log_file.write(msg + "\n")
            self._log_file.flush()

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    def log_metrics(self, **kv: Any) -> None:
        self._metrics_file.write(json.dumps(kv) + "\n")
        self._metrics_file.flush()

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh model (Xavier-uniform dense weights from ``seed``, on the
        device, in train mode; rank 0's on every rank) and optimizer, at
        step 0."""
        model = replicate(self.mesh, self.model_cls(
            device=self.device, seed=self.config.seed,
            **self.model_kwargs).train())
        opt = make_optimizer(self.config.optimizer, model.parameters(),
                             self.lr_schedule, self.config.momentum)
        return TrainState(step=0, model=model, optimizer=opt)

    @staticmethod
    def _host_view(batch: dict) -> dict:
        """A host batch in the step's layout: every key but ``nvalid``
        (integer arrays as int64: ``label``, ``seg``, ``cls_label``; the
        rest as f32: ``points``, ``smpw``), and ``nvalid`` as a validity
        ``mask`` so the padded rows of a final batch drop out of the loss
        and counts."""
        bsz = batch["points"].shape[0]
        out = {"mask": (np.arange(bsz) < batch["nvalid"]).astype(np.float32)}
        for k, v in batch.items():
            if k == "nvalid":
                continue
            v = np.asarray(v)
            out[k] = np.ascontiguousarray(
                v, np.float32 if np.issubdtype(v.dtype, np.floating)
                else np.int64)
        return out

    def _to_device(self, batch: dict) -> dict:
        """Upload this rank's rows of a host batch in the step's layout
        (:meth:`_host_view`)."""
        return shard_batch(self.mesh, self._host_view(batch))

    def multi_step(self, state: TrainState) -> TrainMultiStep:
        """The K-steps-a-call step on ``state``, made once per state (a CUDA
        graph holds the state's tensors)."""
        if self._multi is None or self._multi.state is not state:
            self._multi = TrainMultiStep(
                state, self.loss_fn, self.bn_schedule, self.augment_fn,
                self.generator, self.task, self.config.remat, self.mesh)
        return self._multi

    def train_epoch(self, state: TrainState, dataset, epoch: int):
        """One epoch: K = ``steps_per_call`` batches a call of the K-step
        step, the remainder (fewer than K) as single steps, as JAX's
        buffer-and-flush loop (trainer.py:208-246). While a profiler
        records, the epoch's spans (utils/profiling.py) name its parts:
        ``trainer.epoch`` (counts ``steps``, ``examples``),
        ``trainer.sync_batches`` (the ranks agree on the batch count),
        ``trainer.batch_wait`` (each wait for the next host batch, count
        ``blocked`` when none was ready), ``step.stage`` (a call's K
        batches in the step's layout, count ``batches``), ``step.eager``
        (a remainder step, its upload included) and ``trainer.epoch_end``
        (the read-back of the losses, and the log)."""
        with span("trainer.epoch") as epoch_span:
            losses, accs, n = [], [], 0
            K = self.config.steps_per_call
            buf: list[dict] = []

            def flush():
                if len(buf) == K and K > 1:
                    with span("step.stage", batches=K):
                        views = [local_rows(self.mesh, self._host_view(b))
                                 for b in buf]
                    metrics = self.multi_step(state)(views)
                    losses.append(metrics["loss"])
                    accs.append(metrics["accuracy"])
                else:
                    for b in buf:
                        with span("step.eager"):
                            metrics = run_one_step(
                                state, self._to_device(b), self.loss_fn,
                                self.bn_schedule, self.augment_fn,
                                self.generator, self.task,
                                remat=self.config.remat, mesh=self.mesh)
                        losses.append(metrics["loss"].reshape(1))
                        accs.append(metrics["accuracy"].reshape(1))
                buf.clear()
                self._beat()

            with span("trainer.sync_batches"):
                num_steps = multihost.sync_num_batches(
                    dataset.num_batches(), "min")
            loader = Prefetcher(
                dataset.epoch(augment=self.config.host_augment),
                depth=self.config.prefetch)
            t0 = time.time()
            steps = 0
            try:
                # no batch is asked of the loader past num_steps: every
                # rank runs the same number of steps
                for _ in range(num_steps):
                    with span("trainer.batch_wait",
                              blocked=int(loader.waiting())):
                        batch = next(loader, None)
                    if batch is None:
                        break
                    steps += 1
                    n += batch["nvalid"]
                    buf.append(batch)
                    if len(buf) == K:
                        flush()
                flush()
            finally:
                loader.close()
            epoch_span.add(steps=steps, examples=int(n))
            with span("trainer.epoch_end"):
                # one device->host fetch per epoch, not one per step
                loss = (float(torch.cat(losses).mean()) if losses
                        else float("nan"))
                acc = (float(torch.cat(accs).mean()) if accs
                       else float("nan"))
                dt = time.time() - t0
                self.log(f"epoch {epoch}: train loss {loss:.4f} acc "
                         f"{acc:.4f} ({n / max(dt, 1e-9):.1f} ex/s)")
                self.log_metrics(
                    epoch=epoch, split="train", loss=loss, accuracy=acc,
                    examples_per_sec=n / max(dt, 1e-9), step=state.step,
                    learning_rate=float(self.lr_schedule(state.step)),
                    bn_momentum=float(self.bn_schedule(state.step)))
        return state

    def eval_epoch(self, state: TrainState, dataset, epoch: int) -> float:
        """Accuracy and avg-class accuracy (over the classes present) of
        the eval-mode model, padded rows excluded; per point for the
        segmentation tasks. The ranks run the same number of batches (zero
        batches pad the short ones) and sum their counts."""
        loader = Prefetcher(lockstep_batches(dataset, multihost),
                            depth=self.config.prefetch)
        counts = []
        try:
            for b in loader:
                counts.append(eval_counts(state.model, self._to_device(b),
                                          self.task, self.mesh))
                self._beat()
        finally:
            loader.close()
            state.model.train()
        if counts:
            correct, total, cls_c, cls_t = (torch.stack(c).sum(0).cpu()
                                             for c in zip(*counts))
            correct, total = float(correct), float(total)
            cls_c, cls_t = cls_c.numpy(), cls_t.numpy()
        else:
            correct = total = 0.0
            cls_c = cls_t = np.zeros(1)
        acc = correct / max(total, 1.0)
        present = cls_t > 0
        avg_cls = (float(np.mean(cls_c[present] / cls_t[present]))
                   if present.any() else 0.0)
        self.log(f"epoch {epoch}: eval accuracy {acc:.4f}")
        self.log(f"epoch {epoch}: eval avg class acc {avg_cls:.4f}")
        self.log_metrics(epoch=epoch, split="eval", accuracy=acc,
                         avg_class_accuracy=avg_cls)
        return acc

    def eval_logits_fn(self, state: TrainState):
        """Host batch -> numpy float32 logits of the eval-mode model, for
        the protocols that need raw logits (votes, ScanNet). The batch
        gives ``points`` (and ``cls_label`` for ``part_seg_one_hot``);
        the model is back in train mode after each call. The forward is
        this rank's alone (no collective): on several ranks each protocol
        scores the rank's own data and sums its counters over the ranks."""
        model = state.model

        def fn(batch: dict) -> np.ndarray:
            db = {"points": torch.from_numpy(
                np.asarray(batch["points"], np.float32)).to(self.device)}
            if self.task == "part_seg_one_hot":
                db["cls_label"] = torch.from_numpy(
                    np.asarray(batch["cls_label"])).long().to(self.device)
            model.eval()
            try:
                with torch.inference_mode():
                    out = model(*model_inputs(db, self.task)).float(
                        ).cpu().numpy()
            finally:
                model.train()
            self._beat()  # a protocol can outlast the watchdog
            return out

        return fn

    def maybe_restore(self, state: TrainState):
        """(state, meta): ``state`` restored from ``log_dir``'s ``ckpt``
        with the trainer's generator, and the checkpoint's sidecar record;
        meta is None (and state untouched) when there is none."""
        meta = ckpt.load_meta(self.config.log_dir)
        if meta is not None:
            state = ckpt.restore_checkpoint(self.config.log_dir, state,
                                            generator=self.generator)
            self.log(f"restored checkpoint at step {state.step} "
                     f"(epoch {meta.get('epoch')})")
        return state, meta

    def _save(self, state: TrainState, **kw) -> str:
        return ckpt.save_checkpoint(self.config.log_dir, state,
                                    generator=self.generator, **kw)

    # ------------------------------------------------------------------
    def fit(self, train_dataset, eval_dataset=None,
            max_epoch: int | None = None, eval_protocol=None) -> TrainState:
        """Train to ``max_epoch`` epochs (the config's by default) from a
        fresh state, or from ``log_dir``'s checkpoint at its epoch.

        Evaluates every ``eval_every`` epochs and after the last, by
        ``eval_protocol(trainer, state, epoch) -> score`` when given, else
        by the eval accuracy on ``eval_dataset``; a better score than the
        best so far (kept in ``best_score``; on a resume, seeded from the
        best checkpoint's sidecar) writes the ``best`` checkpoint with it.
        Writes ``ckpt`` every ``ckpt_every_epochs`` epochs and after the
        last. Returns the final state; its ``model.state_dict()`` loads
        into ``Predictor``. With ``watchdog_secs`` set, a stall watchdog
        runs for the call and is closed however it ends."""
        max_epoch = max_epoch or self.config.max_epoch
        if self.config.watchdog_secs:
            self._watchdog = Watchdog(self.config.watchdog_secs,
                                      log_fn=self.log)
        try:
            return self._fit(train_dataset, eval_dataset, max_epoch,
                             eval_protocol)
        finally:
            # an exception must not leave an armed watchdog behind to exit
            # a caller that caught the error and moved on
            if self._watchdog is not None:
                self._watchdog.close()
                self._watchdog = None

    def _fit(self, train_dataset, eval_dataset, max_epoch: int,
             eval_protocol) -> TrainState:
        # restore before the K-step step is made: its CUDA graph holds the
        # state's tensors
        state, meta = self.maybe_restore(self.init_state())
        if meta is None:
            start_epoch = 0
        elif meta.get("epoch") is not None:
            start_epoch = int(meta["epoch"])
        else:  # a checkpoint without its sidecar: derive the epoch
            start_epoch = state.step // max(train_dataset.num_batches(), 1)
        # only a resumed run inherits the best score: a fresh run in a
        # reused log_dir may overwrite a stale best checkpoint
        self.best_score = -float("inf")
        if meta is not None:
            best_meta = ckpt.load_meta(self.config.log_dir, name="best")
            if best_meta is not None and best_meta.get("score") is not None:
                self.best_score = float(best_meta["score"])
        every = max(1, self.config.eval_every)
        want_eval = eval_dataset is not None or eval_protocol is not None
        for epoch in range(start_epoch, max_epoch):
            state = self.train_epoch(state, train_dataset, epoch)
            if want_eval and (epoch % every == 0 or epoch == max_epoch - 1):
                if eval_protocol is not None:
                    score = eval_protocol(self, state, epoch)
                else:
                    score = self.eval_epoch(state, eval_dataset, epoch)
                if score > self.best_score:
                    self.best_score = score
                    self._save(state, name="best", epoch=epoch + 1,
                               score=score)
                    self.log(f"epoch {epoch}: new best score {score:.4f}")
            if (epoch + 1) % self.config.ckpt_every_epochs == 0:
                path = self._save(state, epoch=epoch + 1)
                self.log(f"saved checkpoint to {path}")
        if start_epoch < max_epoch:
            path = self._save(state, epoch=max_epoch)
            self.log(f"saved final checkpoint to {path}")
        return state
