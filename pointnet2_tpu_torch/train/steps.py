"""The data-parallel train step and the eval count step.

Port of pointnet2_tpu/train/steps_body.py:19-136 and train/steps.py:41-46,
127-185, for every task of the registry, on one rank of a mesh
(parallel/mesh.py) or on one device:

- ``run_one_step``: on-device augmentation, the BN momentum of the current
  step, the train-mode forward (batch-statistics BN, dropout), the loss
  (masked by ``batch["mask"]`` when present: num / max(den, 1e-8)), the
  backward, the optimizer update, ``step += 1``. The augmentation's
  parameters and the dropout masks come from one ``torch.Generator`` on the
  device, in that order.
- ``eval_counts``: correct, total and per-class counts of an eval-mode
  forward, masked, for accuracy and avg-class accuracy (per point for the
  segmentation tasks).

The task decides the batch's keys (``steps_body.py:19-53``): ``cls``
reads ``label`` (B,); ``part_seg`` reads ``seg`` (B, N);
``part_seg_one_hot`` also passes ``cls_label`` (B,) to the model;
``sem_seg`` reads ``seg`` and the per-point weights ``smpw`` (B, N). A
per-example ``mask`` (B,) is broadcast over the points.

Both take batches of tensors already on the model's device; the returned
metrics stay there too (no host sync inside a step).

On a mesh of several ranks (JAX's ``shard_map`` step; each rank holds its
rows of the global batch) the step runs its forward and backward under
``nn.layers.cross_replica``: BN statistics and the fused chain's totals are
averaged over the ranks, and the augmentation and dropout draw for the
global batch from generators that stay in step on every rank. A masked
batch's valid count ``den`` is averaged before ``num / max(den, 1e-8)``
(a rank may hold only padding, steps_body.py:101-115); the gradients are
averaged after the backward by one all-reduce of a flat float32 buffer
(not DDP, whose reducer hooks a CUDA graph does not capture), and the loss
and accuracy are averaged too. ``eval_counts`` sums its counts over the
ranks. The step then equals one process's step on the global batch up to
the collectives' summation order.

Two switches of the JAX package's step (steps.py:91-125, steps_body.py:
56-67,118-121) are ported here:

- ``TrainMultiStep`` runs K steps a call (``TrainConfig.steps_per_call``).
  On the card it holds one ``torch.cuda.CUDAGraph`` of K whole steps for
  each K (and batch layout), captured at its first call and replayed after
  one pinned host-to-device copy of the K batches and their per-step
  scalars; on the CPU it runs K eager steps. Either way the K steps equal
  K calls of ``run_one_step`` bit for bit: the graph reads the step's
  scalars (BN momentum, -lr, Adam's bias corrections) from a buffer
  filled for each replay, and the trainer's generator is registered with
  the graph, so each replay draws the augmentation and dropout masks that
  K eager steps would. A capture that fails raises.
- ``REMAT_POLICIES`` (``TrainConfig.remat``): the model forward under
  ``torch.utils.checkpoint``. ``full`` saves nothing inside the model;
  ``dots`` saves the outputs of ``mm``, ``addmm``, ``bmm`` and ``baddbmm``,
  ``dots_nobatch`` those of ``mm`` and ``addmm`` (selective checkpointing);
  everything else, the CUDA kernels too, is recomputed in the backward.
  The recompute replays the forward's dropout masks and skips BN's running
  update (``nn.layers.RematTape``), so every policy equals ``none`` bit for
  bit.

On a mesh the graph captures the step's collectives, which needs NCCL: the
eager warm-up step runs each of them once, so that NCCL's communicator
exists before the capture. A group of another backend on the card raises
(gloo's collectives synchronise with the host and cannot be captured).
"""

from __future__ import annotations

import functools
import time
from collections.abc import Callable

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.data.augment_device import (
    augment_cls,
    augment_cls_normals,
    augment_scannet,
)
from pointnet2_tpu_torch.nn.layers import RematTape, cross_replica, remat_tape
from pointnet2_tpu_torch.parallel.mesh import collective
from pointnet2_tpu_torch.train.state import TrainState, upload_scalars
from pointnet2_tpu_torch.utils.profiling import span

AUGMENTATIONS: dict[str, Callable | None] = {
    "none": None,
    "cls": augment_cls,
    "cls_normals": augment_cls_normals,
    "scannet": augment_scannet,
}


def model_inputs(batch: dict, task: str) -> tuple:
    """Positional model inputs of a task."""
    if task == "part_seg_one_hot":
        return batch["points"], batch["cls_label"]
    return (batch["points"],)


def loss_args(batch: dict, task: str) -> tuple:
    """The loss's arguments after the logits."""
    if task == "cls":
        return (batch["label"],)
    if task in ("part_seg", "part_seg_one_hot"):
        return (batch["seg"],)
    if task == "sem_seg":
        return batch["seg"], batch["smpw"]
    raise ValueError(f"unknown task {task!r}; known: cls, part_seg, "
                     "part_seg_one_hot, sem_seg")


def accuracy(logits: torch.Tensor, batch: dict, task: str = "cls",
             mesh=None) -> torch.Tensor:
    """Mean of argmax == target (``label`` for cls, else ``seg`` per
    point), over the rows (and their points) with mask 1 when a mask is
    given (steps_body.py:36-53). On a mesh the valid count is averaged over
    the ranks, so that the caller's average of the ranks' accuracies is
    the global batch's."""
    target = batch["label"] if task == "cls" else batch["seg"]
    hit = (logits.argmax(-1) == target).float()
    mask = batch.get("mask")
    if mask is None:
        return hit.mean()
    while mask.dim() < hit.dim():
        mask = mask[..., None]
    num = (hit * mask).sum()
    den = mask.expand_as(hit).sum()
    if collective(mesh) is not None:
        den = mesh.mean(den)
    return num / torch.clamp_min(den, 1e-8)


_A = torch.ops.aten
# the ops whose outputs a policy saves; None saves everything (no remat),
# "full" nothing inside the model
REMAT_POLICIES: dict[str, object] = {
    "none": None,
    "full": "full",
    "dots": (_A.mm.default, _A.addmm.default, _A.bmm.default,
             _A.baddbmm.default),
    "dots_nobatch": (_A.mm.default, _A.addmm.default),
}


def check_remat(remat: str) -> None:
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; known: "
                         f"{sorted(REMAT_POLICIES)}")


def _forward(model, inputs: tuple, momentum, generator, remat: str):
    """The train-mode forward, under ``remat``'s checkpoint policy."""
    check_remat(remat)
    policy = REMAT_POLICIES[remat]
    if policy is None:
        return model(*inputs, bn_momentum=momentum, generator=generator)
    tape, runs = RematTape(), [0]

    def fwd(*xs):
        runs[0] += 1  # the second run is the recompute in the backward
        with remat_tape(tape, replaying=runs[0] > 1):
            return model(*xs, bn_momentum=momentum, generator=generator)

    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if policy != "full":
        def save(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in policy
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, save)
    return ckpt.checkpoint(fwd, *inputs, **kw)


def step_scalars(state: TrainState, bn_momentum_fn: Callable,
                 ahead: int = 0) -> np.ndarray:
    """The float32 scalars of the step ``ahead`` steps after ``state``'s:
    [BN momentum at the step, *the optimizer's ``host_scalars``]."""
    return np.concatenate([
        [np.float32(bn_momentum_fn(state.step + ahead))],
        state.optimizer.host_scalars(state.optimizer.count + ahead),
    ]).astype(np.float32)


def average_gradients(mesh, params) -> None:
    """Each parameter's gradient replaced by its average over the ranks:
    one all-reduce of every gradient packed into one flat float32 buffer."""
    grads = [p.grad for p in params]
    flat = mesh.mean(torch.cat([g.reshape(-1) for g in grads]))
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def run_one_step(state: TrainState, batch: dict, loss_fn: Callable,
                 bn_momentum_fn: Callable, augment_fn: Callable | None = None,
                 generator: torch.Generator | None = None,
                 task: str = "cls", remat: str = "none",
                 scalars: torch.Tensor | None = None, mesh=None) -> dict:
    """One forward/backward/optimizer step, in place on ``state``.

    batch: ``points`` (B, N, C) f32, the task's targets (module doc),
    optional ``mask`` (B,) f32 of valid rows; on a mesh of several ranks
    this rank's rows of the global batch. ``scalars``: the step's
    ``step_scalars`` on the device (None uploads them). Returns {"loss",
    "accuracy"} as 0-dim tensors on the device, averaged over the ranks."""
    model, opt = state.model, state.optimizer
    mesh = collective(mesh)
    if scalars is None:
        scalars = upload_scalars(step_scalars(state, bn_momentum_fn),
                                 batch["points"].device)
    model.train()
    # the backward too: a checkpointed forward runs again inside it
    with cross_replica(mesh):
        if augment_fn is not None:
            batch = dict(batch, points=augment_fn(generator, batch["points"]))
        logits = _forward(model, model_inputs(batch, task), scalars[0],
                          generator, remat)
        # `mask` zeroes the duplicated rows of a padded final batch out of
        # the loss and gradients; BN batch statistics still see them. A
        # batch whose every weight is zero gives num = 0 and a loss of 0.
        mask = batch.get("mask")
        if mask is None:
            loss = loss_fn(logits, *loss_args(batch, task))
        else:
            num, den = loss_fn(logits, *loss_args(batch, task),
                               sample_weight=mask, sum_count=True)
            if mesh is not None:
                # the mean valid count a rank: the ranks' average of
                # num / den is then the global masked mean
                den = mesh.mean(den)
            loss = num / torch.clamp_min(den, 1e-8)
        opt.zero_grad()
        loss.backward()
    acc = accuracy(logits.detach(), batch, task, mesh)
    loss = loss.detach()
    if mesh is not None:
        average_gradients(mesh, opt.params)
        loss, acc = mesh.mean(torch.stack([loss, acc])).unbind(0)
    opt.step(scalars[1:])
    state.step += 1
    return {"loss": loss, "accuracy": acc}


class TrainMultiStep:
    """K train steps a call on ``state`` (JAX's make_train_multi_step).

    ``step(batches)`` takes K host batches, dicts of numpy arrays in the
    device layout (float32 ``points`` and ``mask``, int64 targets), and
    returns {"loss", "accuracy"} as (K,) tensors on the device. On the card
    the first call with a given K and batch layout captures a CUDA graph of
    K calls of ``run_one_step`` (after one eager warm-up step on a side
    stream, with every tensor of the state, its counts and the generator
    put back afterwards, and no host sync allowed in it), and every call
    replays it. The kernel wrappers' launch counters count each replay's
    launches, as recorded at capture. On the CPU the K steps run eagerly.
    The graph reads the state's tensors where they are at capture: restore
    a checkpoint before the first call.

    Spans (utils/profiling.py, while a profiler records): ``step.capture``
    (warm-up and capture), ``step.stage`` (the batches through pinned
    memory into the graph's buffers; the caller's own ``step.stage``
    counts the batches) and ``step.replay`` (count ``steps``, K)."""

    def __init__(self, state: TrainState, loss_fn: Callable,
                 bn_momentum_fn: Callable, augment_fn: Callable | None = None,
                 generator: torch.Generator | None = None, task: str = "cls",
                 remat: str = "none", mesh=None):
        self.state = state
        self.step_args = (loss_fn, bn_momentum_fn, augment_fn, generator,
                          task, remat)
        self.generator = generator
        self.mesh = collective(mesh)
        self.device = next(state.model.parameters()).device
        if self.device.type == "cuda" and self.mesh is not None:
            backend = torch.distributed.get_backend(self.mesh.group)
            if "nccl" not in backend:
                raise RuntimeError(
                    f"a CUDA graph of a data-parallel step captures its "
                    f"collectives, which needs NCCL; the group is "
                    f"{backend!r} (steps_per_call=1 runs eager steps)")
        self.graphs: dict = {}  # (K, layout) -> _Graphed
        self.capture_s: dict = {}  # (K, layout) -> seconds to capture

    def _one(self, batch: dict, scalars=None) -> dict:
        return run_one_step(self.state, batch, *self.step_args[:5],
                            remat=self.step_args[5], scalars=scalars,
                            mesh=self.mesh)

    def __call__(self, batches: list[dict]) -> dict:
        if self.device.type != "cuda":
            out = [self._one({k: torch.from_numpy(v) for k, v in b.items()})
                   for b in batches]
            return {k: torch.stack([o[k] for o in out])
                    for k in ("loss", "accuracy")}
        key = (len(batches), tuple((k, v.shape, v.dtype.str)
                                   for k, v in sorted(batches[0].items())))
        graphed = self.graphs.get(key)
        if graphed is None:
            t0 = time.perf_counter()
            with span("step.capture"):
                graphed = self.graphs[key] = _Graphed(self, batches)
            self.capture_s[key] = time.perf_counter() - t0
        return graphed.replay(batches)

    def scalars(self, K: int) -> np.ndarray:
        """(K, S) float32: the scalars of the state's next K steps."""
        return np.stack([step_scalars(self.state, self.step_args[1], i)
                         for i in range(K)])

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor a step changes: parameters, buffers, moments."""
        opt = self.state.optimizer
        return [*self.state.model.parameters(), *self.state.model.buffers(),
                *(t for k in opt.MOMENTS for t in getattr(opt, k))]


class _Graphed:
    """One CUDA graph of K steps, its static input buffers and outputs."""

    def __init__(self, owner: TrainMultiStep, batches: list[dict]):
        self.owner = owner
        K, dev = len(batches), owner.device
        self.inputs = {k: torch.empty((K, *v.shape), device=dev,
                                      dtype=torch.from_numpy(v).dtype)
                       for k, v in batches[0].items()}
        self.scalars = torch.empty(owner.scalars(K).shape,
                                   dtype=torch.float32, device=dev)
        self.load(batches)
        self.warm_up()
        self.graph = torch.cuda.CUDAGraph()
        if owner.generator is not None:
            self.graph.register_generator_state(owner.generator)
        state, opt = owner.state, owner.state.optimizer
        counts = {k: w.launches for k, w in ops.KERNELS.items()}
        step, count = state.step, opt.count
        try:
            with torch.cuda.graph(self.graph):
                out = [owner._one({k: v[i] for k, v in self.inputs.items()},
                                  self.scalars[i]) for i in range(K)]
                self.loss = torch.stack([o["loss"] for o in out])
                self.accuracy = torch.stack([o["accuracy"] for o in out])
        finally:
            # a capture runs nothing: the counts and steps stay put
            state.step, opt.count = step, count
            self.launches = {k: w.launches - counts[k]
                             for k, w in ops.KERNELS.items()}
            for k, w in ops.KERNELS.items():
                w.launches = counts[k]

    def load(self, batches: list[dict]) -> None:
        """The K batches and the next K steps' scalars into the graph's
        buffers: through pinned memory, without waiting on the card."""
        for k, buf in self.inputs.items():
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            np.stack([b[k] for b in batches], out=host.numpy())
            buf.copy_(host, non_blocking=True)
        self.scalars.copy_(upload_scalars(self.owner.scalars(len(batches)),
                                          self.scalars.device))

    def warm_up(self) -> None:
        """One eager step on a side stream (the kernels' first launches set
        their shared-memory attributes there), with no host sync allowed;
        then every tensor, count and the generator as they were."""
        owner = self.owner
        state, opt, gen = owner.state, owner.state.optimizer, owner.generator
        saved = [t.detach().clone() for t in owner.tensors()]
        step, count = state.step, opt.count
        gen_state = gen.get_state() if gen is not None else None
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(owner.device)
        side.wait_stream(main)
        prev = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                owner._one({k: v[0] for k, v in self.inputs.items()},
                           self.scalars[0])
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        main.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(owner.tensors(), saved):
                t.copy_(s)
        state.step, opt.count = step, count
        if gen is not None:
            gen.set_state(gen_state)

    def replay(self, batches: list[dict]) -> dict:
        K = len(batches)
        with span("step.stage"):
            self.load(batches)
        with span("step.replay", steps=K):
            self.graph.replay()
        self.owner.state.step += K
        self.owner.state.optimizer.count += K
        for k, n in self.launches.items():
            ops.KERNELS[k].launches += n
        return {"loss": self.loss.clone(), "accuracy": self.accuracy.clone()}


@torch.inference_mode()
def eval_counts(model: torch.nn.Module, batch: dict, task: str = "cls",
                mesh=None):
    """(correct, total, per_class_correct (K,), per_class_total (K,)) of an
    eval forward, rows weighted by ``batch["mask"]`` (train/steps.py:
    127-170); for the segmentation tasks every point of a row counts. On a
    mesh, summed over the ranks (one all-reduce of the four packed)."""
    model.eval()
    logits = model(*model_inputs(batch, task))
    mask = batch["mask"].float()
    K = logits.shape[-1]
    if task == "cls":
        label = batch["label"].long()
        hit = (logits.argmax(-1) == label).float() * mask
        onehot = torch.nn.functional.one_hot(label, K).float()
        onehot = onehot * mask[:, None]
        counts = hit.sum(), mask.sum(), hit @ onehot, onehot.sum(0)
    else:
        label = batch["seg"].long()
        hit = (logits.argmax(-1) == label).float() * mask[:, None]
        onehot = torch.nn.functional.one_hot(label, K).float()
        onehot = onehot * mask[:, None, None]
        counts = (hit.sum(), mask.sum() * logits.shape[1],
                  torch.einsum("bn,bnc->c", hit, onehot),
                  onehot.sum((0, 1)))
    mesh = collective(mesh)
    if mesh is None:
        return counts
    flat = mesh.sum(torch.cat([c.reshape(-1) for c in counts]))
    return (flat[0], flat[1], flat[2:2 + K], flat[2 + K:])
