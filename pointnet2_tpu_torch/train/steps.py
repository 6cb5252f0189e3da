"""The single-device train step and the eval count step.

Port of pointnet2_tpu/train/steps_body.py:19-136 and train/steps.py:41-46,
127-170 on one device (the data-parallel mesh and its cross-replica
averages are not ported yet), for every task of the registry:

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
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from pointnet2_tpu_torch.data.augment_device import (
    augment_cls,
    augment_cls_normals,
    augment_scannet,
)
from pointnet2_tpu_torch.train.state import TrainState

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


def accuracy(logits: torch.Tensor, batch: dict,
             task: str = "cls") -> torch.Tensor:
    """Mean of argmax == target (``label`` for cls, else ``seg`` per
    point), over the rows (and their points) with mask 1 when a mask is
    given (steps_body.py:36-53)."""
    target = batch["label"] if task == "cls" else batch["seg"]
    hit = (logits.argmax(-1) == target).float()
    mask = batch.get("mask")
    if mask is None:
        return hit.mean()
    while mask.dim() < hit.dim():
        mask = mask[..., None]
    num = (hit * mask).sum()
    den = mask.expand_as(hit).sum()
    return num / torch.clamp_min(den, 1e-8)


def run_one_step(state: TrainState, batch: dict, loss_fn: Callable,
                 bn_momentum_fn: Callable, augment_fn: Callable | None = None,
                 generator: torch.Generator | None = None,
                 task: str = "cls") -> dict:
    """One forward/backward/optimizer step, in place on ``state``.

    batch: ``points`` (B, N, C) f32, the task's targets (module doc),
    optional ``mask`` (B,) f32 of valid rows. Returns {"loss",
    "accuracy"} as 0-dim tensors on the device."""
    model, opt = state.model, state.optimizer
    if augment_fn is not None:
        batch = dict(batch, points=augment_fn(generator, batch["points"]))
    momentum = bn_momentum_fn(state.step)
    model.train()
    logits = model(*model_inputs(batch, task), bn_momentum=momentum,
                   generator=generator)
    # `mask` zeroes the duplicated rows of a padded final batch out of the
    # loss and gradients; BN batch statistics still see them. A batch whose
    # every weight is zero gives num = 0 and a loss of 0.
    mask = batch.get("mask")
    if mask is None:
        loss = loss_fn(logits, *loss_args(batch, task))
    else:
        num, den = loss_fn(logits, *loss_args(batch, task),
                           sample_weight=mask, sum_count=True)
        loss = num / torch.clamp_min(den, 1e-8)
    opt.zero_grad()
    loss.backward()
    opt.step()
    state.step += 1
    return {"loss": loss.detach(),
            "accuracy": accuracy(logits.detach(), batch, task)}


@torch.inference_mode()
def eval_counts(model: torch.nn.Module, batch: dict, task: str = "cls"):
    """(correct, total, per_class_correct (K,), per_class_total (K,)) of an
    eval forward, rows weighted by ``batch["mask"]`` (train/steps.py:
    127-170); for the segmentation tasks every point of a row counts."""
    model.eval()
    logits = model(*model_inputs(batch, task))
    mask = batch["mask"].float()
    K = logits.shape[-1]
    if task == "cls":
        label = batch["label"].long()
        hit = (logits.argmax(-1) == label).float() * mask
        onehot = torch.nn.functional.one_hot(label, K).float()
        onehot = onehot * mask[:, None]
        return hit.sum(), mask.sum(), hit @ onehot, onehot.sum(0)
    label = batch["seg"].long()
    hit = (logits.argmax(-1) == label).float() * mask[:, None]
    onehot = torch.nn.functional.one_hot(label, K).float()
    onehot = onehot * mask[:, None, None]
    return (hit.sum(), mask.sum() * logits.shape[1],
            torch.einsum("bn,bnc->c", hit, onehot), onehot.sum((0, 1)))
