"""The single-device train step and the eval count step.

Port of pointnet2_tpu/train/steps_body.py:19-136 and train/steps.py:69-88,
127-170, for classification on one device (the data-parallel mesh and its
cross-replica averages are not ported yet):

- ``run_one_step``: on-device augmentation, the BN momentum of the current
  step, the train-mode forward (batch-statistics BN, dropout), the loss
  (masked by ``batch["mask"]`` when present: num / max(den, 1e-8)), the
  backward, the optimizer update, ``step += 1``. The augmentation's
  parameters and the dropout masks come from one ``torch.Generator`` on the
  device, in that order.
- ``eval_counts``: correct, total and per-class counts of an eval-mode
  forward, masked, for accuracy and avg-class accuracy.

Both take batches of tensors already on the model's device; the returned
metrics stay there too (no host sync inside a step).
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from pointnet2_tpu_torch.data.augment_device import augment_cls
from pointnet2_tpu_torch.train.state import TrainState

AUGMENTATIONS: dict[str, Callable | None] = {
    "none": None,
    "cls": augment_cls,
}


def accuracy(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Mean of argmax == label, over the rows with mask 1 when a mask is
    given (steps_body.py:36-53)."""
    hit = (logits.argmax(-1) == batch["label"]).float()
    mask = batch.get("mask")
    if mask is None:
        return hit.mean()
    return (hit * mask).sum() / torch.clamp_min(mask.sum(), 1e-8)


def run_one_step(state: TrainState, batch: dict, loss_fn: Callable,
                 bn_momentum_fn: Callable, augment_fn: Callable | None = None,
                 generator: torch.Generator | None = None) -> dict:
    """One forward/backward/optimizer step, in place on ``state``.

    batch: ``points`` (B, N, C) f32, ``label`` (B,) int, optional ``mask``
    (B,) f32 of valid rows. Returns {"loss", "accuracy"} as 0-dim tensors
    on the device."""
    model, opt = state.model, state.optimizer
    points = batch["points"]
    if augment_fn is not None:
        points = augment_fn(generator, points)
    momentum = bn_momentum_fn(state.step)
    model.train()
    logits = model(points, bn_momentum=momentum, generator=generator)
    # `mask` zeroes the duplicated rows of a padded final batch out of the
    # loss and gradients; BN batch statistics still see them
    mask = batch.get("mask")
    if mask is None:
        loss = loss_fn(logits, batch["label"])
    else:
        num, den = loss_fn(logits, batch["label"], sample_weight=mask,
                           sum_count=True)
        loss = num / torch.clamp_min(den, 1e-8)
    opt.zero_grad()
    loss.backward()
    opt.step()
    state.step += 1
    return {"loss": loss.detach(), "accuracy": accuracy(logits.detach(),
                                                        batch)}


@torch.inference_mode()
def eval_counts(model: torch.nn.Module, batch: dict):
    """(correct, total, per_class_correct (K,), per_class_total (K,)) of an
    eval forward, rows weighted by ``batch["mask"]`` (train/steps.py:
    127-170)."""
    model.eval()
    logits = model(batch["points"])
    mask = batch["mask"].float()
    label = batch["label"].long()
    hit = (logits.argmax(-1) == label).float() * mask
    onehot = torch.nn.functional.one_hot(label, logits.shape[-1]).float()
    onehot = onehot * mask[:, None]
    return hit.sum(), mask.sum(), hit @ onehot, onehot.sum(0)
