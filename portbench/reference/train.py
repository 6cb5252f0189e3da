"""The reference's train steps: a configuration's augmentation and loss
(its ``configs/<config>.ref.py``) and the published recipe's optimizer in
plain float32 PyTorch, following a program's first steps from the same
weights, batches and seed.

- Augmentation (``augment_cls``, the ModelNet40 chain of the published
  train.py, for the configurations whose reference names it): rotation
  about the up axis, a small perturbing rotation about x, y and z, a
  random scale, a shift, a clipped jitter and one shuffle of the points,
  each drawn from one ``torch.Generator`` on the device seeded with the
  run's seed, in that order, for the global batch; the dropout masks of the
  head follow in the forward. A program that draws the same parameters in
  the same order from a generator with the same seed sees the same
  numbers; the draws are part of what the check holds it to.
- Loss: the configuration's (``cloud_cross_entropy``: the mean softmax
  cross-entropy over the batch's clouds).
- Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root) on the
  staircase learning rate lr * rate^floor(step * batch / decay_step),
  clipped at 1e-5, as the published train.py schedules it.
- Batch norm's running statistics after the first step, folded with the
  published BN decay (``bn_momentum``).

``half_batch`` plants a fault: the loss is taken over the first half of
the batch's rows alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import Ctx

# Adam's decay rates (the published train.py: TensorFlow's defaults)
B1, B2 = 0.9, 0.999


def _rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


def _rot_xyz(a):
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    z, o = torch.zeros_like(ax), torch.ones_like(ax)
    Rx = torch.stack([torch.stack([o, z, z], -1),
                      torch.stack([z, cx, -sx], -1),
                      torch.stack([z, sx, cx], -1)], dim=-2)
    Ry = torch.stack([torch.stack([cy, z, sy], -1),
                      torch.stack([z, o, z], -1),
                      torch.stack([-sy, z, cy], -1)], dim=-2)
    Rz = torch.stack([torch.stack([cz, -sz, z], -1),
                      torch.stack([sz, cz, z], -1),
                      torch.stack([z, z, o], -1)], dim=-2)
    return Rz @ (Ry @ Rx)


def _rotate(pts, R):
    return torch.cat([pts[..., 0:3] @ R, pts[..., 3:]], dim=-1)


def _uniform(gen, shape, device, low, high):
    return torch.rand(shape, generator=gen, device=device) * (high - low) + low


def augment_cls(gen: torch.Generator, pts: torch.Tensor) -> torch.Tensor:
    """The ModelNet40 chain on (B, N, 3) float32 points."""
    B, N, dev = pts.shape[0], pts.shape[1], pts.device
    pts = _rotate(pts, _rot_y(_uniform(gen, (B,), dev, 0.0, 2 * math.pi)))
    ang = torch.clamp(0.06 * torch.randn((B, 3), generator=gen, device=dev),
                      -0.18, 0.18)
    pts = _rotate(pts, _rot_xyz(ang))
    scale = _uniform(gen, (B, 1, 1), dev, 0.8, 1.25)
    pts = torch.cat([pts[..., 0:3] * scale, pts[..., 3:]], dim=-1)
    shift = _uniform(gen, (B, 1, 3), dev, -0.1, 0.1)
    pts = torch.cat([pts[..., 0:3] + shift, pts[..., 3:]], dim=-1)
    noise = torch.clamp(0.01 * torch.randn(pts[..., 0:3].shape, generator=gen,
                                           device=dev), -0.05, 0.05)
    pts = torch.cat([pts[..., 0:3] + noise, pts[..., 3:]], dim=-1)
    perm = torch.randperm(N, generator=gen, device=dev)
    return pts[:, perm, :]


def cloud_cross_entropy(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The mean softmax cross-entropy of (B, K) logits against the batch's
    (B,) ``label``."""
    label = batch["label"].long()
    return -torch.log_softmax(logits.float(), -1).gather(
        -1, label[:, None])[:, 0].mean()


def learning_rate(recipe: dict, step: int, batch: int) -> float:
    seen = np.float32(np.int32(step) * np.int32(batch))
    exp = np.floor(seen / np.float32(recipe["decay_step"]))
    lr = np.float32(recipe["learning_rate"]) * np.power(
        np.float32(recipe["decay_rate"]), exp)
    return float(max(lr, np.float32(1e-5)))


def train_steps(ref, cfg: dict, weights: dict, batches: list, seed: int,
                device, linear=None, half_batch: bool = False) -> dict:
    """Follow len(batches) train steps of the configuration's reference
    ``ref`` (``forward(ctx, params, cfg, points)``, ``loss(logits,
    batch)``, ``augment(gen, points)`` or None) from ``weights`` (name ->
    tensor; the parameters are the names ``is_param`` keeps). ``batches``
    are host dicts of the global batch, ``points`` (B, N, C) first.

    Returns {"loss": [per step], "grad1": {name: first step's gradient},
    "params": [{name: parameters after step s} for s = 1, 2, ...],
    "mu": [{name: Adam's first moment after step s}], "stats1": {name:
    running statistics after step 1}}."""
    recipe = cfg["train"]
    params = {k: v.detach().to(device, torch.float32).clone()
              for k, v in weights.items()}
    leaves = [k for k in params if is_param(k)]
    for k in leaves:
        params[k].requires_grad_(True)
    mu = {k: torch.zeros_like(params[k]) for k in leaves}
    nu = {k: torch.zeros_like(params[k]) for k in leaves}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ctx = Ctx(train=True, eps=cfg["bn_epsilon"], generator=gen)
    if linear is not None:
        ctx.linear = linear
    out = {"loss": [], "grad1": None, "params": [], "mu": [], "stats1": None}
    for step, host in enumerate(batches):
        ctx.stats = {} if step == 0 else None
        batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in host.items() if k != "nvalid"}
        pts = batch["points"].float()
        if ref.augment is not None:
            pts = ref.augment(gen, pts)
        logits = ref.forward(ctx, params, cfg, pts)
        if half_batch:
            h = pts.shape[0] // 2
            loss = ref.loss(logits[:h], {k: v[:h] for k, v in batch.items()})
        else:
            loss = ref.loss(logits, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad1"] = {k: g.detach().clone()
                            for k, g in zip(leaves, grads)}
            out["stats1"] = running_stats(recipe, weights, ctx.stats,
                                          pts.shape[0])
        lr = learning_rate(recipe, step, pts.shape[0])
        t = step + 1
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                mu[k].mul_(B1).add_((1 - B1) * g)
                nu[k].mul_(B2).add_((1 - B2) * g * g)
                mhat = mu[k] / (1 - B1 ** t)
                nhat = nu[k] / (1 - B2 ** t)
                params[k].sub_(lr * mhat / (nhat.sqrt() + 1e-8))
        out["params"].append({k: params[k].detach().clone() for k in leaves})
        out["mu"].append({k: mu[k].clone() for k in leaves})
    return out


def bn_momentum(recipe: dict, step: int, batch: int) -> float:
    """The BN decay of the published train.py at ``step``: 1 - init *
    rate^floor(step * batch / decay_step), clipped at ``bn_decay_clip``."""
    seen = np.float32(np.int32(step) * np.int32(batch))
    exp = np.floor(seen / np.float32(recipe["decay_step"]))
    m = np.float32(1.0) - np.float32(recipe["bn_init_decay"]) * np.power(
        np.float32(recipe["bn_decay_rate"]), exp)
    return float(min(m, np.float32(recipe["bn_decay_clip"])))


def running_stats(recipe: dict, weights: dict, batch_stats: dict,
                  batch: int) -> dict:
    """The running statistics after the first step: running * m +
    batch * (1 - m) with the first step's BN decay m."""
    m = bn_momentum(recipe, 0, batch)
    out = {}
    for name, (mean, var) in batch_stats.items():
        for field, value in (("running_mean", mean), ("running_var", var)):
            key = f"{name}.norm.{field}"
            r0 = weights[key].to(value.device, torch.float32)
            out[key] = r0 * m + value * (1.0 - m)
    return out


def is_param(name: str) -> bool:
    """Trained parameters: dense weights and biases, batch-norm scales and
    shifts (not the running statistics)."""
    return not name.endswith(("running_mean", "running_var"))
