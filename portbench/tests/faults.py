"""Faults planted under a run of the harness for its tests: each patches
the program under test through ``patch`` (pytest's ``monkeypatch``, which
puts everything back after the test), or for good in a process of its own
(a spawned rank: the harness's ``plant`` argument,
"portbench.tests.faults:<name>")."""

from __future__ import annotations


class _ForGood:
    setattr = staticmethod(setattr)

    @staticmethod
    def setitem(d, k, v):
        d[k] = v


def state_unchanged(patch=_ForGood):
    """Every optimizer step returns the state as it found it."""
    from pointnet2_tpu_torch.train import state

    def step(self, scalars=None):
        self.count += 1

    patch.setattr(state._Optimizer, "step", step)


def _halved(loss):
    """``loss`` over the first half of the batch's rows, the mean taken
    over them alone."""

    def halved(logits, *args, sample_weight=None, sum_count=False):
        w = (_ones(logits) if sample_weight is None
             else sample_weight.clone())
        w[w.shape[0] // 2:] = 0
        return loss(logits, *args, sample_weight=w, sum_count=sum_count)

    return halved


def _ones(logits):
    import torch

    return torch.ones(logits.shape[0], dtype=logits.dtype,
                      device=logits.device)


def half_batch(patch=_ForGood):
    """Every model's loss leaves out the second half of every batch, the
    mean taken over the rest."""
    import dataclasses

    from pointnet2_tpu_torch import models

    for name, spec in list(models.MODEL_REGISTRY.items()):
        patch.setitem(models.MODEL_REGISTRY, name,
                      dataclasses.replace(spec, loss=_halved(spec.loss)))


def half_batch_in_call(patch=_ForGood):
    """Half the batch left out as ``half_batch`` does, in the K-step call
    alone (the CUDA graph the window replays); single steps stay sound."""
    from pointnet2_tpu_torch.train import steps

    init = steps.TrainMultiStep.__init__

    def halved_init(self, state, loss_fn, *args, **kwargs):
        init(self, state, _halved(loss_fn), *args, **kwargs)

    patch.setattr(steps.TrainMultiStep, "__init__", halved_init)


def no_allreduce(patch=_ForGood):
    """The ranks' gradients are never exchanged."""
    from pointnet2_tpu_torch.train import steps

    patch.setattr(steps, "average_gradients", lambda mesh, params: None)


def altered_answer(patch=_ForGood):
    """One point's answer is altered where the endpoint produces it: its
    class logits come out reversed."""
    from pointnet2_tpu_torch import serving

    call = serving.Predictor.__call__

    def altered(self, points, cls_label=None):
        out = call(self, points, cls_label)
        out[0, 0] = out[0, 0, ::-1].copy()
        return out

    patch.setattr(serving.Predictor, "__call__", altered)
