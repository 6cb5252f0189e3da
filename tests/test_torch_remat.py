"""Rematerialisation of the train step's forward (``TrainConfig.remat``) on
the CPU.

Every policy of ``steps.REMAT_POLICIES`` (JAX's steps_body.py:56-67) must
give the step of ``remat="none"`` bit for bit: the gradients, the BN
running statistics (updated once, though the forward runs twice), Adam's
moments, the parameters and the generator's state after the step, with
dropout and the on-device augmentation drawing from the trainer's
generator. For pointnet2_cls_ssg, pointnet2_sem_seg, and pointnet2_cls_ssg
with the fused SA chain on (its plain versions on the CPU).
"""

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.nn.layers import BatchNorm
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train.steps import REMAT_POLICIES, run_one_step
from tests.test_torch_multi_step import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_CASES = {"cls_ssg": ("pointnet2_cls_ssg", "cls", False),
          "sem_seg": ("pointnet2_sem_seg", "scannet", False),
          "cls_ssg_fused": ("pointnet2_cls_ssg", "cls", True)}


def _batch(name: str) -> dict:
    r = np.random.RandomState(7)
    B, N = 4, 32
    batch = {"points": torch.from_numpy(r.rand(B, N, 3).astype(np.float32)),
             "mask": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    if name == "pointnet2_sem_seg":
        batch["seg"] = torch.from_numpy(r.randint(0, 21, (B, N)))
        batch["smpw"] = torch.from_numpy(r.rand(B, N).astype(np.float32))
    else:
        batch["label"] = torch.from_numpy(r.randint(0, 40, B))
    return batch


def _step(tmp_path, case: str, remat: str, steps: int = 1):
    """A step from the seed's weights; returns every gradient, buffer,
    parameter and moment, the generator's state, the forwards run and the
    running updates folded."""
    name, augment, fused = _CASES[case]
    cfg = TrainConfig(model=name, num_point=32, batch_size=4,
                      augment=augment, log_dir=str(tmp_path / remat))
    folds, forwards = [], []
    real = BatchNorm.update_stats

    def counted(self, mean, var, momentum):
        before = self.running_mean.clone()
        real(self, mean, var, momentum)
        folds.append(not torch.equal(before, self.running_mean))

    with Trainer(cfg, device="cpu") as tr, config.fused_mlp(fused):
        state = tr.init_state()
        state.model.register_forward_pre_hook(lambda *a: forwards.append(1))
        BatchNorm.update_stats = counted
        try:
            for _ in range(steps):
                run_one_step(state, _batch(name), tr.loss_fn, tr.bn_schedule,
                             tr.augment_fn, tr.generator, tr.task,
                             remat=remat)
        finally:
            BatchNorm.update_stats = real
        out = {f"grad {k}": p.grad.clone()
               for k, p in state.model.named_parameters()}
        out.update({k: v.clone() for k, v in
                    state.model.state_dict().items()})
        for k in state.optimizer.MOMENTS:
            out.update({f"{k} {i}": t.clone()
                        for i, t in enumerate(getattr(state.optimizer, k))})
        out["generator"] = tr.generator.get_state()
    return out, len(forwards), sum(folds)


_NONE: dict = {}  # case -> _step(case, "none"), made once


@pytest.mark.parametrize("remat", ["full", "dots", "dots_nobatch"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_remat_equals_none_bit_for_bit(tmp_path, case, remat):
    if case not in _NONE:
        _NONE[case] = _step(tmp_path, case, "none")
    want, fwd_none, folds_none = _NONE[case]
    got, fwd, folds = _step(tmp_path, case, remat)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the forward ran again in each backward, the running update did not
    assert (fwd_none, fwd) == (1, 2)
    assert folds == folds_none > 0


def test_remat_policies_are_jax_names():
    assert sorted(REMAT_POLICIES) == ["dots", "dots_nobatch", "full", "none"]
    with pytest.raises(ValueError, match="remat"):
        Trainer(TrainConfig(remat="everything"), device="cpu")
