"""The frozen reference agrees with the port's plain route on the CPU at a
tiny size: the same weights and clouds give the same logits, and the
reference's first train step the port's loss and gradient."""

import tempfile

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch.serving import Predictor

from portbench.harness import check, spec, train_epochs, weights
from portbench.reference.model import Ctx, fp8


@pytest.mark.parametrize("name,B,N", [
    ("pointnet2_cls_ssg-modelnet40", 2, 1024),
    ("pointnet2_sem_seg-scannet", 1, 2048)])
def test_eval_logits_agree(name, B, N):
    cfg = spec.config(spec.load_benchmark(), name)
    w = weights.make(torch, cfg, 2 ** 31 + 5, "cpu")
    x = (np.random.default_rng(0).random((B, N, 3)) * 2 - 1).astype(
        np.float32)
    pred = Predictor(cfg["model"], variables=w, dtype=None, device="cpu",
                     num_classes=cfg["num_classes"])
    got = torch.from_numpy(pred(x))
    with torch.no_grad():
        ref = spec.reference(name).forward(Ctx(eps=cfg["bn_epsilon"]), w, cfg,
                                           torch.from_numpy(x))
    assert float((got - ref).norm() / ref.norm()) < 1e-5
    ctrl = spec.reference(name).forward(
        Ctx(eps=cfg["bn_epsilon"], linear=fp8), w, cfg, torch.from_numpy(x))
    assert float((ctrl - ref).norm() / ref.norm()) > 1e-3


def test_first_train_step_agrees():
    from portbench.tests.common import small_cell

    cell, cfg, mix = small_cell("cls_ssg.train")
    seed = 2 ** 31 + 3
    with tempfile.TemporaryDirectory() as log_dir:
        trainer, state, w, data = train_epochs.build(cfg, mix, 1, seed, "cpu",
                                                     log_dir)
        prog, batches = train_epochs.first_steps(trainer, state, w, data, 1,
                                                 1, log_dir)
        trainer.close()
    ref = train_epochs.reference_readings(torch, cfg, w, batches[:1], seed,
                                          torch.device("cpu"), 1)
    assert abs(prog["losses"][0] - ref["losses"][0]) < 1e-4 * ref["losses"][0]
    assert max(check.leaf_gaps(prog["grad1"], ref["grad1"]).values()) < 1e-2
