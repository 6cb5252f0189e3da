"""The check fails a broken program: each cell driven on the CPU at a
small size (portbench/tests/common.py), once sound and once with a fault
planted under its timed path, against the cell's own limits. The
training faults: a step that returns its state unchanged, half of the
batch left out with the mean taken over the rest (in every step, or in
the K-step call alone), and on several ranks the gradient exchange left
out; the serving fault: one point's answer altered where the endpoint
produces it. The control (the reference in float8 in the program's
place) fails the training and the serving check too."""

import pytest
import torch

from portbench.harness import (check, serve_blocks, spec, train_epochs,
                                weights)
from portbench.reference.model import fp8
from portbench.tests import faults
from portbench.tests.common import run_small, small_cell

FAULTS = "portbench.tests.faults:"


_CELLS = spec.load_benchmark()["workloads"]
# a cell on several chips runs on two CPU ranks here
_RANKS = {c["name"]: (2 if c["chips"] > 1 else None) for c in _CELLS}


@pytest.mark.parametrize("name", sorted(_RANKS))
def test_sound_cells_are_correct(name):
    res = run_small(name, _RANKS[name])
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "half_batch_in_call"])
def test_train_faults_are_caught(fault, monkeypatch):
    getattr(faults, fault)(monkeypatch)
    res = run_small("cls_ssg.train")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", sorted(n for n, r in _RANKS.items() if r))
def test_missing_exchange_is_caught(name):
    # each rank is a process of its own: the fault is planted there
    res = run_small(name, _RANKS[name], plant=FAULTS + "no_allreduce")
    assert not res["correct"], res["checks"]


def test_altered_answer_is_caught(monkeypatch):
    faults.altered_answer(monkeypatch)
    res = run_small("sem_seg.serve_blocks")
    assert not res["correct"], res["checks"]


def test_control_fails_the_serving_check():
    cell, cfg, mix = small_cell("sem_seg.serve_blocks")
    w = weights.make(torch, cfg, 2 ** 31 + 21, "cpu")
    pool = serve_blocks.make_pool(cfg, mix, 2 ** 31 + 21)
    kept = [(0, serve_blocks.reference_logits(torch, cfg, w, pool[0], "cpu",
                                              linear=fp8).numpy())]
    numbers = serve_blocks.compare(torch, cfg, w, pool, kept, "cpu")
    correct, checks = check.verdict(numbers, spec.limits(cell["name"]))
    assert not correct, checks


def test_control_fails_the_training_check():
    cell, cfg, mix = small_cell("cls_ssg.train")
    seed = 2 ** 31 + 23
    singles, K = mix["setup_single_steps"], mix["steps_per_call"]
    w = weights.make(torch, cfg, seed, "cpu")
    data = train_epochs.make_data(cfg, mix["batch_per_chip"], seed)
    batches = list(data.epoch())[:singles + K]
    dev = torch.device("cpu")
    ref = train_epochs.reference_readings(torch, cfg, w, batches, seed, dev,
                                          singles)
    ctrl = train_epochs.reference_readings(torch, cfg, w, batches, seed, dev,
                                           singles, linear=fp8)
    numbers = check.train_numbers(ctrl, ref)
    correct, checks = check.verdict(numbers, spec.limits(cell["name"]))
    assert not correct, checks
