"""The port's checkpoints and resume on the CPU.

A run interrupted after 2 epochs and resumed by a new Trainer in the same
log_dir ends bit for bit where an uninterrupted 4-epoch run ends (on-device
``augment="cls"`` and dropout on: the generator's state is part of the
checkpoint); a resumed run keeps a better best checkpoint; the two-rename
swap survives a crash between its renames and a save into that state; a
checkpoint serves through ``Predictor.from_checkpoint``. Ports of
tests/test_train.py:85,304,336 and tests/test_serving.py:83 (the
prefetcher's and thread map's behaviour too, tests/test_cli_journey.py:74).
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import Predictor, get_model
from pointnet2_tpu_torch.data import SyntheticClassification
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train import checkpoint as ckpt
from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.utils.prefetch import Prefetcher, parallel_map

N = 128


def _trainer(log_dir, **kw):
    cfg = dict(batch_size=4, num_point=N, max_epoch=4, augment="cls",
               log_dir=str(log_dir), seed=3, ckpt_every_epochs=10)
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg), device="cpu")


def _datasets():
    """(train, eval): 2 batches an epoch and 1."""
    return tuple(SyntheticClassification(num_classes=4, samples_per_class=k,
                                         npoints=N, batch_size=4, seed=s)
                 for s, k in ((0, 2), (1, 1)))


def _snapshot(tr, state):
    opt = state.optimizer.state_dict()
    return {"params": {k: v.detach().clone()
                       for k, v in state.model.named_parameters()},
            "buffers": {k: v.clone() for k, v in state.model.named_buffers()},
            "moments": {k: [t.clone() for t in opt[k]]
                        for k in state.optimizer.MOMENTS},
            "count": opt["count"], "step": state.step,
            "generator": tr.generator.get_state()}


def _assert_same(a, b):
    assert a["step"] == b["step"] and a["count"] == b["count"]
    assert torch.equal(a["generator"], b["generator"])
    for group in ("params", "buffers"):
        assert a[group].keys() == b[group].keys()
        for k in a[group]:
            assert torch.equal(a[group][k], b[group][k]), (group, k)
    for k in a["moments"]:
        for x, y in zip(a["moments"][k], b["moments"][k]):
            assert torch.equal(x, y), k


@pytest.mark.parametrize("optimizer, dtype", [("adam", "float32"),
                                              ("momentum", "bfloat16")])
def test_two_plus_two_epochs_equal_four(tmp_path, optimizer, dtype):
    """2 epochs, stop, resume to 4 in a new Trainer: every parameter, BN
    statistic, optimizer moment, the count, the step and the generator
    equal those of 4 uninterrupted epochs, bit for bit. The data sets are
    carried across the stop, as one process would."""
    kw = dict(optimizer=optimizer, compute_dtype=dtype)
    train, evals = _datasets()
    with _trainer(tmp_path / "straight", **kw) as tr:
        want = _snapshot(tr, tr.fit(train, eval_dataset=evals))
    train, evals = _datasets()
    with _trainer(tmp_path / "resumed", **kw) as tr:
        state = tr.fit(train, eval_dataset=evals, max_epoch=2)
        assert state.step == 4
    assert ckpt.load_meta(str(tmp_path / "resumed")) == {"step": 4,
                                                         "epoch": 2}
    with _trainer(tmp_path / "resumed", **kw) as tr:
        got = _snapshot(tr, tr.fit(train, eval_dataset=evals))
    assert got["step"] == 8
    _assert_same(got, want)
    log = (tmp_path / "resumed" / "log_train.txt").read_text()
    assert "restored checkpoint at step 4 (epoch 2)" in log
    rows = [json.loads(line) for line in
            open(tmp_path / "resumed" / "metrics.jsonl")]
    assert [r["epoch"] for r in rows if r["split"] == "train"] == [0, 1, 2, 3]


def test_resume_does_not_clobber_better_best_ckpt(tmp_path):
    """A resumed fit seeds its best score from the best checkpoint's
    sidecar; a fresh fit in a reused log_dir does not."""
    train, evals = _datasets()
    with _trainer(tmp_path, max_epoch=1, ckpt_every_epochs=1) as tr:
        tr.fit(train, eval_dataset=evals)
    meta = ckpt.load_meta(str(tmp_path), name="best")
    assert meta is not None and meta.get("score") is not None
    meta["score"] = 0.999999  # an unbeatable pre-interruption best
    (tmp_path / "best.meta.json").write_text(json.dumps(meta))
    with _trainer(tmp_path, max_epoch=2, ckpt_every_epochs=1) as tr:
        tr.fit(train, eval_dataset=evals)  # resumes at epoch 1
        assert tr.best_score == pytest.approx(0.999999)
    assert ckpt.load_meta(str(tmp_path), name="best")["score"] == \
        pytest.approx(0.999999), "resume overwrote a better best checkpoint"
    assert ckpt.load_meta(str(tmp_path))["epoch"] == 2
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_periodic_and_final_checkpoints_and_protocol_score(tmp_path,
                                                           monkeypatch):
    """ckpt_every_epochs writes ckpt on its cadence and after the last
    epoch; an eval_protocol's score selects the best checkpoint."""
    train, _ = _datasets()
    scores = iter([0.5, 0.25, 0.75])
    seen = []

    def protocol(trainer, state, epoch):
        seen.append((epoch, state.step))
        return next(scores)

    saves = []
    real = ckpt.save_checkpoint

    def spy(directory, state, name="ckpt", **kw):
        saves.append((name, kw.get("epoch"), kw.get("score")))
        return real(directory, state, name, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    with _trainer(tmp_path, max_epoch=3, ckpt_every_epochs=2) as tr:
        tr.fit(train, eval_protocol=protocol)
    assert seen == [(0, 2), (1, 4), (2, 6)]
    assert saves == [("best", 1, 0.5), ("ckpt", 2, None),
                     ("best", 3, 0.75), ("ckpt", 3, None)]
    assert ckpt.load_meta(str(tmp_path), "best") == {"step": 6, "epoch": 3,
                                                     "score": 0.75}
    with _trainer(tmp_path, max_epoch=3) as tr:  # nothing left to run
        state = tr.fit(train, eval_protocol=protocol)
    assert state.step == 6 and len(saves) == 4


def _state(seed=0, step=7):
    model = get_model("pointnet2_cls_ssg", device="cpu", seed=seed)
    opt = make_optimizer("adam", model.parameters(), lambda c: 1e-3)
    return TrainState(step=step, model=model, optimizer=opt)


def test_checkpoint_round_trip_is_exact(tmp_path):
    state = _state(seed=1, step=5)
    opt = state.optimizer
    opt.count = 9
    opt.mu = [torch.randn_like(t) for t in opt.mu]
    opt.nu = [torch.rand_like(t) for t in opt.nu]
    gen = torch.Generator().manual_seed(4)
    torch.rand(3, generator=gen)
    ckpt.save_checkpoint(str(tmp_path), state, epoch=2, generator=gen)
    saved = torch.load(tmp_path / "ckpt" / "state.pt", weights_only=True)
    assert sorted(saved) == ["generator", "model", "optimizer", "step"]
    other, gen2 = _state(seed=2, step=0), torch.Generator().manual_seed(0)
    ckpt.restore_checkpoint(str(tmp_path), other, generator=gen2)
    assert other.step == 5 and other.optimizer.count == 9
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    for a, b in zip(opt.mu + opt.nu, other.optimizer.mu + other.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=gen2))
    momentum = make_optimizer("momentum", other.model.parameters(),
                              lambda c: 1e-3)
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path),
                                TrainState(0, other.model, momentum))
    with pytest.raises(ValueError, match="no generator"):
        ckpt.save_checkpoint(str(tmp_path), state, name="bare")
        ckpt.restore_checkpoint(str(tmp_path), other, name="bare",
                                generator=gen2)


def test_checkpoint_overwrite_is_crash_safe(tmp_path):
    """Overwriting never passes through a state without a restorable
    checkpoint: a kill between the two renames leaves `<name>.old`, which
    load_meta and restore recover."""
    state = _state()
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1)
    state.step = 8
    ckpt.save_checkpoint(str(tmp_path), state, epoch=2)
    assert ckpt.load_meta(str(tmp_path))["epoch"] == 2
    path = os.path.join(str(tmp_path), "ckpt")
    assert not os.path.isdir(path + ".old")
    assert not os.path.isdir(path + ".new")
    shutil.move(path, path + ".old")  # a crash between the renames
    meta = ckpt.load_meta(str(tmp_path))
    assert meta is not None and meta["epoch"] == 2, "recovery failed"
    shutil.move(path, path + ".old")
    restored = ckpt.restore_checkpoint(str(tmp_path), _state(step=0))
    assert restored.step == 8
    assert ckpt.load_meta(str(tmp_path), name="none") is None


def test_save_into_crashed_swap_state_keeps_resume_point(tmp_path,
                                                         monkeypatch):
    """A save into the crashed-between-renames state recovers the survivor
    before it clears stale side directories: if that save then dies mid
    write, the previous generation still restores."""
    state = _state()
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1)
    path = os.path.join(str(tmp_path), "ckpt")
    shutil.move(path, path + ".old")

    def boom(*a, **k):
        raise RuntimeError("simulated mid-save crash")

    monkeypatch.setattr(torch, "save", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        ckpt.save_checkpoint(str(tmp_path), state, epoch=2)
    monkeypatch.undo()
    assert ckpt.load_meta(str(tmp_path))["epoch"] == 1
    assert ckpt.restore_checkpoint(str(tmp_path), _state(step=0)).step == 7


def test_from_checkpoint_round_trip(tmp_path):
    state = _state(seed=5)
    ckpt.save_checkpoint(str(tmp_path), state, name="best", score=0.5)
    pred = Predictor.from_checkpoint(
        "pointnet2_cls_ssg", str(tmp_path), num_point=N, name="best",
        buckets=(4,), dtype=None, device="cpu")
    pts = np.random.default_rng(0).random((2, N, 3), np.float32)
    model = state.model.eval()
    with torch.inference_mode():
        padded = torch.from_numpy(np.concatenate([pts, pts[:1], pts[:1]]))
        direct = model(padded).numpy()[:2]
    np.testing.assert_array_equal(pred(pts), direct)


def test_prefetcher_order_errors_and_close():
    assert list(Prefetcher(range(50), depth=3)) == list(range(50))

    def broken():
        yield 1
        raise ValueError("loader failed")

    it = Prefetcher(broken())
    assert next(it) == 1
    with pytest.raises(ValueError, match="loader failed"):
        next(it)
    before = threading.active_count()
    it = Prefetcher(iter(range(10 ** 6)), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() <= before
    with pytest.raises(StopIteration):
        next(it)


def test_parallel_map_order_and_laziness():
    out = list(parallel_map(lambda x: x * x, range(23), workers=3))
    assert out == [x * x for x in range(23)]
    consumed = []

    def src():
        for i in range(1000):
            consumed.append(i)
            yield i

    it = parallel_map(lambda x: x, src(), workers=2, ahead=4)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    assert len(consumed) < 50
