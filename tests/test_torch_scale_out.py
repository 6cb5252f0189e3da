"""Data parallelism of the port on the CPU: N ranks over gloo against one
process on the global batch.

The ranks are processes started by ``parallel.launch.spawn``; each runs
:func:`rank_main` on a spec this file writes, a dict of named jobs, and
saves its results for the test to read. The spawn start method imports a
rank's function by name, so this module imports nothing of JAX;
``tests/test_torch_scale_out_jax.py`` holds the same runs against the JAX
package's sharded functions. Each job function also runs in the test
process without a group, where it is the single-process reference on the
global batch.

Tolerances: the ranks' sums of per-rank means differ from one process's
sums in their order only, so forward values and BN statistics agree to
1e-5 of their scale; the fused chain's at ``tests/test_ops_fused_mlp.py``'s
1e-5; the train steps run in float64, where that order is all that
differs (each test says its bounds).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pointnet2_tpu_torch import Predictor
from pointnet2_tpu_torch.data import SyntheticClassification
from pointnet2_tpu_torch.evaluation import evaluate_cls_voting
from pointnet2_tpu_torch.models import get_spec
from pointnet2_tpu_torch.nn.layers import BatchNorm, _batch_stats, cross_replica
from pointnet2_tpu_torch.ops import fused_mlp
from pointnet2_tpu_torch.parallel import launch, multihost
from pointnet2_tpu_torch.parallel.mesh import (
    collective,
    make_mesh,
    shard_batch,
)
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train import schedules as tsched
from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.train.steps import eval_counts, run_one_step

EPS = 1e-3
STEP_B, STEP_N = 4, 128
CLS, SEM = "pointnet2_cls_ssg", "pointnet2_sem_seg"


@pytest.fixture
def one_thread():
    """The test process's own forwards on one intra-op thread, as the
    ranks run: the tensors are small, and the other test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(launch.CPU_THREADS)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


# ---------------------------------------------------------------------------
# the jobs: one function a kind, run on every rank and in the test process
# ---------------------------------------------------------------------------


def _rows(mesh, n: int) -> slice:
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def bn_job(job: dict) -> dict:
    """Train-mode BatchNorm on this rank's rows of x (B, N, C) under the
    cross-replica context: output, input and parameter gradients of
    sum(y * g), the new running statistics, and the batch statistics."""
    mesh = make_mesh(None, "cpu")
    rows = _rows(mesh, job["x"].shape[0])
    bn = BatchNorm(job["x"].shape[-1]).train()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(job[k]))
    x = torch.from_numpy(job["x"][rows]).requires_grad_()
    with cross_replica(mesh):
        mean, var = _batch_stats(x.detach())
        y = bn(x, 0.5)
        (y * torch.from_numpy(job["g"][rows])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var, "mean": mean, "var": var}


def chain_job(job: dict) -> dict:
    """The fused train chain (plain versions on the CPU) on this rank's
    rows, its statistics averaged over the ranks: out, stats and the
    gradients of sum(out * g)."""
    mesh = make_mesh(None, "cpu")
    rows = _rows(mesh, job["x"].shape[0])
    leaf = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    denses = [(leaf(w), leaf(b)) for w, b in job["denses"]]
    scales = [leaf(s) for s in job["scales"]]
    biases = [leaf(b) for b in job["biases"]]
    x = leaf(job["x"][rows])
    cfg = fused_mlp.ChainConfig(EPS, True, replica=collective(mesh))
    out, stats = fused_mlp.fused_chain_train(cfg, x, denses, scales, biases)
    (out * torch.from_numpy(job["g"][rows])).sum().backward()
    return {"out": out.detach(), "stats": [torch.stack(s) for s in stats],
            "dx": x.grad, "dw": [w.grad for w, _ in denses],
            "db": [b.grad for _, b in denses],
            "dscale": [s.grad for s in scales],
            "dbias": [b.grad for b in biases]}


def step_model(job: dict):
    """The job's model on the CPU in train mode, its weights loaded (in
    float64 with ``job["float64"]``) and its dropout layers' masks (global
    batch) injected."""
    model = get_spec(job["model"]).cls(device="cpu").train()
    model.load_state_dict(job["state_dict"])
    if job.get("float64"):
        model.double()
    for attr, keep in job["masks"].items():
        mask = torch.from_numpy(keep)
        getattr(model, attr).keep_mask = (
            lambda shape, device, generator, k=mask: k)
    return model


def step_job(job: dict) -> dict:
    """One train step (Adam on the default schedules at step 0, BN momentum
    0.5) on this rank's rows of the global batch: loss, accuracy, the
    averaged gradients, the new BN statistics and eval counts of the
    batch."""
    mesh = make_mesh(None, "cpu")
    spec = get_spec(job["model"])
    model = step_model(job)
    lr = tsched.exponential_decay_clipped(1e-3, STEP_B, 200000, 0.7)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        "adam", model.parameters(), lr))
    batch = job["batch"]
    if job.get("float64"):
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    batch = shard_batch(mesh, batch)
    m = run_one_step(state, batch, spec.loss,
                     tsched.bn_momentum_schedule(STEP_B, 200000),
                     task=spec.task, mesh=mesh)
    counts = eval_counts(model, batch, spec.task, mesh)
    return {"loss": m["loss"], "acc": m["accuracy"],
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()},
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()},
            "counts": [c.clone() for c in counts]}


def _fit_sets():
    """(train, eval): synthetic clouds, 2 global batches of 4 an epoch and
    1 (tests/test_torch_checkpoint.py's)."""
    return tuple(SyntheticClassification(num_classes=4, samples_per_class=k,
                                         npoints=STEP_N, batch_size=4,
                                         seed=s)
                 for s, k in ((0, 2), (1, 1)))


def _snapshot(tr, state) -> dict:
    opt = state.optimizer.state_dict()
    return {"params": {k: v.detach().clone()
                       for k, v in state.model.named_parameters()},
            "buffers": {k: v.clone() for k, v in state.model.named_buffers()},
            "moments": {k: [t.clone() for t in opt[k]]
                        for k in state.optimizer.MOMENTS},
            "step": state.step, "generator": tr.generator.get_state()}


def fit_job(job: dict) -> dict:
    """Trainer.fit of cls_ssg on the global batches of 4 (``augment="cls"``
    draws for the global batch; Adam at the schedule's floor of 1e-5, see
    test_fit_on_two_ranks_follows_one_process): 4 epochs straight, and 2 epochs then a
    resume in a new Trainer to 4; returns both end states and the straight
    run's metrics rows."""
    n = job["ranks"]
    out = {}
    for run, stops in (("straight", (4,)), ("resumed", (2, 4))):
        log_dir = os.path.join(job["log_dir"], run)
        train, evals = _fit_sets()
        for stop in stops:
            cfg = TrainConfig(batch_size=4, num_point=STEP_N, max_epoch=4,
                              augment="cls", seed=3, log_dir=log_dir,
                              learning_rate=1e-5, ckpt_every_epochs=10,
                              num_devices=n)
            with Trainer(cfg, device="cpu") as tr:
                state = tr.fit(train, eval_dataset=evals, max_epoch=stop)
        out[run] = _snapshot(tr, state)
    if multihost.is_primary():
        with open(os.path.join(job["log_dir"], "straight",
                               "metrics.jsonl")) as f:
            out["metrics"] = [json.loads(line) for line in f]
    return out


def multihost_job(job: dict) -> dict:
    """Every multihost helper on this rank, with rank-dependent inputs."""
    r = multihost.process_index()
    multihost.barrier("multihost_job")
    return {
        "index": r, "count": multihost.process_count(),
        "primary": multihost.is_primary(),
        "min": multihost.sync_num_batches(3 + r, "min"),
        "max": multihost.sync_num_batches(3 + r, "max"),
        "sum_i": multihost.allreduce_sum(np.arange(4, dtype=np.int64) * r),
        "sum_f": multihost.allreduce_sum(np.full((2, 3), 0.5 + r)),
        "shard": multihost.process_shard(25),
        "local_batch": multihost.local_batch_size(8),
        "local": multihost.to_local_numpy(torch.arange(r + 1)),
    }


def _sharded_synthetic(seed: int, n_total: int, shard) -> SyntheticClassification:
    """n_total synthetic clouds, this rank's contiguous shard, in batches of
    the global 8 over the ranks (the JAX package's multi-process worker,
    tests/_multiprocess_worker.py)."""
    ds = SyntheticClassification(num_classes=5, samples_per_class=5,
                                 npoints=32, batch_size=8 // shard[1],
                                 seed=seed)
    from pointnet2_tpu_torch.data.modelnet import host_slice

    sl = host_slice(n_total, shard)
    ds.data, ds.label = ds.data[:n_total][sl], ds.label[:n_total][sl]
    return ds


def uneven_job(job: dict) -> dict:
    """4 host-sharded ranks on 25 items (shards 6/6/6/7, 3/3/3/4 local
    batches of 2): a 2-epoch fit whose train epochs stop at the least
    batch count and whose eval pads to the most, then the vote protocol
    over the shards (counters summed), and over 3 items (three ranks hold
    none)."""
    shard = (multihost.process_index(), multihost.process_count())
    train, evals = (_sharded_synthetic(s, 25, shard) for s in (3, 4))
    mesh = make_mesh(4, "cpu", host_sharded=True)
    cfg = TrainConfig(model="pointnet_cls_basic", batch_size=8, max_epoch=2,
                      num_point=32, ckpt_every_epochs=1, log_dir=job["log_dir"],
                      num_devices=4)
    with Trainer(cfg, device="cpu", mesh=mesh) as tr:
        state = tr.fit(train, eval_dataset=evals)
        acc = tr.eval_epoch(state, evals, epoch=9)
        fn = tr.eval_logits_fn(state)
        votes = [evaluate_cls_voting(lambda p: fn({"points": p}),
                                     _sharded_synthetic(4, n, shard),
                                     num_votes=2, num_classes=5, rng=0,
                                     log_fn=lambda m: None)
                 for n in (25, 3)]
    return {"step": state.step, "acc": acc, "len": len(train),
            "batches": train.num_batches(),
            "seen": [int(v["per_class_seen"].sum()) for v in votes],
            "params": {k: v.detach().clone()
                       for k, v in state.model.named_parameters()}}


JOBS = {"bn": bn_job, "chain": chain_job, "step": step_job, "fit": fit_job,
        "multihost": multihost_job, "uneven": uneven_job}


def rank_main(spec_path: str, out_dir: str) -> None:
    """A rank: run every job of the spec, save the results."""
    jobs = torch.load(spec_path, weights_only=False)
    out = {name: JOBS[job["kind"]](job) for name, job in jobs.items()}
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def run_ranks(jobs: dict, n: int, tmp_dir) -> list[dict]:
    """Every rank's results of ``jobs`` on n gloo ranks."""
    spec = os.path.join(str(tmp_dir), "spec.pt")
    torch.save(jobs, spec)
    rc = launch.spawn(rank_main, n, device="cpu", args=(spec, str(tmp_dir)))
    assert rc == 0, rc
    return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def exit_75_on_rank_1() -> None:
    """Rank 1 exits as the stall watchdog does; rank 0 waits for it in a
    collective that never completes."""
    if dist.get_rank() == 1:
        os._exit(75)
    dist.barrier()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def bn_inputs(seed: int = 0) -> dict:
    r = np.random.RandomState(seed)
    C = 6
    return {"kind": "bn", "x": (r.randn(8, 5, C) * 2 + 1).astype(np.float32),
            "g": r.randn(8, 5, C).astype(np.float32),
            "weight": r.uniform(0.5, 1.5, C).astype(np.float32),
            "bias": r.randn(C).astype(np.float32) * 0.1,
            "running_mean": r.randn(C).astype(np.float32) * 0.1,
            "running_var": r.uniform(0.5, 1.5, C).astype(np.float32)}


def chain_inputs(seed: int = 1) -> dict:
    """tests/test_ops_fused_mlp.py:158's chain: B = 2 a rank, M=4, S=16,
    C0=8, one dense of 8, pooled."""
    r = np.random.RandomState(seed)
    B, M, S, C0, feats = 4, 4, 16, 8, [8, 8]
    widths = [C0] + feats[1:]
    return {"kind": "chain",
            "x": r.randn(B, M, S, C0).astype(np.float32),
            "g": r.randn(B, M, feats[-1]).astype(np.float32),
            "denses": [((r.randn(o, i) / np.sqrt(i)).astype(np.float32),
                        (r.randn(o) * 0.1).astype(np.float32))
                       for i, o in zip(widths, feats[1:])],
            "scales": [r.uniform(0.5, 1.5, c).astype(np.float32)
                       for c in widths],
            "biases": [(r.randn(c) * 0.1).astype(np.float32)
                       for c in widths]}


def randomized_state_dict(model_name: str, seed: int) -> dict:
    """The model's Xavier init with its BN parameters and statistics
    redrawn (scale |s| in [0.5, 1.5], ~20% negative; bias and mean
    N(0, 0.1^2); var in [0.5, 1.5]) and its dense biases zero."""
    model = get_spec(model_name).cls(device="cpu")
    r = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.numpy().copy()
        if ".norm." in k:
            if k.endswith("weight"):
                sign = np.where(r.random(v.shape) < 0.2, -1.0, 1.0)
                v = sign * r.uniform(0.5, 1.5, v.shape)
            elif k.endswith(("bias", "running_mean")):
                v = r.normal(0.0, 0.1, v.shape)
            else:
                v = r.uniform(0.5, 1.5, v.shape)
        sd[k] = torch.from_numpy(v.astype(np.float32))
    return sd


def cls_step_inputs(sd=None, masks=None, batch=None) -> dict:
    """cls_ssg at full width, global B=4 (the last row masked), N=128."""
    r = np.random.RandomState(21)
    if batch is None:
        batch = {"points": r.rand(STEP_B, STEP_N, 3).astype(np.float32),
                 "label": r.randint(0, 40, STEP_B).astype(np.int64),
                 "mask": np.array([1, 1, 1, 0], np.float32)}
    if masks is None:
        m = np.random.RandomState(4)
        masks = {"drop1": m.rand(STEP_B, 512) < 0.5,
                 "drop2": m.rand(STEP_B, 256) < 0.5}
    return {"kind": "step", "model": CLS, "batch": batch, "masks": masks,
            "state_dict": randomized_state_dict(CLS, 9) if sd is None
            else sd}


def sem_step_inputs() -> dict:
    """sem_seg at full width, global B=4 (the last row masked), N=128,
    sem_seg's weights with zeros (tests/test_torch_seg_train.py's batch)."""
    r = np.random.RandomState(31)
    smpw = r.uniform(0.5, 2.0, (STEP_B, STEP_N)).astype(np.float32)
    smpw[0, ::3] = 0.0
    smpw[1] = 0.0
    batch = {"points": r.rand(STEP_B, STEP_N, 3).astype(np.float32),
             "seg": r.randint(0, 21, (STEP_B, STEP_N)).astype(np.int64),
             "smpw": smpw, "mask": np.array([1, 1, 1, 0], np.float32)}
    keep = np.random.RandomState(4).rand(STEP_B, STEP_N, 128) < 0.5
    return {"kind": "step", "model": SEM, "batch": batch,
            "masks": {"drop1": keep},
            "state_dict": randomized_state_dict(SEM, 9)}


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def compared(grads: dict) -> list[str]:
    """Gradient tensors that are not zero in exact arithmetic (a norm of at
    least 1e-6 of the largest): the dense biases in front of a train-mode
    BN are rounding residue on every side (tests/test_torch_train.py)."""
    norms = {k: float(np.linalg.norm(g.numpy())) for k, g in grads.items()}
    top = max(norms.values())
    return [k for k, n in norms.items() if n >= 1e-6 * top]


# ---------------------------------------------------------------------------
# the runs: 2 ranks once for this file, 4 ranks once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    jobs = {"bn": bn_inputs(), "chain": chain_inputs(),
            "cls": dict(cls_step_inputs(), float64=True),
            "sem": dict(sem_step_inputs(), float64=True),
            "fit": {"kind": "fit", "ranks": 2,
                    "log_dir": str(tmp / "fit")}}
    ranks = run_ranks(jobs, 2, tmp)
    threads = torch.get_num_threads()
    torch.set_num_threads(launch.CPU_THREADS)  # a module fixture: by hand
    try:
        one = {k: JOBS[job["kind"]](job) for k, job in jobs.items()
               if k != "fit"}
        one["fit"] = fit_job({"ranks": None, "log_dir": str(tmp / "fit1")})
    finally:
        torch.set_num_threads(threads)
    return jobs, ranks, one


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    jobs = {"mh": {"kind": "multihost"},
            "uneven": {"kind": "uneven", "log_dir": str(tmp / "uneven")}}
    return run_ranks(jobs, 4, tmp)


def _cat(ranks, key, sub=None):
    """The ranks' row shards of a result, put back in order."""
    return torch.cat([r[key] if sub is None else r[key][sub] for r in ranks])


def _close(got, want, tol: float, what: str, scale=None) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def test_cross_replica_bn_equals_global_batch(two):
    """Two ranks' BN on their rows of the batch: output, statistics, running
    update and input gradient equal one process's BN on the global batch;
    the parameter gradients summed over the ranks equal its gradients."""
    _, ranks, one = two
    want = one["bn"]
    got = [r["bn"] for r in ranks]
    _close(torch.cat([g["y"] for g in got]), want["y"], 1e-5, "y")
    _close(torch.cat([g["dx"] for g in got]), want["dx"], 1e-5, "dx")
    for k in ("mean", "var", "running_mean", "running_var"):
        for g in got:
            _close(g[k], want[k], 1e-5, k)
        assert torch.equal(got[0][k], got[1][k]), k
    for k in ("dscale", "dbias"):
        _close(got[0][k] + got[1][k], want[k], 1e-5, k)


def test_cross_replica_fused_chain_equals_global_batch(two):
    """The fused train chain on two ranks (statistics and the backward's
    T1/T2 means averaged) against the chain on the global batch: out, the
    statistics, dx within 1e-5 (tests/test_ops_fused_mlp.py:158's bounds);
    every parameter gradient summed over the ranks within 1e-5. A dense
    bias feeds a train-mode BN, which subtracts it again: its gradient is
    zero in exact arithmetic and rounding residue on both sides, held
    within 1e-5 of its dense weight's gradient."""
    _, ranks, one = two
    want = one["chain"]
    got = [r["chain"] for r in ranks]
    _close(torch.cat([g["out"] for g in got]), want["out"], 1e-5, "out")
    _close(torch.cat([g["dx"] for g in got]), want["dx"], 1e-5, "dx")
    for j, s in enumerate(want["stats"]):
        for g in got:
            _close(g["stats"][j], s, 1e-5, f"stats {j}")
    for k in ("dw", "db", "dscale", "dbias"):
        for j, w in enumerate(want[k]):
            scale = (float(want["dw"][j].abs().max()) if k == "db"
                     else None)
            _close(got[0][k][j] + got[1][k][j], w, 1e-5, f"{k} {j}", scale)


@pytest.mark.parametrize("name", ["cls", "sem"])
def test_train_step_on_two_ranks_equals_one_process(two, name):
    """One full-width train step in float64 on two ranks (the last row
    padding; for sem_seg a rank whose point weights are half zero) against
    one process's step on the global batch, the dropout masks injected on
    both sides. In float64 the collectives' summation order is all that
    differs (measured: loss 2e-16, gradients 3.5e-13 of their norms, BN
    statistics 1.6e-14), so a gradient scaled by N or 1/N, or a term left
    out, stands out by orders of magnitude. The ranks agree with each other
    bit for bit; loss within 1e-12, accuracy equal, each compared gradient
    within 1e-9 of its norm, BN statistics within rtol 1e-9 / atol 1e-12
    (JAX's own are rtol 1e-3 / atol 1e-5 in f32), and the eval counts summed
    over the ranks equal. The float32 step is held to JAX's sharded step in
    tests/test_torch_scale_out_jax.py."""
    _, ranks, one = two
    want = one[name]
    got = [r[name] for r in ranks]
    for k in ("grads", "buffers", "params"):
        for t in got[0][k]:
            assert torch.equal(got[0][k][t], got[1][k][t]), (k, t)
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    assert abs(float(got[0]["loss"]) - float(want["loss"])) <= \
        1e-12 * abs(float(want["loss"]))
    assert float(got[0]["acc"]) == float(want["acc"])
    keys = compared(want["grads"])
    assert len(keys) >= 30
    for k in keys:
        assert rel(got[0]["grads"][k], want["grads"][k]) <= 1e-9, k
    for k, b in want["buffers"].items():
        np.testing.assert_allclose(got[0]["buffers"][k].numpy(), b.numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    for a, b in zip(got[0]["counts"], want["counts"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fit_two_plus_two_epochs_equal_four_on_two_ranks(two):
    """Trainer(num_devices=2): 2 epochs, then a resume to 4 in a new
    Trainer, ends bit for bit where 4 uninterrupted epochs end, on both
    ranks (parameters, BN statistics, Adam's moments, the step and the
    generator); the two ranks hold the same state."""
    _, ranks, _ = two
    for r in ranks:
        a, b = r["fit"]["straight"], r["fit"]["resumed"]
        assert a["step"] == b["step"] == 8
        assert torch.equal(a["generator"], b["generator"])
        for group in ("params", "buffers"):
            for k in a[group]:
                assert torch.equal(a[group][k], b[group][k]), (group, k)
        for k in a["moments"]:
            for x, y in zip(a["moments"][k], b["moments"][k]):
                assert torch.equal(x, y), k
    a, b = ranks[0]["fit"]["straight"], ranks[1]["fit"]["straight"]
    assert torch.equal(a["generator"], b["generator"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_fit_on_two_ranks_follows_one_process(two):
    """The 2-rank fit against one process's on the same global batches and
    generator draws: each epoch's train loss within 1e-3 relative
    (measured 7e-5), the eval accuracy equal, and the final BN running
    variances within 1e-2 of their scale (measured 1.0e-3, fc2's, a BN over
    the batch's 4 rows; the running means follow the
    dense biases in front of each BN, whose gradients are rounding residue
    that Adam turns into steps of lr either way). The learning rate is the
    schedule's floor, 1e-5: at 1e-3 the two runs part measurably after a
    few steps on any route (even with float64 activations, the 2e-7
    relative parameter differences of two steps, float32 parameters'
    rounding of gradients summed in another order, grew to 8% of the loss
    by the fifth step on these 8 clouds), so a multi-step comparison at that
    rate would measure the model's sensitivity, not the port."""
    _, ranks, one = two
    got, want = ranks[0]["fit"]["metrics"], one["fit"]["metrics"]
    assert [(m["epoch"], m["split"]) for m in got] == \
        [(m["epoch"], m["split"]) for m in want]
    for g, w in zip(got, want):
        if g["split"] == "train":
            assert abs(g["loss"] - w["loss"]) <= 1e-3 * abs(w["loss"]), g
        else:
            assert g["accuracy"] == w["accuracy"], g
    a, b = ranks[0]["fit"]["straight"], one["fit"]["straight"]
    assert a["step"] == b["step"] == 8
    assert torch.equal(a["generator"], b["generator"])
    for k, v in b["buffers"].items():
        if k.endswith("running_var"):
            _close(a["buffers"][k], v, 1e-2, k)


def test_multihost_helpers_on_four_ranks(four):
    """sync_num_batches min/max, allreduce_sum (int64 and float64, dtype
    kept), barrier, is_primary, process_shard and local_batch_size over
    four gloo ranks."""
    for r, res in enumerate(four):
        mh = res["mh"]
        assert mh["index"] == r and mh["count"] == 4
        assert mh["primary"] == (r == 0)
        assert (mh["min"], mh["max"]) == (3, 6)
        np.testing.assert_array_equal(mh["sum_i"], np.arange(4) * 6)
        assert mh["sum_i"].dtype == np.int64
        np.testing.assert_array_equal(mh["sum_f"], np.full((2, 3), 8.0))
        assert mh["sum_f"].dtype == np.float64
        assert mh["shard"] == multihost.shard_bounds(25, r, 4)
        assert mh["local_batch"] == 2
        np.testing.assert_array_equal(mh["local"], np.arange(r + 1))


def test_four_ranks_fit_uneven_shards(four):
    """25 items over 4 host-sharded ranks (6/6/6/7; 3/3/3/4 local batches):
    train epochs run the least count (3 steps, 6 over 2 epochs), eval pads
    to the most with zero batches, the ranks end equal, and the vote
    counters summed over the ranks see all 25 items, and all 3 of a set
    that leaves three ranks with none."""
    res = [r["uneven"] for r in four]
    assert [r["len"] for r in res] == [6, 6, 6, 7]
    assert [r["batches"] for r in res] == [3, 3, 3, 4]
    for r in res:
        assert r["step"] == 6
        assert r["seen"] == [25, 3]
        assert r["acc"] == res[0]["acc"]
        for k in r["params"]:
            assert torch.equal(r["params"][k], res[0]["params"][k]), k


def test_launcher_returns_a_rank_exit_code_to_supervise():
    """A rank that exits 75 (the stall watchdog) ends the job: the launcher
    kills the rank blocked in a collective and returns 75 unchanged, and
    cli.supervise around a command that launches so restarts on it."""
    assert launch.spawn(exit_75_on_rank_1, 2, device="cpu") == 75
    from pointnet2_tpu_torch.cli.supervise import supervise

    code = ("import sys; from pointnet2_tpu_torch.parallel import launch; "
            "from tests.test_torch_scale_out import exit_75_on_rank_1 as f; "
            "sys.exit(launch.spawn(f, 2, device='cpu'))")
    logged = []
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = supervise(["env", f"PYTHONPATH={repo}", sys.executable, "-c", code],
                   max_restarts=0, backoff_secs=0.0, log_fn=logged.append)
    assert rc == 75
    assert logged == ["supervise: stalled 1 times, giving up"], logged


def test_no_fallback_without_ranks_or_cards(tmp_path):
    """num_devices=2 without a process group of two raises, in the mesh and
    in the Trainer; CUDA ranks on a host without cards raise in the
    launcher before any process starts."""
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="process group"):
        Trainer(TrainConfig(num_devices=2, log_dir=str(tmp_path)),
                device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="card"):
            launch.spawn(exit_75_on_rank_1, 2, device="cuda")


def test_predictor_shards_buckets_over_devices():
    """Predictor(num_devices=2, device="cpu"): buckets (1, 3, 8) round up
    to (2, 4, 8), and the logits of requests of 1, 3 and 11 clouds (padded
    to 2, 4, and 8 + 4) and of 2 votes equal one device's within 1e-5 of
    their scale (a shard runs the same rows)."""
    sd = randomized_state_dict(CLS, 5)
    two_dev = Predictor(CLS, sd, dtype=torch.float32, buckets=(1, 3, 8),
                        device="cpu", num_devices=2)
    assert two_dev._buckets == (2, 4, 8)
    one_dev = Predictor(CLS, sd, dtype=torch.float32, buckets=(1, 3, 8),
                        device="cpu")
    pts = np.random.RandomState(3).rand(11, 64, 3).astype(np.float32)
    for b in (1, 3, 11):
        _close(two_dev(pts[:b]), one_dev(pts[:b]), 1e-5, b)
    votes = two_dev.predict_votes(pts[:3], 2, rng=0)
    _close(votes, one_dev.predict_votes(pts[:3], 2, rng=0,
                                        on_device=False), 1e-5, "votes")


def test_cli_train_on_two_ranks_then_evaluate(tmp_path):
    """python -m pointnet2_tpu_torch.cli.train --num_devices 2 --device cpu
    --synthetic trains one epoch on two ranks (one log, one checkpoint);
    cli.evaluate reads the checkpoint in one process and on two ranks, with
    the same metrics (each rank scores all of the synthetic set, so the
    summed counters count every cloud twice: the same ratios)."""
    log = str(tmp_path / "log")
    base = ["--model", "pointnet_cls_basic", "--synthetic",
            "--synthetic_size", "1", "--num_point", "64", "--batch_size",
            "8", "--device", "cpu", "--log_dir", log]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run = lambda mod, *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", f"pointnet2_tpu_torch.cli.{mod}", *base, *a],
        capture_output=True, text=True, env=env, timeout=300)
    proc = run("train", "--max_epoch", "1", "--num_devices", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("epoch 0: train loss") == 1  # the primary's
    with open(os.path.join(log, "config.json")) as f:
        assert json.load(f)["num_devices"] == 2
    outs = []
    for flags in ([], ["--num_devices", "2"]):
        out = str(tmp_path / f"eval{len(flags)}.json")
        proc = run("evaluate", "--num_votes", "2", "--out", out, *flags)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out) as f:
            outs.append(json.load(f))
    assert outs[0]["step"] == outs[1]["step"] == 5
    assert outs[0]["metrics"]["accuracy"] == outs[1]["metrics"]["accuracy"]
    assert outs[1]["metrics"]["per_class_seen"] == [
        2 * n for n in outs[0]["metrics"]["per_class_seen"]]


def test_cli_multihost_as_torchrun_starts_it(tmp_path):
    """Two processes with torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) run cli.train --multihost and
    then cli.evaluate --multihost on the CPU: each joins the gloo group
    through multihost.initialize(), trains on local batches of 8 / 2 (the
    synthetic set is every rank's, as in the JAX package), and only the
    primary logs and writes the checkpoint and --out."""
    log = str(tmp_path / "log")
    base = ["--model", "pointnet_cls_basic", "--synthetic",
            "--synthetic_size", "1", "--num_point", "64", "--batch_size",
            "8", "--device", "cpu", "--log_dir", log, "--multihost"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(mod, *flags):
        port = str(launch.free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-m", f"pointnet2_tpu_torch.cli.{mod}", *base,
             *flags], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=repo, RANK=str(r),
                                LOCAL_RANK=str(r), WORLD_SIZE="2",
                                MASTER_ADDR="localhost", MASTER_PORT=port,
                                OMP_NUM_THREADS="1"))
            for r in range(2)]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        return [out for out, _ in outs]

    outs = run("train", "--max_epoch", "1")
    assert outs[0].count("epoch 0: train loss") == 1 and "epoch" not in \
        outs[1]
    with open(os.path.join(log, "ckpt.meta.json")) as f:
        assert json.load(f) == {"step": 10, "epoch": 1}  # 40 clouds / 4
    out = str(tmp_path / "eval.json")
    run("evaluate", "--num_votes", "1", "--out", out)
    with open(out) as f:
        record = json.load(f)
    assert record["step"] == 10
    # each rank scores all 40 synthetic clouds; the counters are summed
    assert sum(record["metrics"]["per_class_seen"]) == 80


def test_initialize_picks_the_card_by_the_local_rank(monkeypatch):
    """initialize("h:1", 8, 6) is global rank 6 of 8 (two hosts of four
    cards): without LOCAL_RANK it takes card 6 % 4 = 2, not card 6, which
    the host lacks; an explicit local_rank wins, and local_rank() (what
    make_mesh asks) answers the same afterwards."""
    cards, groups = [], []
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    monkeypatch.setattr(multihost, "_LOCAL_RANK", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: groups.append((a, kw)))
    multihost.initialize("h:1", 8, 6, backend="nccl")
    assert cards == [2]
    assert groups == [(("nccl",), {"init_method": "tcp://h:1",
                                   "world_size": 8, "rank": 6})]
    assert multihost.local_rank(6) == 2
    multihost.initialize("h:1", 8, 6, backend="nccl", local_rank=3)
    assert cards == [2, 3]
    assert multihost.local_rank(6) == 3
