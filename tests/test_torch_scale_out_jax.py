"""The port's data parallelism against the JAX package's sharded functions
on the CPU: two gloo ranks of the port (tests/test_torch_scale_out.py's
jobs) against ``shard_map`` over two of the suite's virtual devices.

- BN statistics: ``nn.layers._batch_stats`` under ``cross_replica`` against
  JAX's under ``cross_replica_bn`` (1e-5 of their scale).
- The fused train chain (plain versions; JAX's Pallas kernels in interpret
  mode): out and statistics against JAX's sharded chain, the gradients
  (summed over the ranks) against JAX's chain on the global batch, at
  tests/test_ops_fused_mlp.py:158's 1e-5.
- One train step of cls_ssg and of sem_seg in float32 (the last row
  masked, dropout masks injected on both sides; JAX's interceptor picks a
  replica's rows by ``axis_index("data")``), against JAX's
  ``make_train_step(..., mesh=make_mesh(2))`` and the port's float64 step
  on the global batch, at the bounds of
  ``test_cls_ssg_train_step_matches_jax`` and
  ``test_seg_train_step_matches_jax``.
- ``Predictor(num_devices=2, device="cpu")`` against JAX's
  ``Predictor(num_devices=2)``; ``shard_bounds`` and the H5 reader's
  ``process_shard`` against JAX's.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pointnet2_tpu import serving as jserving
from pointnet2_tpu.data.modelnet import ModelNetH5Dataset as JaxH5Dataset
from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.nn import layers as jlayers
from pointnet2_tpu.ops.pallas import fused_mlp as jfm
from pointnet2_tpu.parallel import multihost as jmultihost
from pointnet2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pointnet2_tpu.parallel.mesh import shard_batch as jax_shard_batch
from pointnet2_tpu.train import schedules as jsched
from pointnet2_tpu.train.state import TrainState as JaxTrainState
from pointnet2_tpu.train.state import make_optimizer as jax_make_optimizer
from pointnet2_tpu.train.steps import make_train_step
from pointnet2_tpu_torch import Predictor, flax_to_torch
from pointnet2_tpu_torch.data import ModelNetH5Dataset
from pointnet2_tpu_torch.parallel import multihost
from tests import test_torch_seg_train as seg
from tests.test_torch_model import _jax_init, _randomize
from tests.test_torch_scale_out import (  # noqa: F401 (one_thread)
    EPS,
    _close,
    bn_inputs,
    chain_inputs,
    one_thread,
    rel,
    run_ranks,
)
from tests.test_torch_train import _zero_dense_biases, jax_step_setup

CLS, SEM = "pointnet2_cls_ssg", "pointnet2_sem_seg"
pytestmark = pytest.mark.usefixtures("one_thread")


def _mesh2():
    return jax_make_mesh(2)


def _jax_mesh_step(name: str, variables, batch: dict, masks: dict):
    """JAX's data-parallel step on 2 virtual devices: Adam on the default
    schedules at step 0, each dropout layer's global mask (by width)
    cut to the replica's rows. Returns (loss, accuracy, gradients as the
    port's state_dict, new BN statistics as the port's state_dict)."""
    spec = JAX_REGISTRY[name]
    model = spec.cls()
    B = batch["points"].shape[0]
    tx = jax_make_optimizer("adam", jsched.exponential_decay_clipped(
        1e-3, B, 200000, 0.7))
    mesh = _mesh2()
    step = make_train_step(model, spec.loss, tx,
                           jsched.bn_momentum_schedule(B, 200000),
                           task=spec.task, mesh=mesh)

    def dropout(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            keep = jnp.asarray(masks[x.shape[-1]])
            b = x.shape[0]
            rows = jax.lax.dynamic_slice_in_dim(
                keep, jax.lax.axis_index("data") * b, b, axis=0)
            return jnp.where(rows, x / 0.5, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params))
    with fnn.intercept_methods(dropout):
        new, metrics = step(state, jax_shard_batch(mesh, batch),
                            jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                                   new.opt_state[0].mu)
    return (float(metrics["loss"]), float(metrics["accuracy"]),
            flax_to_torch({"params": grads}),
            flax_to_torch({"batch_stats": to_np(new.batch_stats)}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 2-rank runs of the BN, the chain, and the cls_ssg and
    sem_seg steps on JAX's inputs, and the references: the float64 steps
    and the JAX package's sharded steps."""
    cls = jax_step_setup()
    sem_batch = seg._batch(SEM)
    sem_vars = _randomize(_jax_init(JAX_REGISTRY[SEM].cls(),
                                    jnp.asarray(sem_batch["points"]),
                                    train=False), seed=9)
    _zero_dense_biases(sem_vars["params"])
    keep = np.random.RandomState(4).rand(seg.B, seg.N, seg.DROP_WIDTH) < 0.5
    sem = {"batch": sem_batch, "variables": sem_vars, "keep": keep}
    sem["loss64"], sem["grads64"], sem["buffers64"] = seg._float64_step(
        SEM, sem_vars, sem_batch, keep)
    jobs = {"bn": bn_inputs(), "chain": chain_inputs(),
            "cls": {"kind": "step", "model": CLS, "batch": cls["batch"],
                    "state_dict": flax_to_torch(cls["variables"]),
                    "masks": {"drop1": cls["masks"][512],
                              "drop2": cls["masks"][256]}},
            "sem": {"kind": "step", "model": SEM, "batch": sem_batch,
                    "state_dict": flax_to_torch(sem_vars),
                    "masks": {"drop1": keep}}}
    ranks = run_ranks(jobs, 2, tmp_path_factory.mktemp("ranks"))
    cls["jax"] = _jax_mesh_step(CLS, cls["variables"], cls["batch"],
                                cls["masks"])
    sem["jax"] = _jax_mesh_step(SEM, sem_vars, sem_batch,
                                {seg.DROP_WIDTH: keep})
    return jobs, ranks, {"cls": cls, "sem": sem}


def test_bn_statistics_equal_jax_shard_map(runs):
    """(mean, var) of two ranks' cross-replica BN against JAX's
    ``_batch_stats`` under ``shard_map`` with the BN axis set."""
    jobs, ranks, _ = runs
    mesh = _mesh2()

    def stats(x):
        with jlayers.cross_replica_bn("data"):
            return jlayers._batch_stats(x, True)

    f = jax.jit(jax.shard_map(stats, mesh=mesh, in_specs=P("data"),
                              out_specs=P(), check_vma=False))
    mean, var = f(jnp.asarray(jobs["bn"]["x"]))
    for r in ranks:
        _close(r["bn"]["mean"], mean, 1e-5, "mean")
        _close(r["bn"]["var"], var, 1e-5, "var")


def test_fused_chain_equals_jax_sharded_chain(runs):
    """The port's fused train chain on two ranks against JAX's chain
    sharded over two devices (out, statistics), and its gradients summed
    over the ranks against JAX's chain on the global batch (a dense bias
    in front of a BN: rounding residue, within 1e-5 of its weight's
    gradient)."""
    jobs, ranks, _ = runs
    job = jobs["chain"]
    x = jnp.asarray(job["x"])
    denses = tuple((jnp.asarray(w.T), jnp.asarray(b))
                   for w, b in job["denses"])
    scales = tuple(jnp.asarray(s) for s in job["scales"])
    biases = tuple(jnp.asarray(b) for b in job["biases"])
    cfg = jfm.ChainConfig(eps=EPS, axis_name="data", pool=True)
    sharded = jax.jit(jax.shard_map(
        lambda x, d, s, b: jfm.fused_chain_train(cfg, x, d, s, b),
        mesh=_mesh2(), in_specs=(P("data"), P(), P(), P()),
        out_specs=(P("data"), P()), check_vma=False))
    out, stats = sharded(x, denses, scales, biases)
    got = [r["chain"] for r in ranks]
    _close(torch.cat([g["out"] for g in got]), out, 1e-5, "out")
    for j, (m, v) in enumerate(stats):
        for g in got:
            _close(g["stats"][j], np.stack([m, v]), 1e-5, f"stats {j}")

    cfg_g = jfm.ChainConfig(eps=EPS, axis_name=None, pool=True)

    def loss(x, d, s, b):
        o, _ = jfm.fused_chain_train(cfg_g, x, d, s, b)
        return jnp.sum(o * jnp.asarray(job["g"]))

    dx, dd, ds, db = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        x, denses, scales, biases)
    _close(torch.cat([g["dx"] for g in got]), dx, 1e-5, "dx")
    for j, (dw, dbias) in enumerate(dd):
        _close(got[0]["dw"][j] + got[1]["dw"][j], np.asarray(dw).T, 1e-5,
               f"dw {j}")
        _close(got[0]["db"][j] + got[1]["db"][j], dbias, 1e-5, f"db {j}",
               float(np.abs(dw).max()))
    for j in range(len(ds)):
        _close(got[0]["dscale"][j] + got[1]["dscale"][j], ds[j], 1e-5,
               f"dscale {j}")
        _close(got[0]["dbias"][j] + got[1]["dbias"][j], db[j], 1e-5,
               f"dbias {j}")


# (loss: port vs float64, JAX vs float64, port vs JAX; gradients: port vs
# float64, JAX vs float64; statistics: port, JAX; against float64)
BOUNDS = {"cls": (1e-5, 1e-4, 1e-4, 1e-3, 5e-2, 1e-4, 1e-3),
          "sem": (1e-5, 1e-4, 1e-4, 3e-2, 0.3, 1e-4, 2e-3)}


@pytest.mark.parametrize("name", ["cls", "sem"])
def test_train_step_on_two_ranks_matches_jax_mesh_step(runs, name):
    """One float32 step on two ranks against JAX's step over a 2-device
    mesh and the port's float64 step on the global batch: loss, accuracy,
    every gradient that is not zero in exact arithmetic and the new BN
    running statistics, at the single-device tests' bounds (``BOUNDS``:
    tests/test_torch_train.py's test_cls_ssg_train_step_matches_jax and
    tests/test_torch_seg_train.py's test_seg_train_step_matches_jax)."""
    _, ranks, refs = runs
    ref = refs[name]
    lp, lj, lpj, gp, gj, bp, bj = BOUNDS[name]
    got = ranks[0][name]
    jloss, jacc, jgrads, jstats = ref["jax"]
    loss64 = ref["loss64"]
    assert abs(float(got["loss"]) - loss64) <= lp * loss64
    assert abs(jloss - loss64) <= lj * loss64
    assert abs(float(got["loss"]) - jloss) <= lpj * loss64
    assert float(got["acc"]) == pytest.approx(jacc, abs=1e-6)
    norms = {k: np.linalg.norm(g) for k, g in ref["grads64"].items()}
    top = max(norms.values())
    keys = [k for k, n in norms.items() if n >= 1e-6 * top]
    assert len(keys) >= 30
    for k in keys:
        assert rel(got["grads"][k], ref["grads64"][k]) <= gp, k
        assert rel(jgrads[k], ref["grads64"][k]) <= gj, k
    for k, want in ref["buffers64"].items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(got["buffers"][k].numpy(), want, rtol=0,
                                   atol=bp * scale, err_msg=k)
        np.testing.assert_allclose(jstats[k].numpy(), want, rtol=0,
                                   atol=bj * scale, err_msg=k)


def test_predictor_on_two_devices_equals_jax():
    """Predictor(num_devices=2) of both packages on the same weights:
    buckets (1, 3, 8) round up to (2, 4, 8), and the f32 logits of 1, 3
    and 11 clouds agree within 1e-4 of their scale."""
    pts = np.random.RandomState(2).rand(11, 128, 3).astype(np.float32)
    variables = _randomize(_jax_init(JAX_REGISTRY[CLS].cls(),
                                     jnp.asarray(pts[:2]), train=False),
                           seed=3)
    theirs = jserving.Predictor(CLS, variables, dtype=None,
                                buckets=(1, 3, 8), num_devices=2)
    ours = Predictor(CLS, variables, dtype=torch.float32, buckets=(1, 3, 8),
                     device="cpu", num_devices=2)
    assert ours._buckets == theirs._buckets == (2, 4, 8)
    for b in (1, 3, 11):
        _close(ours(pts[:b]), theirs(pts[:b]), 1e-4, b)


def test_shard_bounds_equal_jax():
    """shard_bounds for several (n, count), n < count among them, and the
    one-process process_shard and local_batch_size."""
    for n in (0, 1, 3, 7, 25, 100):
        for count in (1, 2, 3, 4, 8):
            for r in range(count):
                assert multihost.shard_bounds(n, r, count) == \
                    jmultihost.shard_bounds(n, r, count)
        assert multihost.process_shard(n) == jmultihost.process_shard(n)
    assert multihost.local_batch_size(16) == jmultihost.local_batch_size(16)


def test_modelnet_h5_process_shard_equals_jax(tmp_path):
    """The H5 reader's process_shard: each share's batches are JAX's, bit
    for bit, and the shares make up the set (11 clouds over 2 and 4
    processes; 3 over 4, which leaves three shares empty)."""
    import h5py

    r = np.random.RandomState(0)
    for n_items in (11, 3):
        name = tmp_path / f"d{n_items}.h5"
        with h5py.File(name, "w") as f:
            f["data"] = r.rand(n_items, 40, 3).astype(np.float32)
            f["label"] = r.randint(0, 40, (n_items, 1)).astype(np.uint8)
        lst = tmp_path / f"files{n_items}.txt"
        lst.write_text(f"{name.name}\n")
        for count in (2, 4):
            labels = []
            for rank in range(count):
                kw = dict(batch_size=2, npoints=32, seed=5,
                          process_shard=(rank, count))
                ours, theirs = (ModelNetH5Dataset(str(lst), **kw),
                                JaxH5Dataset(str(lst), **kw))
                for a, b in zip(ours.epoch(True), theirs.epoch(True),
                                strict=True):
                    assert a["nvalid"] == b["nvalid"]
                    np.testing.assert_array_equal(a["points"], b["points"])
                    np.testing.assert_array_equal(a["label"], b["label"])
                labels.append(ours.label)
            assert [len(lb) for lb in labels].count(0) == (
                3 if (n_items, count) == (3, 4) else 0)
            np.testing.assert_array_equal(
                np.concatenate(labels), ModelNetH5Dataset(str(lst)).label)
