"""K train steps a call (``TrainConfig.steps_per_call``) and the optimizer
and BN scalars a CUDA graph reads from the device, on the CPU.

On the CPU ``TrainMultiStep`` runs K eager steps, so these tests hold the
K-step path (the trainer's buffer-and-flush loop, its eager remainder, the
scalars read from a tensor) to single steps bit for bit, and JAX's
``make_train_multi_step`` (a ``lax.scan`` of two steps) to the port's two
steps the way tests/test_torch_train.py holds one step: both against a
float64 run of the port, on the same converted weights, batches and
dropout masks (``lax.scan`` traces its body once, so the masks injected
through flax's method interceptor are the same in both of JAX's steps; the
port's two steps get the same ones). The graph itself is captured and
replayed only on the card (chip_smoke.py phase 28).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.models import PointNet2ClsSSG as JaxClsSSG
from pointnet2_tpu.models.losses import classification_loss as jax_cls_loss
from pointnet2_tpu.train import schedules as jsched
from pointnet2_tpu.train.state import TrainState as JaxTrainState
from pointnet2_tpu.train.state import make_optimizer as jax_make_optimizer
from pointnet2_tpu.train.steps import make_train_multi_step
from pointnet2_tpu_torch import flax_to_torch
from pointnet2_tpu_torch.data import (
    ScannetDataset,
    SyntheticClassification,
    make_synthetic_scenes,
)
from pointnet2_tpu_torch.models.losses import classification_loss
from pointnet2_tpu_torch.nn.layers import BatchNorm
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train import schedules as tsched
from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.train.steps import TrainMultiStep, step_scalars
from tests.test_torch_checkpoint import _assert_same, _snapshot
from tests.test_torch_model import _jax_init, _randomize
from tests.test_torch_train import (
    STEP_B,
    STEP_N,
    _dropout_masks,
    _port_model,
    _rel,
    _zero_dense_biases,
)



@pytest.fixture
def one_thread():
    """These steps' tensors are tiny: one intra-op thread runs them as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")

# ---------------------------------------------------------------------------
# the scalars of a step, from a tensor
# ---------------------------------------------------------------------------

_F32 = np.float32


def _python_scalar_update(name, params, grads, moments, lr, count):
    """The update with every per-step scalar a python float, as the
    optimizer computed it before its scalars moved into a tensor: optax's
    float32 order, out of place."""
    c = lambda v: float(_F32(v))  # noqa: E731
    if name == "momentum":
        trace = torch._foreach_add(torch._foreach_mul(moments[0], c(0.9)),
                                   grads)
        upd = torch._foreach_mul(trace, -c(lr))
        return torch._foreach_add(params, upd), [trace]
    mu = torch._foreach_mul(grads, c(0.1))
    torch._foreach_add_(mu, torch._foreach_mul(moments[0], c(0.9)))
    nu = torch._foreach_mul(torch._foreach_mul(grads, grads), c(1 - 0.999))
    torch._foreach_add_(nu, torch._foreach_mul(moments[1], c(0.999)))
    t = _F32(count + 1)
    bc1 = float(_F32(1) - np.power(_F32(0.9), t))
    bc2 = float(_F32(1) - np.power(_F32(0.999), t))
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, c(1e-8))
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    upd = torch._foreach_mul(upd, -c(lr))
    return torch._foreach_add(params, upd), [mu, nu]


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_optimizer_scalars_from_a_tensor_equal_python_floats(name):
    """Five updates reading -lr and the bias corrections from a tensor,
    the moments updated in place, give the bits of the same updates with
    python-float scalars, on a schedule whose lr changes every step."""
    r = np.random.RandomState(3)
    params = [torch.from_numpy(r.randn(*s).astype(np.float32))
              .requires_grad_() for s in ((7, 5), (5,), (3, 2, 4))]
    lr = lambda count: _F32(1e-3) * _F32(0.7) ** _F32(count)  # noqa: E731
    opt = make_optimizer(name, params, lr)
    moment_ids = [id(t) for k in opt.MOMENTS for t in getattr(opt, k)]
    want_p = [p.detach().clone() for p in params]
    want_m = [torch.zeros_like(p) for p in params for _ in opt.MOMENTS]
    want_m = [want_m[i::len(opt.MOMENTS)] for i in range(len(opt.MOMENTS))]
    for count in range(5):
        grads = [torch.from_numpy(r.randn(*p.shape).astype(np.float32))
                 for p in params]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        want_p, want_m = _python_scalar_update(name, want_p, grads, want_m,
                                               lr(count), count)
        for p, w in zip(params, want_p):
            assert torch.equal(p.detach(), w), count
        for k, ws in zip(opt.MOMENTS, want_m):
            for m, w in zip(getattr(opt, k), ws):
                assert torch.equal(m, w), (k, count)
    assert opt.count == 5
    assert [id(t) for k in opt.MOMENTS for t in getattr(opt, k)] == moment_ids


def test_bn_momentum_tensor_updates_like_the_float():
    """update_stats with the momentum as a 0-d float32 tensor folds the
    batch statistics into the same bits as with the number, 1 - m rounded
    alike, and leaves the running buffers where they were."""
    r = np.random.RandomState(5)
    mean, var = (torch.from_numpy(r.rand(33).astype(np.float32))
                 for _ in range(2))
    for m in (0.5, 0.51234567, 0.99):
        a, b = BatchNorm(33), BatchNorm(33)
        ptr = b.running_mean.data_ptr()
        a.update_stats(mean, var, m)
        b.update_stats(mean, var, torch.tensor(_F32(m)))
        assert torch.equal(a.running_mean, b.running_mean)
        assert torch.equal(a.running_var, b.running_var)
        assert b.running_mean.data_ptr() == ptr


def test_step_scalars_follow_the_schedules():
    """[BN momentum at step, -lr, 1 - 0.9^t, 1 - 0.999^t] of the step
    ``ahead`` steps on, as float32."""
    model = torch.nn.Linear(2, 2)
    lr = tsched.exponential_decay_clipped(1e-3, 16, 64, 0.7)
    bn = tsched.bn_momentum_schedule(16, 64)
    state = TrainState(step=3, model=model,
                       optimizer=make_optimizer("adam", model.parameters(),
                                                lr))
    state.optimizer.count = 3
    got = step_scalars(state, bn, ahead=2)
    want = np.array([bn(5), -lr(5), _F32(1) - _F32(0.9) ** _F32(6),
                     _F32(1) - _F32(0.999) ** _F32(6)], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# K steps a call against single steps
# ---------------------------------------------------------------------------


def _cls_data():
    """6 batches of 4 clouds of 32 points (the last padded)."""
    return SyntheticClassification(num_classes=4, samples_per_class=6,
                                   npoints=32, batch_size=4, seed=0), "cls"


def _sem_data():
    """6 batches of 2 crops of 32 points of 11 generated rooms (the last
    padded)."""
    return ScannetDataset(scenes=make_synthetic_scenes(11, 1000, seed=1),
                          npoints=32, batch_size=2, seed=0), "scannet"


MODELS = {"pointnet2_cls_ssg": _cls_data, "pointnet2_sem_seg": _sem_data}


def _epoch(tmp_path, name, K, **kw):
    data, augment = MODELS[name]()
    cfg = TrainConfig(model=name, num_point=32,
                      batch_size=data.batch_size, augment=augment,
                      steps_per_call=K, log_dir=str(tmp_path / f"K{K}"),
                      **kw)
    with Trainer(cfg, device="cpu") as tr:
        state = tr.train_epoch(tr.init_state(), data, 0)
        got = _snapshot(tr, state)
    rows = (tmp_path / f"K{K}" / "metrics.jsonl").read_text()
    return got, rows.split('"examples_per_sec"')[0]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_k_steps_equal_single_steps(tmp_path, name):
    """An epoch of 6 batches with steps_per_call=4 (one K-step call of 4,
    then 2 single steps) ends bit for bit where 6 single steps end:
    parameters, BN statistics, Adam's moments, count, step and the
    generator, with dropout and the on-device augmentation drawing from it;
    the epoch's logged loss and accuracy are the same too."""
    want, want_row = _epoch(tmp_path, name, 1)
    got, got_row = _epoch(tmp_path, name, 4)
    assert got["step"] == 6
    _assert_same(got, want)
    assert got_row == want_row


def test_k_step_call_returns_each_steps_metrics(tmp_path):
    """One call of K=3 (pointnet_cls_basic): (3,) loss and accuracy, each
    step's own."""
    data, _ = _cls_data()
    cfg = TrainConfig(model="pointnet_cls_basic", num_point=32,
                      batch_size=4, augment="cls",
                      log_dir=str(tmp_path))
    batches = [Trainer._host_view(b) for b in list(data.epoch())[:3]]
    outs = []
    with Trainer(cfg, device="cpu") as tr:
        for K in (3, 1):
            step = TrainMultiStep(tr.init_state(), tr.loss_fn,
                                  tr.bn_schedule, tr.augment_fn,
                                  torch.Generator().manual_seed(1), "cls")
            outs.append(step(batches) if K == 3 else
                        [step([b]) for b in batches])
    got, singles = outs
    assert got["loss"].shape == got["accuracy"].shape == (3,)
    assert torch.equal(got["loss"], torch.cat([s["loss"] for s in singles]))
    assert torch.equal(got["accuracy"],
                       torch.cat([s["accuracy"] for s in singles]))


def test_k_steps_resume_two_plus_two(tmp_path):
    """steps_per_call=2 over 3 batches an epoch (a call and a single step):
    2 epochs, stop, resume to 4 in a new Trainer ends bit for bit where 4
    uninterrupted epochs of single steps end (pointnet_cls_basic: BN and
    dropout, a fraction of cls_ssg's work)."""
    def data():
        return (SyntheticClassification(num_classes=4, samples_per_class=3,
                                        npoints=32, batch_size=4, seed=0),
                SyntheticClassification(num_classes=4, samples_per_class=1,
                                        npoints=32, batch_size=4, seed=1))

    def trainer(d, K):
        return Trainer(TrainConfig(model="pointnet_cls_basic", batch_size=4,
                                   num_point=32, max_epoch=4,
                                   augment="cls", steps_per_call=K, seed=3,
                                   log_dir=str(tmp_path / d)), device="cpu")

    train, evals = data()
    with trainer("straight", 1) as tr:
        want = _snapshot(tr, tr.fit(train, eval_dataset=evals))
    train, evals = data()
    with trainer("resumed", 2) as tr:
        assert tr.fit(train, eval_dataset=evals, max_epoch=2).step == 6
    with trainer("resumed", 2) as tr:
        got = _snapshot(tr, tr.fit(train, eval_dataset=evals))
    assert got["step"] == 12
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# two steps against JAX's make_train_multi_step
# ---------------------------------------------------------------------------


def _two_batches():
    r = np.random.RandomState(22)
    return [{"points": r.rand(STEP_B, STEP_N, 3).astype(np.float32),
             "label": r.randint(0, 40, STEP_B).astype(np.int64),
             "mask": np.array([1, 1, 1, 0], np.float32)} for _ in range(2)]


@pytest.fixture(scope="module")
def jax_two_steps():
    """JAX's make_train_multi_step on two stacked batches (B=4, N=128, the
    last row masked, augmentation off), Adam at lr 0 with the default BN
    momentum schedule from step 0, on randomised BN parameters and
    statistics, the dropout masks injected; numpy outputs.

    At lr 0 both steps run on the same weights. A second step from the
    first one's update is ill-conditioned at these random weights: at the
    default lr (1e-3) the second step's losses of JAX, the port in float32
    and the port in float64 read 5.761, 5.895 and 5.876 (with SGD; the
    first step's agree within 1.5e-6), so it would compare rounding. What
    is compared is what the scan threads through its steps: each step's
    batch, its BN momentum (the running statistics after both), Adam's
    first moment (0.09 g1 + 0.1 g2) and the count."""
    batches = _two_batches()
    model = JaxClsSSG()
    variables = _randomize(_jax_init(
        model, jnp.asarray(batches[0]["points"]), train=False), seed=9)
    _zero_dense_biases(variables["params"])
    masks = _dropout_masks(4)
    tx = jax_make_optimizer("adam", lambda count: 0.0)
    step = make_train_multi_step(model, jax_cls_loss, tx,
                                 jsched.bn_momentum_schedule(STEP_B, 200000))

    def dropout(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            keep = jnp.asarray(masks[x.shape[-1]])
            return jnp.where(keep, x / 0.5, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params))
    stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    stacked["label"] = stacked["label"].astype(jnp.int32)
    with fnn.intercept_methods(dropout):
        new, metrics = step(state, stacked, jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"batches": batches, "variables": variables, "masks": masks,
            "loss": np.asarray(metrics["loss"]),
            "acc": np.asarray(metrics["accuracy"]),
            "step": int(new.step),
            "mu": flax_to_torch({"params": to_np(new.opt_state[0].mu)}),
            "stats": flax_to_torch({"params": to_np(new.params),
                                    "batch_stats": to_np(new.batch_stats)})}


def _port_two_steps(setup, float64: bool):
    model = _port_model(setup)
    if float64:
        model = model.double()
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer("adam", model.parameters(),
                                                lambda count: _F32(0)))
    batches = setup["batches"]
    if float64:
        batches = [dict(b, points=b["points"].astype(np.float64),
                        mask=b["mask"].astype(np.float64)) for b in batches]
    step = TrainMultiStep(state, classification_loss,
                          tsched.bn_momentum_schedule(STEP_B, 200000))
    metrics = step(batches)
    return state, metrics


def test_two_steps_match_jax_multi_step(jax_two_steps):
    """Both steps' losses, Adam's first moment after the two (0.09 g1 +
    0.1 g2, every tensor whose float64 moment is not rounding residue) and
    the running statistics, against JAX's two scanned steps and a float64
    run of the port, with test_cls_ssg_train_step_matches_jax's bounds
    but one: the port within 1e-5 (loss), 5e-3 (moment) and 1e-4
    (statistics) of float64, JAX within 1e-4, 5e-2 and 1e-3; the
    parameters stay where they were (lr 0). Measured: the port's moments
    within 2.4e-3 (the second batch's BN biases; the first step's
    gradients alone hold 2e-4), JAX's within 2.0e-2; a missing or doubled
    step reads O(1)."""
    setup = jax_two_steps
    state, metrics = _port_two_steps(setup, float64=False)
    ref, ref_metrics = _port_two_steps(setup, float64=True)
    assert state.step == ref.step == setup["step"] == 2
    loss64 = ref_metrics["loss"].numpy()
    got = metrics["loss"].numpy()
    assert np.all(np.abs(got - loss64) <= 1e-5 * loss64), (got, loss64)
    assert np.all(np.abs(setup["loss"] - loss64) <= 1e-4 * loss64)
    np.testing.assert_array_equal(metrics["accuracy"].numpy(), setup["acc"])
    mu = dict(zip((k for k, _ in state.model.named_parameters()),
                  state.optimizer.mu))
    mu64 = dict(zip((k for k, _ in ref.model.named_parameters()),
                    ref.optimizer.mu))
    norms = {k: float(np.linalg.norm(m.numpy())) for k, m in mu64.items()}
    compared = [k for k, n in norms.items() if n >= 1e-6 * max(norms.values())]
    assert len(compared) >= 30
    for k in compared:
        assert _rel(mu[k].numpy(), mu64[k].numpy()) <= 5e-3, k
        assert _rel(setup["mu"][k].numpy(), mu64[k].numpy()) <= 5e-2, k
    old = flax_to_torch(setup["variables"])
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), old[k]), k
    for k, b in state.model.named_buffers():
        want = dict(ref.model.named_buffers())[k].numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(b.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(setup["stats"][k].numpy(), want, rtol=0,
                                   atol=1e-3 * scale, err_msg=k)
