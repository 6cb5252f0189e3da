"""The port's training path held against the JAX package on the CPU.

The same numpy inputs (from seeds) go through pointnet2_tpu and
pointnet2_tpu_torch: schedules, optimizers, augmentation transforms on the
same parameters, the loss, train-mode BatchNorm, one full-width
pointnet2_cls_ssg train step on the same weights, batch and dropout masks,
the H5 loader on a file the test writes, an overfit run of the Trainer, and
the trained weights served through Predictor. Randomness that the two
frameworks draw differently (dropout masks, augmentation parameters) is
injected on both sides.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnet2_tpu import config as jax_config
from pointnet2_tpu import nn as jnn
from pointnet2_tpu.data import augment_jax
from pointnet2_tpu.data.modelnet import ModelNetH5Dataset as JaxH5Dataset
from pointnet2_tpu.data.synthetic import (
    SyntheticClassification as JaxSynthetic,
)
from pointnet2_tpu.models import PointNet2ClsSSG as JaxClsSSG
from pointnet2_tpu.models.losses import classification_loss as jax_cls_loss
from pointnet2_tpu.train import schedules as jsched
from pointnet2_tpu.train.state import TrainState as JaxTrainState
from pointnet2_tpu.train.state import make_optimizer as jax_make_optimizer
from pointnet2_tpu.train.steps_body import run_one_step as jax_run_one_step
from pointnet2_tpu_torch import Predictor, flax_to_torch
from pointnet2_tpu_torch import nn as tnn
from pointnet2_tpu_torch.data import ModelNetH5Dataset, SyntheticClassification
from pointnet2_tpu_torch.data import augment_device as aug
from pointnet2_tpu_torch.models import PointNet2ClsSSG
from pointnet2_tpu_torch.models.losses import classification_loss
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train import schedules as tsched
from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.train.steps import run_one_step
from tests.test_torch_model import _jax_init, _randomize


def _bn_fed_bias(name: str) -> bool:
    """A dense bias that feeds a train-mode BN (every dense but fc3's): BN
    subtracts the batch mean, so its gradient is zero in exact arithmetic
    and what either side computes is the rounding residue of cancelling
    sums. Adam turns that residue into an update of up to lr either way,
    which the next BN subtracts again."""
    return name.endswith("dense.bias") and not name.startswith("fc3.")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------


def test_schedules_equal_jax_bit_for_bit():
    """Both schedules over steps 0..10^6 (16 examples a step, decay every
    200000 examples: 81 staircase levels), equal as float32 bits."""
    steps = np.arange(0, 10 ** 6 + 1, dtype=np.int32)
    for jfn, tfn in (
            (jsched.exponential_decay_clipped(1e-3, 16, 200000, 0.7),
             tsched.exponential_decay_clipped(1e-3, 16, 200000, 0.7)),
            (jsched.bn_momentum_schedule(16, 200000, 0.5, 0.5, 0.99),
             tsched.bn_momentum_schedule(16, 200000, 0.5, 0.5, 0.99))):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(steps)))
        got = tfn(steps)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert tfn(12345) == want[12345]


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_optimizer_updates_equal_optax(rng, name):
    """Three updates on the same gradients from the same parameters, with
    a scheduled LR, against optax; the port writes optax's float32
    operations in optax's order: equal to the last bit, or within one ulp
    where XLA contracts a multiply-add."""
    shapes = [(5, 3), (7,), (2, 4, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    sched_j = jsched.exponential_decay_clipped(1e-2, 16, 32, 0.7)
    sched_t = tsched.exponential_decay_clipped(1e-2, 16, 32, 0.7)
    tx = jax_make_optimizer(name, sched_j)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(name, tp, sched_t)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    assert opt.count == 3
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=2 ** -23, atol=0)


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))],
                       lambda s: 1e-3)


# ---------------------------------------------------------------------------
# augmentation on the same parameters
# ---------------------------------------------------------------------------


def _points(rng, B=3, N=50, C=3):
    return rng.randn(B, N, C).astype(np.float32)


# f32 rotations: matmul summation order and FMA differ between XLA and
# PyTorch (last-ulp on unit-scale coordinates)
AUG_TOL = 1e-6


@pytest.mark.parametrize("C", [3, 6])
def test_augment_transforms_match_jax(rng, C):
    """Each transform of the cls chain on parameters drawn by the JAX
    package's own calls from one key, against the JAX transform."""
    x = _points(rng, C=C)
    B, N = x.shape[:2]
    key = jax.random.PRNGKey(3)
    tx = torch.from_numpy(x)
    cases = [
        (augment_jax.rotate_y, aug.rotate_y,
         jax.random.uniform(key, (B,), maxval=2 * jnp.pi)),
        (augment_jax.rotate_perturbation, aug.rotate_perturbation,
         jnp.clip(0.06 * jax.random.normal(key, (B, 3)), -0.18, 0.18)),
        (augment_jax.random_scale, aug.random_scale,
         jax.random.uniform(key, (B, 1, 1), minval=0.8, maxval=1.25)),
        (augment_jax.shift, aug.shift,
         jax.random.uniform(key, (B, 1, 3), minval=-0.1, maxval=0.1)),
        (augment_jax.jitter, aug.jitter,
         jnp.clip(0.01 * jax.random.normal(key, (B, N, 3)), -0.05, 0.05)),
        (augment_jax.shuffle_points, aug.shuffle_points,
         jax.random.permutation(key, N)),
    ]
    for jfn, tfn, params in cases:
        want = np.asarray(jfn(key, jnp.asarray(x)))
        got = tfn(tx, torch.from_numpy(np.array(params)))
        np.testing.assert_allclose(got.numpy(), want, rtol=AUG_TOL,
                                   atol=AUG_TOL, err_msg=jfn.__name__)


def test_augment_cls_chain_matches_jax(rng):
    """The whole chain, parameters drawn as augment_jax.augment_cls draws
    them (six split keys, in order)."""
    x = _points(rng, B=4, N=64)
    B, N = x.shape[:2]
    ks = jax.random.split(jax.random.PRNGKey(11), 6)
    params = [
        jax.random.uniform(ks[0], (B,), maxval=2 * jnp.pi),
        jnp.clip(0.06 * jax.random.normal(ks[1], (B, 3)), -0.18, 0.18),
        jax.random.uniform(ks[2], (B, 1, 1), minval=0.8, maxval=1.25),
        jax.random.uniform(ks[3], (B, 1, 3), minval=-0.1, maxval=0.1),
        jnp.clip(0.01 * jax.random.normal(ks[4], (B, N, 3)), -0.05, 0.05),
        jax.random.permutation(ks[5], N),
    ]
    want = np.asarray(augment_jax.augment_cls(jax.random.PRNGKey(11),
                                              jnp.asarray(x)))
    got = torch.from_numpy(x)
    for (_, apply), p in zip(aug.CLS_CHAIN, params):
        got = apply(got, torch.from_numpy(np.array(p)))
    np.testing.assert_allclose(got.numpy(), want, rtol=AUG_TOL, atol=AUG_TOL)


def test_augment_cls_draws_from_the_generator(rng):
    """Same generator seed, same augmented batch; the draws stay in their
    documented ranges; a rotation keeps norms."""
    x = torch.from_numpy(_points(rng, B=4, N=32))
    a = aug.augment_cls(torch.Generator().manual_seed(1), x)
    b = aug.augment_cls(torch.Generator().manual_seed(1), x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.Generator().manual_seed(2)
    assert aug.draw_rotate_perturbation(g, x).abs().max() <= 0.18
    s = aug.draw_random_scale(g, x)
    assert ((s >= 0.8) & (s <= 1.25)).all()
    assert aug.draw_jitter(g, x).abs().max() <= 0.05
    assert sorted(aug.draw_shuffle_points(g, x).tolist()) == list(range(32))
    r = aug.rotate_y(x, aug.draw_rotate_y(g, x))
    torch.testing.assert_close(r.norm(dim=-1), x.norm(dim=-1), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# loss and train-mode BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_classification_loss_matches_jax(rng, weighted):
    logits = (3 * rng.randn(6, 40)).astype(np.float32)
    labels = rng.randint(0, 40, 6).astype(np.int32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    want = jax_cls_loss(jnp.asarray(logits), jnp.asarray(labels), jw)
    got = classification_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels), tw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    num, den = classification_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), tw,
                                   sum_count=True)
    jnum, jden = jax_cls_loss(jnp.asarray(logits), jnp.asarray(labels), jw,
                              sum_count=True)
    np.testing.assert_allclose([float(num), float(den)],
                               [float(jnum), float(jden)], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(rng, dtype):
    """Output, input/scale/bias gradients and the running update of one
    train-mode call at momentum 0.7, against BatchNorm applied with
    mutable=["batch_stats"]. f32: reduction order only (1e-5); bf16: the
    output and the input gradient are rounded to bf16 on both sides, so
    one bf16 ulp (2^-7 relative) of their largest value."""
    x = (rng.randn(4, 6, 5, 8) * 2 + 0.5).astype(np.float32)
    ct = rng.randn(4, 6, 5, 8).astype(np.float32)
    jdt = getattr(jnp, dtype)
    bn = jnn.BatchNorm(dtype=jdt)
    variables = _randomize(_jax_init(bn, jnp.asarray(x), train=False),
                           seed=5)

    def f(params, xin):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          xin, True, 0.7, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, stats = f(variables["params"], jnp.asarray(x).astype(jdt))
    _, vjp = jax.vjp(lambda p, xin: f(p, xin)[0], variables["params"],
                     jnp.asarray(x).astype(jdt))
    gp, gx = vjp(jnp.asarray(ct).astype(jdt))

    tbn = tnn.BatchNorm(8, dtype=getattr(torch, dtype)).train()
    tbn.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in (
        ("weight", variables["params"]["scale"]),
        ("bias", variables["params"]["bias"]),
        ("running_mean", variables["batch_stats"]["mean"]),
        ("running_var", variables["batch_stats"]["var"]))})
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    yt = tbn(xt, 0.7)
    yt.backward(torch.from_numpy(ct).to(getattr(torch, dtype)))

    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    want_y = np.asarray(y).astype(np.float32)
    np.testing.assert_allclose(yt.detach().float().numpy(), want_y,
                               rtol=tol, atol=tol * np.abs(want_y).max())
    want_gx = np.asarray(gx).astype(np.float32)
    np.testing.assert_allclose(xt.grad.float().numpy(), want_gx, rtol=tol,
                               atol=tol * np.abs(want_gx).max())
    for name, leaf in (("weight", "scale"), ("bias", "bias")):
        want = np.asarray(gp[leaf])
        assert _rel(getattr(tbn, name).grad.numpy(), want) <= (
            1e-5 if dtype == "float32" else 1e-2), name
    for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tbn, name).numpy(),
                                   np.asarray(stats[leaf]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# one full-width pointnet2_cls_ssg train step against JAX run_one_step
# ---------------------------------------------------------------------------

STEP_B, STEP_N = 4, 128


def _dropout_masks(seed):
    r = np.random.RandomState(seed)
    return {512: r.rand(STEP_B, 512) < 0.5, 256: r.rand(STEP_B, 256) < 0.5}


def _zero_dense_biases(tree):
    """Dense biases back to zero, as the Xavier init leaves them: a bias in
    front of a train-mode BN only moves the batch mean, which worsens the
    E[x^2]-E[x]^2 cancellation of the BN variance and tests nothing."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if k == "dense" and "bias" in v:
                v["bias"] = np.zeros_like(v["bias"])
            _zero_dense_biases(v)
    return tree


def jax_step_setup(fused: bool = False) -> dict:
    """JAX run_one_step at full width (B=4, N=128, the last row masked,
    augmentation off), Adam on the default schedules at step 0 (BN momentum
    0.5), on randomised BN parameters and statistics, with both dropout
    layers' masks injected through flax's method interceptor, and the JAX
    package's fused-chain gate at `fused`. Returns inputs and outputs as
    numpy, and the same step's loss, gradients and running statistics from
    the port in float64 (the accuracy reference; float64 never takes the
    fused chain)."""
    r = np.random.RandomState(21)
    batch = {"points": r.rand(STEP_B, STEP_N, 3).astype(np.float32),
             "label": r.randint(0, 40, STEP_B).astype(np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)}
    model = JaxClsSSG()
    variables = _randomize(_jax_init(model, jnp.asarray(batch["points"]),
                                     train=False), seed=9)
    _zero_dense_biases(variables["params"])
    masks = _dropout_masks(4)
    lr = jsched.exponential_decay_clipped(1e-3, STEP_B, 200000, 0.7)
    bnm = jsched.bn_momentum_schedule(STEP_B, 200000)
    tx = jax_make_optimizer("adam", lr)

    def dropout(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            keep = jnp.asarray(masks[x.shape[-1]])
            return jnp.where(keep, x / 0.5, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def step(state, b):
        with fnn.intercept_methods(dropout):
            return jax_run_one_step(model, jax_cls_loss, tx, bnm, "cls",
                                    None, False, state, b,
                                    jax.random.PRNGKey(0))

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params))
    with jax_config.fused_mlp(fused):
        new, metrics = jax.jit(step)(state, jax.tree_util.tree_map(
            jnp.asarray, batch))
    mu = new.opt_state[0].mu  # Adam's first moment after one step: 0.1*g
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                                   mu)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    setup = {"batch": batch, "variables": variables, "masks": masks,
             "loss": float(metrics["loss"]),
             "acc": float(metrics["accuracy"]),
             "grads": flax_to_torch({"params": grads}),
             "new": flax_to_torch({"params": to_np(new.params),
                                   "batch_stats": to_np(new.batch_stats)})}
    ref = _port_model(setup).double()
    pts = torch.from_numpy(batch["points"]).double()
    num, den = classification_loss(ref(pts, 0.5), torch.from_numpy(
        batch["label"]), torch.from_numpy(batch["mask"]).double(),
        sum_count=True)
    (num / den).backward()
    setup["loss64"] = float((num / den).detach())
    setup["grads64"] = {k: p.grad.numpy() for k, p in ref.named_parameters()}
    setup["buffers64"] = {k: b.numpy() for k, b in ref.named_buffers()}
    return setup


@pytest.fixture(scope="module")
def jax_train_step():
    """:func:`jax_step_setup` with the gate off, as by default."""
    return jax_step_setup()


def _port_model(setup):
    model = PointNet2ClsSSG(device="cpu").train()
    model.load_state_dict(flax_to_torch(setup["variables"], model))
    for drop, width in ((model.drop1, 512), (model.drop2, 256)):
        keep = torch.from_numpy(setup["masks"][width])
        drop.keep_mask = lambda shape, device, generator, k=keep: k
    return model


def _port_train_step(setup):
    model = _port_model(setup)
    lr = tsched.exponential_decay_clipped(1e-3, STEP_B, 200000, 0.7)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer("adam", model.parameters(),
                                                lr))
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    metrics = run_one_step(state, batch, classification_loss,
                           tsched.bn_momentum_schedule(STEP_B, 200000))
    return state, metrics


def _compared(setup):
    """Gradient tensors that are not zero in exact arithmetic: a float64
    norm of at least 1e-6 of the largest. The rest (dense biases in front
    of a train-mode BN, and SA3's last BN bias, whose cotangent fc1's
    batch-statistics BN centres to zero over the batch) are rounding
    residue on both sides."""
    norms = {k: np.linalg.norm(g) for k, g in setup["grads64"].items()}
    top = max(norms.values())
    return [k for k, n in norms.items() if n >= 1e-6 * top]


def test_cls_ssg_train_step_matches_jax(jax_train_step):
    """The loss, every gradient and the new BN running statistics of one
    train step, against JAX run_one_step and a float64 run of the port.

    BN on batch statistics computes var = E[x^2] - E[x]^2 in float32 (the
    JAX package's formula), and its summation order decides how much of
    the cancellation survives. Measured on this step: the port's float32
    loss is within 5e-7 of float64 and each gradient within 2e-4 of its
    norm; XLA:CPU's float32 loss within 3e-5 and its gradients within
    2.2e-2. Bounds: the port against float64, loss 1e-5 and gradients 1e-3
    (its own accuracy); JAX against the port's float64 run, loss 1e-4 and
    gradients 5e-2 (XLA's accuracy; a missing or wrong gradient term is
    off by O(1)); the port against JAX, loss 1e-4. The new running
    statistics likewise, against each tensor's scale: the port within 1e-4
    of float64 (measured 1.1e-5), JAX within 1e-3 (measured 1.1e-4)."""
    setup = jax_train_step
    state, metrics = _port_train_step(setup)
    assert state.step == 1
    loss64 = setup["loss64"]
    assert abs(float(metrics["loss"]) - loss64) <= 1e-5 * loss64
    assert abs(setup["loss"] - loss64) <= 1e-4 * loss64
    assert abs(float(metrics["loss"]) - setup["loss"]) <= 1e-4 * loss64
    assert float(metrics["accuracy"]) == setup["acc"]
    params = dict(state.model.named_parameters())
    assert set(params) == set(setup["grads"]) == set(setup["grads64"])
    compared = _compared(setup)
    assert len(compared) >= 30
    for k in compared:
        ref = setup["grads64"][k]
        assert _rel(params[k].grad.numpy(), ref) <= 1e-3, k
        assert _rel(setup["grads"][k].numpy(), ref) <= 5e-2, k
    for k, b in state.model.named_buffers():
        ref = setup["buffers64"][k]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(b.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(setup["new"][k].numpy(), ref, rtol=0,
                                   atol=1e-3 * scale, err_msg=k)


def test_cls_ssg_train_step_updates_like_optax(jax_train_step):
    """The updated parameters against JAX's. Adam's first update is
    lr*g/(|g|+1e-8), about lr*sign(g), so wherever the two gradients agree
    to a quarter of their size and exceed 1e-4 (eps/|g| <= 1e-4) the new
    parameters agree to 1e-6; that is
    the case for most elements, and every element moved by at most lr."""
    setup = jax_train_step
    state, _ = _port_train_step(setup)
    old = flax_to_torch(setup["variables"])
    agree = total = 0
    for k, p in state.model.named_parameters():
        got, want = p.detach().numpy(), setup["new"][k].numpy()
        assert np.abs(got - old[k].numpy()).max() <= 1e-3 + 1e-7, k
        g, gj = p.grad.numpy(), setup["grads"][k].numpy()
        sure = (np.abs(g - gj) <= 0.25 * np.abs(gj)) & (np.abs(gj) > 1e-4)
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
        agree += int(sure.sum())
        total += got.size
    assert agree >= 0.8 * total, (agree, total)


def test_dropout_masks_reach_the_loss(jax_train_step):
    """The injected masks are what the port's dropout applies: other masks
    give another loss."""
    setup = dict(jax_train_step)
    setup["masks"] = _dropout_masks(5)
    _, metrics = _port_train_step(setup)
    assert abs(float(metrics["loss"]) - jax_train_step["loss"]) > 1e-3


# ---------------------------------------------------------------------------
# data, Trainer, train -> serve
# ---------------------------------------------------------------------------


def test_modelnet_h5_batches_equal_jax(tmp_path):
    """A tiny two-file H5 set written here: the port's loader yields the
    JAX loader's batches (same seed, shuffled and not, with the host
    augmentation ``augment_cls_batch`` off and on), padded tail and nvalid
    included."""
    import h5py

    r = np.random.RandomState(0)
    names = []
    for i, n in enumerate((7, 5)):
        name = f"ply_data_train{i}.h5"
        with h5py.File(tmp_path / name, "w") as f:
            f["data"] = r.rand(n, 40, 3).astype(np.float32)
            f["label"] = r.randint(0, 40, (n, 1)).astype(np.uint8)
        names.append(f"data/modelnet40_ply_hdf5_2048/{name}")
    lst = tmp_path / "train_files.txt"
    lst.write_text("\n".join(names) + "\n")
    for shuffle in (True, False):
        kw = dict(batch_size=5, npoints=32, shuffle=shuffle, seed=3)
        ours, theirs = ModelNetH5Dataset(str(lst), **kw), JaxH5Dataset(
            str(lst), **kw)
        assert len(ours) == 12 and ours.num_batches() == 3
        # two epochs each way: the shuffle and augmentation state advances
        # alike
        for augment in (False, False, True, True):
            got = list(ours.epoch(augment=augment))
            want = list(theirs.epoch(augment=augment))
            assert len(got) == len(want) == 3 and got[-1]["nvalid"] == 2
            for a, b in zip(got, want):
                assert a["nvalid"] == b["nvalid"]
                np.testing.assert_array_equal(a["points"], b["points"])
                np.testing.assert_array_equal(a["label"], b["label"])


def test_synthetic_dataset_equals_jax():
    kw = dict(num_classes=5, samples_per_class=3, npoints=20, batch_size=4,
              seed=2)
    ours, theirs = SyntheticClassification(**kw), JaxSynthetic(**kw)
    np.testing.assert_array_equal(ours.data, theirs.data)
    for augment in (False, True):
        for a, b in zip(ours.epoch(augment), theirs.epoch(augment)):
            assert a["nvalid"] == b["nvalid"]
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["label"], b["label"])


def test_train_config_refuses_what_is_not_ported(tmp_path):
    """An augmentation the port has not is refused; num_devices=2 is
    ported, and without a process group of two ranks it raises instead of
    training on one (tests/test_torch_scale_out.py runs it on two)."""
    with pytest.raises(NotImplementedError):
        Trainer(TrainConfig(log_dir=str(tmp_path), augment="cls_and_jitter"),
                device="cpu")
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        Trainer(TrainConfig(log_dir=str(tmp_path), num_devices=2),
                device="cpu")


@pytest.fixture(scope="module")
def overfit_run(tmp_path_factory):
    """Trainer.fit on 4 synthetic classes of 8 clouds, 64 points, batch 8,
    lr 1e-2, as tests/test_overfit.py:40-45, stopping once the eval
    accuracy on the training set reaches 0.95 (at most 30 epochs)."""
    log = tmp_path_factory.mktemp("overfit")
    ds = SyntheticClassification(num_classes=4, samples_per_class=8,
                                 npoints=64, batch_size=8, seed=0)
    cfg = TrainConfig(batch_size=8, learning_rate=1e-2, log_dir=str(log),
                      eval_every=2)
    with Trainer(cfg, device="cpu") as tr:
        state = tr.init_state()
        acc = 0.0
        for epoch in range(30):
            state = tr.train_epoch(state, ds, epoch)
            if epoch % 2:
                continue
            acc = tr.eval_epoch(state, ds, epoch)
            if acc >= 0.95:
                break
    return state, acc, log, ds


def test_overfit_classification(overfit_run):
    _, acc, log, _ = overfit_run
    assert acc >= 0.95, f"train accuracy {acc:.3f} < 0.95"
    lines = (log / "metrics.jsonl").read_text().splitlines()
    assert lines and (log / "config.json").is_file()
    assert "eval accuracy" in (log / "log_train.txt").read_text()


def test_trained_weights_serve_through_predictor(overfit_run):
    """train -> serve: the trained state_dict loads into Predictor and
    scores the training clouds as the trained model does in eval."""
    state, acc, _, ds = overfit_run
    pred = Predictor("pointnet2_cls_ssg", state.model.state_dict(),
                     dtype=torch.float32, device="cpu")
    pts = ds.data[:8]
    state.model.eval()
    with torch.inference_mode():
        want = state.model(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(pred(pts), want, rtol=1e-5, atol=1e-5)
    hits = (pred(ds.data).argmax(-1) == ds.label).mean()
    assert hits >= acc - 1e-6
