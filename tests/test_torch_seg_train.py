"""The port's segmentation training held against the JAX package on the
CPU.

One train step of each segmentation task (``sem_seg``, ``part_seg``,
``part_seg_one_hot``) through the port's ``run_one_step`` and JAX's
``steps_body.run_one_step`` on the same converted weights, batch and
dropout masks (injected on both sides, as tests/test_torch_train.py does
for the classifier), with a padded row masked out and, for ``sem_seg``,
per-point weights that hold zeros and a zero row (the wdp input dropout
and a padded batch); the eval count step's segmentation branch against
JAX's ``make_eval_count_step`` on the same logits; and ``Trainer.fit`` of
each task for two tiny epochs.

Tolerances. As for the classifier's step, the float32 steps are held to a
float64 run of the port on the same inputs, not to each other. JAX's step
is run twice: as it stands, and with its BN batch statistics
(``nn/layers.py:_batch_stats``, E[y] and E[y^2]) summed in float64 and
rounded to f32 (swapped in while the step is traced, under
``jax.enable_x64``; no file of the JAX package changes). Measured at these
shapes (B=4, N=128), against the port's float64 run: the losses within
6.2e-7 (port f32), 3.0e-5 (JAX) and 2.4e-8 (JAX, float64 statistics)
relative; every gradient tensor within 8.4e-3, 0.148 and 1.44e-2 of its
norm, the median tensor within about 4e-3, 8e-2 and 1e-2; the port's f32
step drifts more at larger N (2.2e-2 at N=256). JAX's larger drift is its
BN statistics alone, since the swap changes nothing else: XLA's CPU
reduction of each channel's B*N*S values in f32 rounds more than
PyTorch's, and var = E[y^2] - E[y]^2 turns that into a large relative
error of the variance wherever the mean is large against the spread; the
deep train-mode BN chains (13-19 layers) and the max-pools' near-tied
picks carry it into every gradient. With the two sums in float64 the same
JAX step agrees with the port as closely as the port's own f32 step does.
Bounds: loss 1e-5 (port, JAX with float64 statistics) and 1e-4 (JAX);
running statistics 1e-4 (port, JAX with float64 statistics) and 2e-3
(JAX); gradients 3e-2 (port, JAX with float64 statistics) and 0.3 (JAX).
A zeroed, scaled or missing gradient term reads 1 or more; a term scaled
by 1.1 reads about 0.1.
"""

import contextlib
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.nn import layers as jax_layers
from pointnet2_tpu.train import schedules as jsched
from pointnet2_tpu.train.state import TrainState as JaxTrainState
from pointnet2_tpu.train.state import make_optimizer as jax_make_optimizer
from pointnet2_tpu.train.steps import make_eval_count_step
from pointnet2_tpu.train.steps_body import run_one_step as jax_run_one_step
from pointnet2_tpu_torch import flax_to_torch
from pointnet2_tpu_torch.data import (
    ScannetDataset,
    SyntheticSegmentation,
    SyntheticShapeNetPart,
    make_synthetic_scenes,
)
from pointnet2_tpu_torch.models import get_spec
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train import schedules as tsched
from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.train.steps import (
    eval_counts,
    loss_args,
    model_inputs,
    run_one_step,
)
from tests.test_torch_model import _jax_init, _randomize
from tests.test_torch_train import _rel, _zero_dense_biases

B, N = 4, 128
SEM, PART, PART_MSG = ("pointnet2_sem_seg", "pointnet2_part_seg",
                       "pointnet2_part_seg_msg_one_hot")
# model -> (input channels, classes)
MODELS = {SEM: (3, 21), PART: (6, 50), PART_MSG: (6, 50)}
DROP_WIDTH = 128  # every segmentation model's one dropout, after fc1


def _batch(name: str, seed: int = 31) -> dict:
    """B clouds of N points, the last row padding (mask 0); sem_seg's
    weights in [0.5, 2) with a third of row 0's zeroed and row 1 all
    zero."""
    r = np.random.RandomState(seed)
    C, K = MODELS[name]
    pts = r.rand(B, N, C).astype(np.float32)
    if C == 6:
        pts[..., 3:] = r.randn(B, N, 3)
        pts[..., 3:] /= np.linalg.norm(pts[..., 3:], axis=-1, keepdims=True)
    batch = {"points": pts, "seg": r.randint(0, K, (B, N)).astype(np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)}
    if name == SEM:
        smpw = r.uniform(0.5, 2.0, (B, N)).astype(np.float32)
        smpw[0, ::3] = 0.0
        smpw[1] = 0.0
        batch["smpw"] = smpw
    if name == PART_MSG:
        batch["cls_label"] = r.randint(0, 16, B).astype(np.int32)
    return batch


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch: dict, dtype=torch.float32) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.to(dtype) if t.is_floating_point() else t.long()
    return out


def _float64_batch_stats(x, syncable: bool):
    """JAX's ``_batch_stats`` with E[y] and E[y^2] summed in float64 (x64
    must be on), var = max(E[y^2] - E[y]^2, 0) in float64, both rounded
    to f32; `syncable` matters only under a cross-replica axis, which
    these steps have none of."""
    del syncable
    xf = x.astype(jnp.float64)
    axes = tuple(range(x.ndim - 1))
    mean = jnp.mean(xf, axis=axes)
    var = jnp.maximum(jnp.mean(jnp.square(xf), axis=axes)
                      - jnp.square(mean), 0.0)
    return mean.astype(jnp.float32), var.astype(jnp.float32)


@contextlib.contextmanager
def _batch_stats(float64: bool):
    """While tracing: JAX's BN statistics as they stand, or summed in
    float64 (`_float64_batch_stats`)."""
    stats = jax_layers._batch_stats
    if float64:
        jax_layers._batch_stats = _float64_batch_stats
    try:
        yield
    finally:
        jax_layers._batch_stats = stats


@functools.lru_cache(maxsize=None)
def _jax_stepper(name: str, float64_stats: bool = False):
    """JAX run_one_step of a model at step 0 (Adam on the default
    schedules, BN momentum 0.5), jitted once, with the dropout mask an
    argument that flax's method interceptor applies; `float64_stats`
    traces it with the BN statistics summed in float64."""
    spec = JAX_REGISTRY[name]
    model = spec.cls()
    tx = jax_make_optimizer("adam", jsched.exponential_decay_clipped(
        1e-3, B, 200000, 0.7))
    bnm = jsched.bn_momentum_schedule(B, 200000)

    def step(state, b, keep):
        def dropout(next_fun, args, kwargs, context):
            if (isinstance(context.module, fnn.Dropout)
                    and context.method_name == "__call__"):
                x = args[0]
                return jnp.where(keep, x / 0.5, jnp.zeros_like(x))
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(dropout), _batch_stats(float64_stats):
            return jax_run_one_step(model, spec.loss, tx, bnm, spec.task,
                                    None, False, state, b,
                                    jax.random.PRNGKey(0))

    return tx, jax.jit(step)


def _jax_step(name: str, variables, batch: dict, keep: np.ndarray,
              float64_stats: bool = False):
    """One JAX step from `variables`; returns (new state, metrics).
    `float64_stats`: with the BN statistics summed in float64, under x64
    (every array of the step stays f32)."""
    tx, step = _jax_stepper(name, float64_stats)
    with (jax.enable_x64(True) if float64_stats
          else contextlib.nullcontext()):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(params))
        return step(state, _jax_batch(batch), jnp.asarray(keep))


def _adam_grads(new) -> dict:
    """The gradients of a JAX step, as the port's state_dict: Adam's first
    moment after one step is 0.1 * g."""
    return flax_to_torch({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / np.float32(0.1), new.opt_state[0].mu)})


def _port_model(name: str, variables, keep: np.ndarray):
    model = get_spec(name).cls(device="cpu").train()
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    mask = torch.from_numpy(keep)
    model.drop1.keep_mask = lambda shape, device, generator, k=mask: k
    return model


def _port_step(name: str, variables, batch: dict, keep: np.ndarray):
    model = _port_model(name, variables, keep)
    lr = tsched.exponential_decay_clipped(1e-3, B, 200000, 0.7)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        "adam", model.parameters(), lr))
    metrics = run_one_step(state, _torch_batch(batch), get_spec(name).loss,
                           tsched.bn_momentum_schedule(B, 200000),
                           task=get_spec(name).task)
    return state, metrics


def _float64_step(name: str, variables, batch: dict, keep: np.ndarray):
    """The port's loss, gradients and new running statistics of the same
    step in float64 (the accuracy reference)."""
    spec = get_spec(name)
    ref = _port_model(name, variables, keep).double()
    tb = _torch_batch(batch, torch.float64)
    logits = ref(*model_inputs(tb, spec.task), bn_momentum=0.5)
    num, den = spec.loss(logits, *loss_args(tb, spec.task),
                         sample_weight=tb["mask"], sum_count=True)
    loss = num / torch.clamp_min(den, 1e-8)
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad.numpy() for k, p in ref.named_parameters()},
            {k: b.numpy() for k, b in ref.named_buffers()})


@functools.lru_cache(maxsize=None)
def _setup(name: str) -> dict:
    """One step of a model in JAX (f32, as it stands and with float64 BN
    statistics), the port (f32) and the port in float64, from the same
    randomised weights (dense biases zero, as the classifier's step test
    explains), batch and dropout mask."""
    batch = _batch(name)
    jb = _jax_batch(batch)
    inputs = (jb["points"], jb["cls_label"]) if name == PART_MSG else (
        jb["points"],)
    variables = _randomize(_jax_init(JAX_REGISTRY[name].cls(), *inputs,
                                     train=False), seed=9)
    _zero_dense_biases(variables["params"])
    keep = np.random.RandomState(4).rand(B, N, DROP_WIDTH) < 0.5
    new, metrics = _jax_step(name, variables, batch, keep)
    exact, exact_metrics = _jax_step(name, variables, batch, keep, True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state, port = _port_step(name, variables, batch, keep)
    loss64, grads64, buffers64 = _float64_step(name, variables, batch, keep)
    return {"name": name, "batch": batch, "variables": variables,
            "keep": keep, "loss": float(metrics["loss"]),
            "acc": float(metrics["accuracy"]),
            "grads": _adam_grads(new),
            "stats": flax_to_torch({"batch_stats": to_np(new.batch_stats)}),
            "exact_loss": float(exact_metrics["loss"]),
            "exact_grads": _adam_grads(exact),
            "exact_stats": flax_to_torch({"batch_stats": to_np(
                exact.batch_stats)}),
            "state": state, "port": port, "loss64": loss64,
            "grads64": grads64, "buffers64": buffers64}


@pytest.fixture(scope="module", params=sorted(MODELS))
def seg_step(request):
    return _setup(request.param)


def test_seg_train_step_matches_jax(seg_step):
    """Loss, accuracy, every gradient that is not zero in exact arithmetic
    and the new BN running statistics of one step, against JAX (as it
    stands and with float64 BN statistics) and the port's float64 run
    (tolerances in the module docstring)."""
    s = seg_step
    state, port = s["state"], s["port"]
    assert state.step == 1
    loss64 = s["loss64"]
    assert np.isfinite(loss64) and loss64 > 0
    assert abs(float(port["loss"]) - loss64) <= 1e-5 * loss64
    assert abs(s["exact_loss"] - loss64) <= 1e-5 * loss64
    assert abs(s["loss"] - loss64) <= 1e-4 * loss64
    assert float(port["accuracy"]) == s["acc"]
    params = dict(state.model.named_parameters())
    assert set(params) == set(s["grads"]) == set(s["grads64"])
    norms = {k: np.linalg.norm(g) for k, g in s["grads64"].items()}
    top = max(norms.values())
    compared = [k for k, n in norms.items() if n >= 1e-6 * top]
    assert len(compared) >= 30
    for k in compared:
        ref = s["grads64"][k]
        assert _rel(params[k].grad.numpy(), ref) <= 3e-2, k
        assert _rel(s["exact_grads"][k].numpy(), ref) <= 3e-2, k
        assert _rel(s["grads"][k].numpy(), ref) <= 0.3, k
    buffers = dict(state.model.named_buffers())
    assert set(buffers) == set(s["stats"]) == set(s["buffers64"])
    for k, ref in s["buffers64"].items():
        scale = np.abs(ref).max()
        np.testing.assert_allclose(buffers[k].numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(s["exact_stats"][k].numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(s["stats"][k].numpy(), ref, rtol=0,
                                   atol=2e-3 * scale, err_msg=k)


def test_seg_train_step_masks_padding_and_weights(seg_step):
    """The masked row (and sem_seg's zero-weight points) take no part in
    the loss: changing their targets changes neither the port's loss nor
    JAX's accuracy-free loss; the accuracy counts the masked points
    only."""
    s = seg_step
    batch = dict(s["batch"])
    seg = batch["seg"].copy()
    seg[3] = (seg[3] + 1) % MODELS[s["name"]][1]  # the padded row
    if s["name"] == SEM:
        seg[1] = (seg[1] + 1) % 21  # the all-zero-weight row
        seg[0, ::3] = (seg[0, ::3] + 1) % 21
    batch["seg"] = seg
    _, port = _port_step(s["name"], s["variables"], batch, s["keep"])
    assert abs(float(port["loss"]) - float(s["port"]["loss"])) <= (
        1e-6 * float(s["port"]["loss"]))


def test_sem_seg_step_with_every_weight_zero():
    """A batch whose every weight is zero (wdp of a padded batch at its
    extreme): num = den = 0, the loss is exactly 0 in both packages and
    Adam's update of a zero gradient leaves every parameter as it was."""
    batch = _batch(SEM, seed=7)
    batch["smpw"][:] = 0.0
    variables, keep = _setup(SEM)["variables"], _setup(SEM)["keep"]
    new, metrics = _jax_step(SEM, variables, batch, keep)
    assert float(metrics["loss"]) == 0.0
    state, port = _port_step(SEM, variables, batch, keep)
    assert float(port["loss"]) == 0.0
    before = flax_to_torch(variables)
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
        assert not p.grad.any(), k
    after = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                            new.params)})
    for k, v in after.items():
        np.testing.assert_array_equal(v.numpy(), before[k].numpy(),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# eval counts on the same logits
# ---------------------------------------------------------------------------


class _FixedJax(fnn.Module):
    """Returns given logits, whatever the inputs."""

    logits: np.ndarray

    @fnn.compact
    def __call__(self, *inputs, train: bool = False):
        return jnp.asarray(self.logits), None


class _FixedTorch(torch.nn.Module):
    def __init__(self, logits: np.ndarray):
        super().__init__()
        self.logits = torch.from_numpy(logits)
        self.seen = None

    def forward(self, *inputs):
        self.seen = inputs
        return self.logits


@pytest.mark.parametrize("task", ["sem_seg", "part_seg", "part_seg_one_hot"])
def test_eval_counts_seg_branch_equals_jax(task):
    """correct, total and the per-class counts of the same (B, N, K)
    logits and targets, with a padded row: exactly JAX's
    make_eval_count_step; ties in the logits break to the first class on
    both sides."""
    r = np.random.RandomState(3)
    K = 7
    logits = r.randint(0, 4, (B, N, K)).astype(np.float32)  # many ties
    batch = {"points": r.rand(B, N, 6).astype(np.float32),
             "seg": r.randint(0, K, (B, N)).astype(np.int32),
             "mask": np.array([1, 0, 1, 1], np.float32),
             "cls_label": r.randint(0, 16, B).astype(np.int32)}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params={},
                          batch_stats={}, opt_state=())
    want = make_eval_count_step(_FixedJax(logits), task=task)(
        state, _jax_batch(batch))
    model = _FixedTorch(logits)
    got = eval_counts(model, _torch_batch(batch), task)
    assert len(model.seen) == (2 if task == "part_seg_one_hot" else 1)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1]) == 3 * N


# ---------------------------------------------------------------------------
# Trainer.fit, two tiny epochs a task
# ---------------------------------------------------------------------------


def _datasets(name: str):
    if name == SEM:
        rooms = ScannetDataset(scenes=make_synthetic_scenes(3, 2000, seed=1),
                               npoints=64, batch_size=2, seed=0)
        return rooms, rooms, "scannet"
    parts = SyntheticShapeNetPart(num_samples=3, npoints=64, batch_size=2,
                                  categories=["Chair", "Mug", "Lamp"])
    return parts, parts, "cls_normals"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trainer_fits_each_seg_task(tmp_path, name):
    """Two epochs of three examples in batches of 2 (a padded final
    batch): finite losses, the eval's per-point accuracy logged, a state
    that serves per point."""
    train, evals, augment = _datasets(name)
    cfg = TrainConfig(model=name, num_point=64, batch_size=2,
                      augment=augment, log_dir=str(tmp_path))
    with Trainer(cfg, device="cpu") as tr:
        assert tr.task == get_spec(name).task
        state = tr.fit(train, evals, max_epoch=2)
    assert state.step == 4
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    train_lines = [ln for ln in lines if '"split": "train"' in ln]
    eval_lines = [ln for ln in lines if '"split": "eval"' in ln]
    assert len(train_lines) == len(eval_lines) == 2
    assert "nan" not in " ".join(train_lines).lower()
    assert "eval accuracy" in (tmp_path / "log_train.txt").read_text()
    pts = torch.from_numpy(next(evals.epoch())["points"])
    state.model.eval()
    with torch.inference_mode():
        args = (pts, torch.zeros(2, dtype=torch.long)) if name == PART_MSG \
            else (pts,)
        out = state.model(*args)
    assert out.shape == (2, 64, MODELS[name][1])


def test_trainer_on_synthetic_segmentation(tmp_path):
    """SyntheticSegmentation's batches (seg and unit smpw) train sem_seg
    at a per-point accuracy above chance after a few epochs."""
    ds = SyntheticSegmentation(num_classes=4, num_samples=4, npoints=64,
                               batch_size=4, seed=0)
    cfg = TrainConfig(model=SEM, num_point=64, batch_size=4,
                      learning_rate=1e-2, log_dir=str(tmp_path),
                      model_kwargs={"num_classes": 4})
    with Trainer(cfg, device="cpu") as tr:
        tr.fit(ds, ds, max_epoch=6)
    assert tr.best_score > 0.25
