"""The port's multi-scale-grouping models and the PointNet baseline held
against the JAX package on the CPU, on the same (converted) weights, and
the Predictor with a category label.

As in test_torch_model: the JAX package initialises each model, every BN
statistic and bias is redrawn from a numpy seed, flax_to_torch converts the
tree strictly into the port's model, and the same numpy clouds go through
both. f32 logits agree to the f32 tolerance of test_torch_model; bf16 ones
within 2% of the f32 logits' range with the same argmax (its bf16 bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.serving import Predictor as JaxPredictor
from pointnet2_tpu_torch import MODEL_REGISTRY, Predictor, flax_to_torch
from pointnet2_tpu_torch.models.part_seg_msg_one_hot import one_hot
from tests.test_torch_model import F32_TOL, _randomize

B, N = 2, 128
MSG_PART = "pointnet2_part_seg_msg_one_hot"
# (model name, input channels); the one-hot part segmenter also takes labels
MODELS = [("pointnet2_cls_msg", 3), ("pointnet_cls_basic", 3),
          (MSG_PART, 6)]


def _inputs(name, channels, b=B, seed=7):
    rs = np.random.RandomState(seed)
    pc = rs.rand(b, N, channels).astype(np.float32)
    labels = rs.randint(0, 16, b).astype(np.int32)
    return (pc, labels) if name == MSG_PART else (pc,)


@pytest.fixture(scope="module")
def jax_runs():
    """Per model: randomised Flax variables and JAX's eval logits in f32
    and bf16 on the same inputs."""
    out = {}
    for seed, (name, channels) in enumerate(MODELS):
        args = [jnp.asarray(a) for a in _inputs(name, channels)]
        cls = JAX_REGISTRY[name].cls
        variables = jax.jit(lambda r, *a: cls().init(r, *a, train=False))(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, *args)
        variables = _randomize(variables, seed=30 + seed)
        logits = {}
        for tag, dt in (("f32", None), ("bf16", jnp.bfloat16)):
            model = cls(dtype=dt)
            got, _ = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
                variables, *args)
            logits[tag] = np.asarray(got)
        out[name] = (variables, logits)
    return out


def _port(name, variables, dtype=None):
    model = MODEL_REGISTRY[name].cls(dtype=dtype, device="cpu")
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    return model


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,channels", MODELS)
def test_model_logits_match_jax(jax_runs, name, channels, dtype):
    variables, logits = jax_runs[name]
    model = _port(name, variables,
                  torch.bfloat16 if dtype == "bf16" else None)
    with torch.inference_mode():
        got = model(*[torch.from_numpy(a)
                      for a in _inputs(name, channels)]).numpy()
    shape = (B, N, 50) if name == MSG_PART else (B, 40)
    assert got.dtype == np.float32 and got.shape == shape
    if dtype == "f32":
        np.testing.assert_allclose(got, logits["f32"], atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        want = logits["bf16"]
        assert np.abs(got - want).max() <= 0.02 * np.abs(logits["f32"]).max()
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        # per point, a near-tie between two parts may resolve either way
        assert agree == 1.0 if name != MSG_PART else agree >= 0.98


def test_msg_state_dict_names_follow_flax(jax_runs):
    """MSG children are mlp_mods_0, mlp_mods_1, ... as the Flax scopes, so
    flax_to_torch needs no rule beyond the dense and BN leaves; a leaf
    missing from the tree raises."""
    variables, _ = jax_runs["pointnet2_cls_msg"]
    model = MODEL_REGISTRY["pointnet2_cls_msg"].cls(device="cpu")
    keys = set(model.state_dict())
    assert "sa1.mlp_mods_2.conv1.dense.weight" in keys
    assert "sa2.mlp_mods_0.conv2.norm.running_var" in keys
    assert not any(".mlp_mods." in k for k in keys)
    broken = {c: dict(t) for c, t in variables.items()}
    broken["params"] = dict(broken["params"])
    broken["params"]["sa1"] = dict(broken["params"]["sa1"])
    del broken["params"]["sa1"]["mlp_mods_1"]
    with pytest.raises(ValueError, match="missing"):
        flax_to_torch(broken, model)


def test_cls_msg_with_normals_and_nsample_recipe_matches_jax():
    """(B, N, 6) clouds (normals as SA1's features) and the 5000-point
    recipe's nsample 128 in SA1 and SA2."""
    pc = np.random.RandomState(9).rand(B, N, 6).astype(np.float32)
    kw = dict(sa1_nsample=(16, 32, 128), sa2_nsample=(128, 128, 128))
    jmodel = JAX_REGISTRY["pointnet2_cls_msg"].cls(**kw)
    variables = _randomize(jax.jit(lambda r, p: jmodel.init(
        r, p, train=False))(jax.random.PRNGKey(0), jnp.asarray(pc)), seed=40)
    want, _ = jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(
        variables, jnp.asarray(pc))
    model = MODEL_REGISTRY["pointnet2_cls_msg"].cls(in_channels=6,
                                                    device="cpu", **kw)
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(pc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_one_hot_matches_jax_outside_the_range():
    labels = np.array([0, 15, 16, -1, 7], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(labels), 16))
    got = one_hot(torch.from_numpy(labels), 16, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2:4].any()


@pytest.fixture(scope="module")
def part_predictors(jax_runs):
    variables, _ = jax_runs[MSG_PART]
    jp = JaxPredictor(MSG_PART, variables, dtype=None, buckets=(2, 4))
    tp = Predictor(MSG_PART, variables, dtype=None, buckets=(2, 4),
                   device="cpu")
    return jp, tp


def test_part_seg_predictor_pads_and_chunks_labels(part_predictors):
    """7 clouds with buckets (2, 4): chunks of 4 and 3, the last padded to
    4 with replicas of its row 0, labels alongside; against the JAX
    Predictor and against the model called on each cloud's own label."""
    jp, tp = part_predictors
    pc, labels = _inputs(MSG_PART, 6, b=7, seed=11)
    got = tp(pc, labels)
    assert got.shape == (7, N, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, jp(pc, labels), atol=F32_TOL,
                               rtol=F32_TOL)
    with torch.inference_mode():
        direct = tp.model(torch.from_numpy(pc[4:]),
                          torch.from_numpy(labels[4:])).numpy()
    np.testing.assert_allclose(got[4:], direct, atol=1e-5, rtol=1e-5)
    proba = tp.predict_proba(pc[:3], labels[:3])
    np.testing.assert_allclose(proba, jp.predict_proba(pc[:3], labels[:3]),
                               atol=1e-5)


def test_part_seg_predictor_label_rules(part_predictors):
    """A missing label raises; the empty request answers (0, N, 50); a
    label outside [0, 16) gives JAX's all-zero one-hot, so the logits are
    JAX's and differ from label 0's."""
    jp, tp = part_predictors
    pc, _ = _inputs(MSG_PART, 6, b=2, seed=12)
    with pytest.raises(ValueError, match="cls_label"):
        tp(pc)
    empty = tp(np.zeros((0, N, 6), np.float32), np.zeros(0, np.int32))
    assert empty.shape == (0, N, 50) and empty.dtype == np.float32
    odd = np.array([16, -1], np.int32)
    got = tp(pc, odd)
    np.testing.assert_allclose(got, jp(pc, odd), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(got, tp(pc, np.array([-1, -1], np.int32)))
    assert not np.allclose(got, tp(pc, np.array([0, 0], np.int32)))


@pytest.mark.parametrize("name", ["pointnet2_cls_msg", "pointnet_cls_basic"])
def test_cls_predict_votes(jax_runs, name):
    """predict_votes serves the two new classifiers: (B, 40) float64, the
    views built on the device close to those stacked on the host, and
    the same for the same seed."""
    variables, _ = jax_runs[name]
    pred = Predictor(name, variables, dtype=None, buckets=(4,), device="cpu")
    pc = _inputs(name, 3, b=3, seed=13)[0]
    dev = pred.predict_votes(pc, num_votes=2, rng=0)
    host = pred.predict_votes(pc, num_votes=2, rng=0, on_device=False)
    assert dev.shape == (3, 40) and dev.dtype == np.float64
    np.testing.assert_allclose(dev, host, rtol=2e-3, atol=1e-3)
    np.testing.assert_array_equal(dev, pred.predict_votes(pc, num_votes=2,
                                                          rng=0))


@pytest.mark.parametrize("name", ["pointnet2_cls_msg", "pointnet_cls_basic"])
def test_trainer_takes_the_new_classifiers(tmp_path, name):
    """Trainer builds any registered classifier: one epoch of two steps on
    the CPU (train-mode BN, dropout, the backward of every op) leaves
    finite parameters, most of them moved."""
    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    ds = SyntheticClassification(num_classes=4, samples_per_class=2,
                                 npoints=64, batch_size=4)
    cfg = TrainConfig(model=name, batch_size=4, num_point=64,
                      augment="cls", log_dir=str(tmp_path))
    with Trainer(cfg, device="cpu") as tr:
        start = {k: p.detach().clone()
                 for k, p in tr.init_state().model.named_parameters()}
        state = tr.fit(ds, max_epoch=1)
    assert state.step == 2
    moved = [k for k, p in state.model.named_parameters()
             if not torch.equal(p.detach(), start[k])]
    assert "fc3.dense.weight" in moved and len(moved) > len(start) // 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
