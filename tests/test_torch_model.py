"""The port's layers and pointnet2_cls_ssg held against the JAX package on
the CPU, on the same weights.

Flax variables are initialised by the JAX package, then every BN scale,
bias and running statistic and every dense bias is redrawn from a numpy
seed (so eval BN is not the identity and both max and min branches of the
pool-before-affine tail run), converted with flax_to_torch, and loaded into
the port. The same numpy clouds go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import config as jax_config
from pointnet2_tpu import nn as jnn
from pointnet2_tpu.models import PointNet2ClsSSG as JaxClsSSG
from pointnet2_tpu_torch import PointNet2ClsSSG, config, flax_to_torch
from pointnet2_tpu_torch import nn as tnn

B, N = 2, 128
# f32 agreement: the two sides differ only in matmul summation order
# (XLA:CPU vs oneDNN) and where a near-tie in a max-pool resolves.
F32_TOL = 1e-4


def _randomize(variables, seed):
    """Numpy copy of a Flax tree with BN parameters/statistics and dense
    biases redrawn: scale |s| in [0.5, 1.5] with ~20% negative, biases and
    means ~N(0, 0.1^2), variances in [0.5, 1.5]. Kernels are kept."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if k == "scale":
                sign = np.where(rng.random(v.shape) < 0.2, -1.0, 1.0)
                v = (sign * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(variables, ())


def _jax_init(module, *args, **kw):
    return jax.jit(lambda r, *a: module.init(r, *a, **kw))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args)


@pytest.fixture(scope="module")
def cls_setup():
    pc = np.random.RandomState(7).rand(B, N, 3).astype(np.float32)
    variables = _randomize(_jax_init(JaxClsSSG(), jnp.asarray(pc),
                                     train=False), seed=3)
    logits = {}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        model = JaxClsSSG(dtype=dt)
        out, _ = jax.jit(lambda v, p: model.apply(v, p, train=False))(
            variables, jnp.asarray(pc))
        logits[name] = np.asarray(out)
    return pc, variables, logits


def _port_model(variables, dtype=None):
    model = PointNet2ClsSSG(dtype=dtype, device="cpu")
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    return model


def _flax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_flax_to_torch_round_trips_every_leaf(cls_setup):
    _, variables, _ = cls_setup
    model = _port_model(variables)
    sd = model.state_dict()
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    seen = set()
    for path, leaf in _flax_leaves(variables):
        key = ".".join(path[1:-1] + (names[path[-1]],))
        want = leaf.T if path[-1] == "kernel" else leaf
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
        seen.add(key)
    assert seen == set(sd), "every tensor of the model comes from one leaf"


def test_flax_to_torch_is_strict(cls_setup):
    _, variables, _ = cls_setup
    model = PointNet2ClsSSG(device="cpu")
    missing = {c: dict(t) for c, t in variables.items()}
    missing["params"] = dict(missing["params"])
    del missing["params"]["fc1"]
    with pytest.raises(ValueError, match="missing"):
        flax_to_torch(missing, model)
    extra = {c: dict(t) for c, t in variables.items()}
    extra["batch_stats"] = dict(extra["batch_stats"])
    extra["batch_stats"]["fc3"] = {"norm": {"mean": np.zeros(40, np.float32),
                                            "var": np.ones(40, np.float32)}}
    with pytest.raises(ValueError, match="unexpected"):
        flax_to_torch(extra, model)
    with pytest.raises(ValueError, match="no conversion rule"):
        flax_to_torch({"params": {"fc1": {"dense": {"w": np.zeros(3)}}}})
    with pytest.raises(ValueError, match="collections"):
        flax_to_torch({**variables, "cache": {}})


def test_cls_ssg_f32_logits_match_jax(cls_setup):
    pc, variables, logits = cls_setup
    model = _port_model(variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(pc))
    assert got.dtype == torch.float32 and got.shape == (B, 40)
    np.testing.assert_allclose(got.numpy(), logits["f32"], atol=F32_TOL,
                               rtol=F32_TOL)


def test_cls_ssg_bf16_logits_match_jax(cls_setup):
    """bf16 keeps 8 mantissa bits, and the two frameworks round at different
    places (XLA rounds the bf16 dot before adding the bias, oneDNN adds the
    bias before its one rounding), so single-ulp differences (2^-8 of a
    value) propagate through 11 layers; geometry and indices are f32 on
    both sides and identical. Bound: 2% of the largest f32 logit, and the
    argmax agrees."""
    pc, variables, logits = cls_setup
    model = _port_model(variables, dtype=torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(pc)).numpy()
    want = logits["bf16"]
    assert got.dtype == np.float32
    scale = np.abs(logits["f32"]).max()
    assert np.abs(got - want).max() <= 0.02 * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_cls_ssg_with_normals_matches_jax():
    """(B, N, 6) clouds: channels 3: are SA1's point features."""
    pc = np.random.RandomState(8).rand(B, N, 6).astype(np.float32)
    model_j = JaxClsSSG()
    variables = _randomize(_jax_init(model_j, jnp.asarray(pc), train=False),
                           seed=4)
    want, _ = jax.jit(lambda v, p: model_j.apply(v, p, train=False))(
        variables, jnp.asarray(pc))
    model = PointNet2ClsSSG(in_channels=6, device="cpu")
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(pc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("pooled", [True, False])
@pytest.mark.parametrize("C", [0, 5])
def test_set_abstraction_fused_matches_jax(rng, C, pooled):
    """Both sides with the pool-before-affine gate on (the default) and off
    (BN+ReLU on the grouped tensor, then the max-pool)."""
    xyz = rng.rand(B, 64, 3).astype(np.float32)
    pts = rng.randn(B, 64, C).astype(np.float32) if C else None
    jsa = jnn.SetAbstraction(32, 0.3, 8, (16, 16, 32))
    args = (jnp.asarray(xyz), None if pts is None else jnp.asarray(pts))
    variables = _randomize(_jax_init(jsa, *args), seed=11)
    with jax_config.pooled_max(pooled):
        wxyz, wpts, widx = jax.jit(lambda v, *a: jsa.apply(v, *a))(
            variables, *args)
    sa = tnn.SetAbstraction(32, 0.3, 8, C, (16, 16, 32)).eval()
    sa.load_state_dict(flax_to_torch(variables, sa), strict=True)
    with torch.inference_mode(), config.pooled_max(pooled):
        nxyz, npts, idx = sa(torch.from_numpy(xyz),
                             None if pts is None else torch.from_numpy(pts))
    np.testing.assert_array_equal(nxyz.numpy(), np.asarray(wxyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(npts.numpy(), np.asarray(wpts), atol=F32_TOL,
                               rtol=F32_TOL)


def test_set_abstraction_group_all_matches_jax(rng):
    xyz = rng.rand(B, 48, 3).astype(np.float32)
    pts = rng.randn(B, 48, 6).astype(np.float32)
    jsa = jnn.SetAbstraction(None, None, None, (16, 32), group_all=True)
    args = (jnp.asarray(xyz), jnp.asarray(pts))
    variables = _randomize(_jax_init(jsa, *args), seed=12)
    wxyz, wpts, widx = jax.jit(lambda v, *a: jsa.apply(v, *a))(variables,
                                                              *args)
    sa = tnn.SetAbstraction(None, None, None, 6, (16, 32),
                            group_all=True).eval()
    sa.load_state_dict(flax_to_torch(variables, sa), strict=True)
    with torch.inference_mode():
        nxyz, npts, idx = sa(torch.from_numpy(xyz), torch.from_numpy(pts))
    np.testing.assert_array_equal(nxyz.numpy(), np.asarray(wxyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(npts.numpy(), np.asarray(wpts), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("features", [(16,), (16, 16, 24)])
def test_shared_mlp_finish_first_pooled_matches_jax(rng, features):
    x_in = rng.randn(B, 8, 6, 5).astype(np.float32)
    pre = rng.randn(B, 8, 6, features[0]).astype(np.float32)
    jmlp = jnn.SharedMLP(features)
    variables = _randomize(_jax_init(jmlp, jnp.asarray(x_in)), seed=13)
    want = jmlp.apply(variables, jnp.asarray(pre), axis=2,
                      method=jnn.SharedMLP.finish_first_pooled)
    mlp = tnn.SharedMLP(5, features).eval()
    mlp.load_state_dict(flax_to_torch(variables, mlp), strict=True)
    with torch.inference_mode():
        got = mlp.finish_first_pooled(torch.from_numpy(pre), dim=2)
        unpooled = mlp.finish_first(torch.from_numpy(pre)).amax(dim=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    # pool-before-affine equals pooling after the full tail
    np.testing.assert_allclose(got.numpy(), unpooled.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_batchnorm_train_mode_uses_batch_statistics():
    """In train mode BatchNorm normalises with the batch's statistics
    (biased var) while updating the running ones by running*m +
    batch*(1-m); eval uses and keeps the running ones."""
    bn = tnn.BatchNorm(4)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    y = bn(x, 0.25)
    mean, var = x.mean(0), x.var(0, unbiased=False)
    torch.testing.assert_close(y, (x - mean) / torch.sqrt(var + 1e-3))
    torch.testing.assert_close(bn.running_mean, 0.75 * mean)
    torch.testing.assert_close(bn.running_var, 0.25 + 0.75 * var)
    bn.eval()
    before = bn.running_mean.clone()
    with torch.no_grad():
        bn(x, 0.25)
    torch.testing.assert_close(bn.running_mean, before, rtol=0, atol=0)
