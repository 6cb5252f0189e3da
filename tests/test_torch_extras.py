"""The port's conv/pool layer zoo (``nn/extras.py``) against the JAX
package's, on the same numpy inputs and converted weights.

Each Flax layer is initialised by JAX, its variables go through
``convert.flax_to_torch`` into the port's layer (the ``Conv_0``,
``ConvTranspose_0`` and ``BatchNorm_0`` rules), and both run the same
channels-last input: in eval mode, and in train mode with BN, where the
updated running statistics are compared too. Convolutions in float32 are
held within 1e-5 of max|y|, running statistics within 1e-6; the max pools
bit for bit and the average pools within 1e-6. The cases cover odd and even
inputs, kernels and strides, ``SAME`` (asymmetric with stride 2) and
``VALID``, and a transposed conv whose kernel is smaller than its stride.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.nn import extras as jx
from pointnet2_tpu_torch.convert import flax_to_torch
from pointnet2_tpu_torch.nn import extras as tx


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors are tiny: one intra-op thread leaves the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


# (name, spatial input shape, kernel, strides)
CONV_CASES = [
    ("Conv1D", (9,), (3,), (1,)),
    ("Conv1D", (8,), (4,), (2,)),
    ("Conv2D", (6, 6), (3, 3), (2, 2)),
    ("Conv2D", (7, 5), (2, 3), (2, 1)),
    ("Conv2D", (5, 6), (3, 3), (1, 1)),
    ("Conv3D", (5, 4, 6), (3, 2, 3), (2, 2, 1)),
    ("Conv3D", (4, 4, 4), (3, 3, 3), (1, 1, 1)),
    ("Conv2DTranspose", (5, 6), (3, 3), (2, 2)),
    ("Conv2DTranspose", (4, 5), (2, 4), (2, 2)),
    ("Conv2DTranspose", (3, 4), (2, 3), (3, 1)),
    ("Conv2DTranspose", (5, 5), (3, 3), (1, 1)),
    ("Conv2DTranspose", (4, 3), (5, 4), (2, 3)),
]


def _pair(name, spatial, kernel, strides, padding, bn, cin=3, cout=5,
          seed=0):
    """(Flax layer, its variables, the port's layer with them, input)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *spatial, cin)).astype(np.float32)
    flax_layer = getattr(jx, name)(cout, kernel_size=kernel, strides=strides,
                                   padding=padding, bn=bn)
    variables = flax_layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    if bn:  # running statistics away from their (0, 1) start
        stats = variables["batch_stats"]["BatchNorm_0"]
        variables = {"params": variables["params"], "batch_stats": {
            "BatchNorm_0": {
                "mean": jnp.asarray(rng.normal(size=cout), jnp.float32),
                "var": jnp.asarray(rng.uniform(0.5, 2, cout), jnp.float32)}}}
        assert stats["mean"].shape == (cout,)
    layer = getattr(tx, name)(cin, cout, kernel, strides, padding, bn=bn)
    layer.load_state_dict(flax_to_torch(variables, layer), strict=True)
    return flax_layer, variables, layer, x


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name,spatial,kernel,strides", CONV_CASES)
def test_conv_eval_matches_jax(name, spatial, kernel, strides, padding):
    flax_layer, variables, layer, x = _pair(name, spatial, kernel, strides,
                                            padding, bn=False)
    want = np.asarray(flax_layer.apply(variables, jnp.asarray(x)))
    got = layer.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name,spatial,kernel,strides", CONV_CASES[::3])
def test_conv_bn_train_and_eval_match_jax(name, spatial, kernel, strides):
    flax_layer, variables, layer, x = _pair(name, spatial, kernel, strides,
                                            "SAME", bn=True, seed=1)
    want = np.asarray(flax_layer.apply(variables, jnp.asarray(x)))
    got = layer.eval()(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= 1e-5
    want, upd = flax_layer.apply(variables, jnp.asarray(x), train=True,
                                 bn_momentum=0.7, mutable=["batch_stats"])
    got = layer.train()(torch.from_numpy(x), 0.7).detach().numpy()
    assert _rel(got, want) <= 1e-5
    stats = upd["batch_stats"]["BatchNorm_0"]
    norm = layer.BatchNorm_0
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)


def test_convert_layouts():
    """A Flax conv kernel (k..., Cin, Cout) lands as (Cout, Cin, k...); a
    transposed one as (Cin, Cout, k...) flipped."""
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    sd = flax_to_torch({"params": {"Conv_0": {"kernel": k,
                                              "bias": np.zeros(5)}}})
    np.testing.assert_array_equal(sd["Conv_0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    sd = flax_to_torch({"params": {"ConvTranspose_0": {
        "kernel": k, "bias": np.zeros(5)}}})
    np.testing.assert_array_equal(sd["ConvTranspose_0.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_same_pads_tf_rule():
    # k=3, s=2 on 6: total 1, all of it after (TF's rule)
    assert tx.same_pads((6,), (3,), (2,)) == [(0, 1)]
    assert tx.same_pads((7,), (3,), (2,)) == [(1, 1)]
    assert tx.same_pads((5,), (4,), (1,)) == [(1, 2)]


# (name, spatial input shape, window, strides)
POOL_CASES = [
    ("2d", (6, 6), (2, 2), (2, 2)),
    ("2d", (7, 5), (3, 3), (2, 2)),
    ("2d", (5, 6), (3, 2), (1, 2)),
    ("3d", (5, 4, 6), (2, 2, 2), (2, 2, 2)),
    ("3d", (5, 5, 3), (3, 3, 2), (2, 1, 2)),
]


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("nd,spatial,window,strides", POOL_CASES)
def test_pools_match_jax(nd, spatial, window, strides, padding):
    x = np.random.default_rng(2).normal(size=(2, *spatial, 4)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    want = np.asarray(getattr(jx, f"max_pool{nd}")(
        jnp.asarray(x), window, strides, padding))
    got = getattr(tx, f"max_pool{nd}")(xt, window, strides, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want = np.asarray(getattr(jx, f"avg_pool{nd}")(
        jnp.asarray(x), window, strides, padding))
    got = getattr(tx, f"avg_pool{nd}")(xt, window, strides, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_conv_gradient_flows():
    layer = tx.Conv2D(3, 4, (3, 3), (2, 2), bn=True).train()
    x = torch.randn(2, 6, 6, 3, requires_grad=True)
    layer(x).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert layer.conv.weight.grad.shape == (4, 3, 3, 3)
