"""The port's serving Predictor held against the JAX Predictor on the CPU,
on the same (converted) variables and the same numpy clouds; and its
results against the model's own outputs, bit for bit, each in memory of
its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.serving import Predictor as JaxPredictor
from pointnet2_tpu_torch import Predictor, flax_to_torch
from pointnet2_tpu_torch.models import get_model
from pointnet2_tpu_torch.utils import profiling

N = 128
# f32 agreement (see test_torch_model): matmul summation order only
F32_TOL = 1e-4
# votes: as tests/test_serving.py:179 — the rotation is rounded by numpy on
# the host path and by a f32 einsum on the device path
VOTE_RTOL, VOTE_ATOL = 2e-3, 1e-3


@pytest.fixture(scope="module")
def variables():
    model = JAX_REGISTRY["pointnet2_cls_ssg"].cls()
    v = jax.jit(lambda r, x: model.init(r, x, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, N, 3), jnp.float32))
    rng = np.random.default_rng(5)

    def redraw(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict) or hasattr(x, "items"):
                out[k] = redraw(x)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            else:
                out[k] = np.asarray(x, np.float32)
        return out

    return redraw(v)


@pytest.fixture(scope="module")
def predictors(variables):
    jp = JaxPredictor("pointnet2_cls_ssg", variables, dtype=None,
                      buckets=(4, 8))
    tp = Predictor("pointnet2_cls_ssg", variables, dtype=None, buckets=(4, 8),
                   device="cpu")
    return jp, tp


def test_bucketed_logits_match_jax(rng, predictors):
    jp, tp = predictors
    pts = rng.rand(11, N, 3).astype(np.float32)  # 8-chunk + pad-to-4
    got = tp(pts)
    assert got.shape == (11, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, jp(pts), atol=F32_TOL, rtol=F32_TOL)
    # bucket padding does not change a row's logits
    model = tp.model
    with torch.inference_mode():
        direct = model(torch.from_numpy(pts[8:])).numpy()
    np.testing.assert_allclose(got[8:], direct, atol=1e-5, rtol=1e-5)


def test_state_dict_and_flax_tree_load_alike(rng, variables, predictors):
    _, tp = predictors
    model = get_model("pointnet2_cls_ssg", device="cpu")
    from_sd = Predictor("pointnet2_cls_ssg", flax_to_torch(variables, model),
                        dtype=None, buckets=(4,), device="cpu")
    pts = rng.rand(3, N, 3).astype(np.float32)
    np.testing.assert_array_equal(from_sd(pts), tp(pts))


def test_predict_proba_matches_jax(rng, predictors):
    jp, tp = predictors
    pts = rng.rand(3, N, 3).astype(np.float32)
    proba = tp.predict_proba(pts)
    np.testing.assert_allclose(proba.sum(axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(proba, jp.predict_proba(pts), atol=1e-5)


def test_empty_batch(predictors):
    _, tp = predictors
    out = tp(np.zeros((0, N, 3), np.float32))
    assert out.shape == (0, 40) and out.dtype == np.float32


def test_predict_votes_device_vs_host_and_jax(rng, predictors):
    jp, tp = predictors
    pts = rng.rand(3, N, 3).astype(np.float32)
    dev = tp.predict_votes(pts, num_votes=3, rng=0, on_device=True)
    host = tp.predict_votes(pts, num_votes=3, rng=0, on_device=False)
    assert dev.shape == host.shape == (3, 40) and dev.dtype == np.float64
    np.testing.assert_allclose(dev, host, rtol=VOTE_RTOL, atol=VOTE_ATOL)
    np.testing.assert_array_equal(
        dev, tp.predict_votes(pts, num_votes=3, rng=0))  # seeded
    np.testing.assert_allclose(
        dev, jp.predict_votes(pts, num_votes=3, rng=0, on_device=True),
        rtol=VOTE_RTOL, atol=VOTE_ATOL)
    np.testing.assert_allclose(
        host, jp.predict_votes(pts, num_votes=3, rng=0, on_device=False),
        rtol=VOTE_RTOL, atol=VOTE_ATOL)


def test_predict_votes_rotate_normals_alike(rng):
    """6-channel clouds: the device path rotates xyz and normals as the
    host path (data/augment.py) does."""
    pred = Predictor("pointnet2_cls_ssg", dtype=None, buckets=(4,),
                     device="cpu", in_channels=6)
    pts = rng.rand(2, N, 6).astype(np.float32)
    dev = pred.predict_votes(pts, num_votes=3, rng=1, on_device=True)
    host = pred.predict_votes(pts, num_votes=3, rng=1, on_device=False)
    np.testing.assert_allclose(dev, host, rtol=VOTE_RTOL, atol=VOTE_ATOL)


def test_bf16_predictor_close_to_f32(rng, variables, predictors):
    """bf16 activations (the serving default) against f32 on the same
    weights: within 2% of the largest logit (see test_torch_model's bf16
    bound), same argmax."""
    _, tp = predictors
    bf = Predictor("pointnet2_cls_ssg", variables, buckets=(4, 8),
                   device="cpu")
    pts = rng.rand(5, N, 3).astype(np.float32)
    want, got = tp(pts), bf(pts)
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_unknown_model_lists_ported():
    with pytest.raises(KeyError, match="pointnet2_cls_ssg"):
        Predictor("pointnet3_cls", device="cpu")


def _model_rows(pred, pts, devices):
    """The model's own float32 logits for ``pts``, run as the Predictor
    runs them: chunks of the largest bucket, each padded with copies of its
    first row to its bucket and cut into ``devices`` shards."""
    top, want = pred._buckets[-1], []
    with torch.inference_mode():
        for s in range(0, len(pts), top):
            chunk = pts[s:s + top]
            k, bucket = len(chunk), pred._bucket_for(len(chunk))
            padded = np.concatenate(
                [chunk, np.repeat(chunk[:1], bucket - k, axis=0)])
            shard = bucket // devices
            want.append(np.concatenate([pred.model(torch.from_numpy(
                padded[i * shard:(i + 1) * shard])).float().numpy()
                for i in range(devices)])[:k])
    return np.concatenate(want)


@pytest.mark.parametrize("name,n,classes", [("pointnet_cls_basic", 32, 4),
                                            ("pointnet2_sem_seg", 128, 21)])
@pytest.mark.parametrize("rows,devices", [
    (3, 1),  # padded to the bucket of 4
    (9, 1),  # above the largest bucket: chunks of 4, 4 and 1
    (3, 2),  # two shards of 2 rows, the second padded
])
def test_results_are_the_models_rows_in_memory_of_their_own(
        name, n, classes, rows, devices):
    """Each result is C-contiguous float32 (b, ...) and equals the model's
    own outputs bit for bit; the next call, on other inputs, leaves it as
    it was and shares no memory with it; on the CPU no row lands in
    page-locked memory."""
    pred = Predictor(name, device="cpu", dtype=None, buckets=(2, 4),
                     num_devices=devices, num_classes=classes)
    rs = np.random.RandomState(rows)
    first, second = (rs.rand(rows, n, 3).astype(np.float32)
                     for _ in range(2))
    got = pred(first)
    want = _model_rows(pred, first, devices)
    per_point = () if name == "pointnet_cls_basic" else (n,)
    assert got.shape == (rows, *per_point, classes)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    profiling.clear_spans()
    try:
        with torch.profiler.profile():
            other = pred(second)
        fetch = profiling.span_stats()["predictor.fetch"]
    finally:
        profiling.clear_spans()
    np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(got, other)
    np.testing.assert_array_equal(other, _model_rows(pred, second, devices))
    assert fetch["counts"] == {"pinned_rows": 0}
