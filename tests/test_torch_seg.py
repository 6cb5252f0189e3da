"""The port's segmentation models and their serving held against the JAX
package on the CPU, on the same (converted) weights and the same numpy
inputs: pointnet2_sem_seg (xyz blocks, and whole scenes through
predict_scene) and pointnet2_part_seg (xyz + normals)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.data.scannet import ScannetDatasetWholeScene
from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.models.losses import segmentation_loss as jax_seg_loss
from pointnet2_tpu.models.losses import (
    weighted_segmentation_loss as jax_wseg_loss,
)
from pointnet2_tpu.serving import Predictor as JaxPredictor
from pointnet2_tpu_torch import (
    PointNet2PartSeg,
    PointNet2SemSeg,
    Predictor,
    flax_to_torch,
)
from pointnet2_tpu_torch.data.scannet import block_members
from pointnet2_tpu_torch.models import (
    get_spec,
    segmentation_loss,
    weighted_segmentation_loss,
)
from tests.test_torch_model import _flax_leaves, _jax_init, _randomize

B, N = 2, 128
# f32: matmul summation order (XLA:CPU vs oneDNN), XLA's FMA-contracted
# distances, and the split first dense of FP (JAX multiplies the concat's
# zero blocks) are float reassociation only
F32_TOL = 1e-4
# bf16 keeps 8 mantissa bits and the two frameworks round a dense before or
# after its bias differently, through 13 (part_seg) to 19 (sem_seg) layers
BF16_TOL = 0.02
MODELS = {"pointnet2_sem_seg": (PointNet2SemSeg, 3, 21),
          "pointnet2_part_seg": (PointNet2PartSeg, 6, 50)}


def _clouds(seed, n_clouds, channels):
    rs = np.random.RandomState(seed)
    pc = rs.rand(n_clouds, N, channels).astype(np.float32)
    if channels == 6:  # unit normals
        pc[..., 3:] = rs.randn(n_clouds, N, 3)
        pc[..., 3:] /= np.linalg.norm(pc[..., 3:], axis=-1, keepdims=True)
    return pc


@pytest.fixture(scope="module", params=sorted(MODELS))
def seg_setup(request):
    name = request.param
    _, channels, _ = MODELS[name]
    pc = _clouds(17, B, channels)
    variables = _randomize(_jax_init(JAX_REGISTRY[name].cls(),
                                     jnp.asarray(pc), train=False), seed=5)
    logits = {}
    for tag, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        model = JAX_REGISTRY[name].cls(dtype=dt)
        out, _ = jax.jit(lambda v, p: model.apply(v, p, train=False))(
            variables, jnp.asarray(pc))
        logits[tag] = np.asarray(out)
    return name, pc, variables, logits


def _port_model(name, variables, dtype=None):
    model = MODELS[name][0](dtype=dtype, device="cpu")
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    return model


def test_flax_to_torch_round_trips_every_leaf(seg_setup):
    """Strict conversion, with no rule beyond the classifier's: every Flax
    leaf lands on exactly one tensor of the port's model, unchanged."""
    name, _, variables, _ = seg_setup
    sd = _port_model(name, variables).state_dict()
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    seen = set()
    for path, leaf in _flax_leaves(variables):
        key = ".".join(path[1:-1] + (names[path[-1]],))
        want = leaf.T if path[-1] == "kernel" else leaf
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
        seen.add(key)
    assert seen == set(sd), "every tensor of the model comes from one leaf"


def test_seg_f32_logits_match_jax(seg_setup):
    name, pc, variables, logits = seg_setup
    with torch.inference_mode():
        got = _port_model(name, variables)(torch.from_numpy(pc))
    assert got.dtype == torch.float32
    assert got.shape == (B, N, MODELS[name][2])
    want = logits["f32"]
    assert np.abs(got.numpy() - want).max() <= F32_TOL * np.abs(want).max()


def test_seg_bf16_logits_match_jax(seg_setup):
    name, pc, variables, logits = seg_setup
    with torch.inference_mode():
        got = _port_model(name, variables, torch.bfloat16)(
            torch.from_numpy(pc)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.abs(logits["f32"]).max()
    assert np.abs(got - logits["bf16"]).max() <= BF16_TOL * scale


def test_seg_predictor_buckets_and_chunks_match_jax(seg_setup):
    """5 clouds through buckets (2, 4): one chunk of 4 and one padded to 2,
    on both sides; a padded row's logits are those of the direct call."""
    name, _, variables, _ = seg_setup
    _, channels, K = MODELS[name]
    pts = _clouds(18, 5, channels)
    tp = Predictor(name, variables, dtype=None, buckets=(2, 4), device="cpu")
    got = tp(pts)
    assert got.shape == (5, N, K) and got.dtype == np.float32
    jp = JaxPredictor(name, variables, dtype=None, buckets=(2, 4))
    want = jp(pts)
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    with torch.inference_mode():
        direct = tp.model(torch.from_numpy(pts[4:])).numpy()
    np.testing.assert_allclose(got[4:], direct, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_seg_empty_request_is_per_point(name):
    """An empty request answers (0, N, K), as the JAX Predictor does."""
    _, channels, K = MODELS[name]
    pred = Predictor(name, dtype=None, buckets=(2,), device="cpu")
    out = pred(np.zeros((0, N, channels), np.float32))
    assert out.shape == (0, N, K) and out.dtype == np.float32


def test_part_seg_needs_normals():
    model = PointNet2PartSeg(device="cpu")
    with pytest.raises(ValueError, match="xyz\\+normal"):
        model(torch.zeros(1, 16, 3))


def test_registry_tasks_and_losses():
    assert get_spec("pointnet2_sem_seg").task == "sem_seg"
    assert get_spec("pointnet2_sem_seg").loss is weighted_segmentation_loss
    assert get_spec("pointnet2_part_seg").task == "part_seg"
    assert get_spec("pointnet2_part_seg").loss is segmentation_loss


@pytest.mark.parametrize("masked", [False, True])
def test_seg_losses_match_jax(masked):
    rs = np.random.RandomState(3)
    logits = rs.randn(3, 16, 5).astype(np.float32)
    labels = rs.randint(0, 5, (3, 16))
    smpw = rs.rand(3, 16).astype(np.float32)
    smpw[:, ::4] = 0.0
    sw = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    tw = None if sw is None else torch.from_numpy(sw)
    jw = None if sw is None else jnp.asarray(sw)
    pairs = [
        (segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           tw),
         jax_seg_loss(jnp.asarray(logits), jnp.asarray(labels), jw)),
        (weighted_segmentation_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(smpw), tw),
         jax_wseg_loss(jnp.asarray(logits), jnp.asarray(labels),
                       jnp.asarray(smpw), jw)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    num, den = weighted_segmentation_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(smpw), tw, sum_count=True)
    jnum, jden = jax_wseg_loss(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(smpw), jw, sum_count=True)
    assert float(den) == float(jden)
    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-6)


def _room(seed, n=700):
    """A small generated room, 3.4 x 2.6 m: a floor, two walls and a box,
    with coordinates that do not start at 0."""
    rs = np.random.default_rng(seed)
    k = n // 4
    floor = np.c_[rs.uniform(0, 3.4, (k, 2)), rs.normal(0, 0.01, k)]
    wall_x = np.c_[rs.uniform(0, 3.4, k), np.zeros(k), rs.uniform(0, 2.5, k)]
    wall_y = np.c_[np.zeros(k), rs.uniform(0, 2.6, k), rs.uniform(0, 2.5, k)]
    box = rs.uniform([1.0, 1.0, 0.0], [1.6, 1.5, 0.8], (n - 3 * k, 3))
    return (np.concatenate([floor, wall_x, wall_y, box]) + [2.0, -1.0, 0.3]
            ).astype(np.float32)


def test_block_members_equal_jax():
    pts = _room(4, 900)
    coordmin = pts.min(0)
    for nx, ny in ((3, 2), (1, 1), (2, 3)):
        got = block_members(pts, coordmin, nx, ny)
        want = ScannetDatasetWholeScene.block_members(pts, coordmin, nx, ny)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def sem_variables():
    pc = _clouds(19, B, 3)
    return _randomize(_jax_init(JAX_REGISTRY["pointnet2_sem_seg"].cls(),
                                jnp.asarray(pc), train=False), seed=6)


def test_predict_scene_matches_jax(sem_variables):
    """Same seed, same draws: the chunks, and so the votes, are JAX's
    exactly; the summed logits agree within f32 tolerance of their range,
    and the labels wherever the top-2 margin exceeds it."""
    pts = _room(5)
    kw = {"dtype": None, "buckets": (4,)}
    got = Predictor("pointnet2_sem_seg", sem_variables, device="cpu",
                    **kw).predict_scene(pts, npoints=N, seed=3)
    want = JaxPredictor("pointnet2_sem_seg", sem_variables,
                        **kw).predict_scene(pts, npoints=N, seed=3)
    assert got["logits"].shape == (len(pts), 21)
    assert got["labels"].dtype == got["votes"].dtype == np.int32
    np.testing.assert_array_equal(got["votes"], want["votes"])
    assert got["votes"].min() >= 1 and got["votes"].max() > 1
    tol = F32_TOL * np.abs(want["logits"]).max()
    assert np.abs(got["logits"] - want["logits"]).max() <= tol
    top2 = np.sort(want["logits"], -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(got["labels"][sure], want["labels"][sure])


def test_predict_scene_seeded_and_empty(sem_variables):
    pred = Predictor("pointnet2_sem_seg", sem_variables, dtype=None,
                     buckets=(4,), device="cpu")
    pts = _room(6, 400)
    a = pred.predict_scene(pts, npoints=N, seed=1)
    b = pred.predict_scene(pts, npoints=N, seed=1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    empty = pred.predict_scene(np.zeros((0, 3), np.float32))
    assert empty["labels"].shape == empty["votes"].shape == (0,)


def test_protocols_refuse_other_tasks():
    part = Predictor("pointnet2_part_seg", buckets=(1,), device="cpu")
    with pytest.raises(ValueError, match="sem_seg"):
        part.predict_scene(_room(7, 100))
    cls = Predictor("pointnet2_cls_ssg", buckets=(1,), device="cpu")
    with pytest.raises(ValueError, match="sem_seg"):
        cls.predict_scene(_room(7, 100))
    sem = Predictor("pointnet2_sem_seg", buckets=(1,), device="cpu")
    with pytest.raises(ValueError, match="classification"):
        sem.predict_votes(np.zeros((1, N, 3), np.float32), 2)
