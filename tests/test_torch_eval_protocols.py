"""The port's evaluation protocols and their data held against the JAX
package on the CPU.

Bit for bit, from the same numpy inputs and seeds: the surface-voxel
labels (both variants), the random z rotation, the whole-scene tiler's
blocks, the crop sampler's thread-pool stream (``num_workers=2``) and the
lockstep zero batches. Exactly equal metric dicts: the four protocols fed
one shared numpy logits oracle, and the same protocols through a JAX model
and the port's model carrying its weights (``flax_to_torch``), f32, whose
summed logits agree within 1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import evaluation as jeval
from pointnet2_tpu.data import augment as jaug
from pointnet2_tpu.data import scannet as jscannet
from pointnet2_tpu.data.shapenet_part import (
    SyntheticShapeNetPart as JaxSyntheticShapeNetPart,
)
from pointnet2_tpu.data.synthetic import (
    SyntheticClassification as JaxSyntheticClassification,
)
from pointnet2_tpu.evaluation import cls_vote as jcls_vote
from pointnet2_tpu.evaluation import part_miou as jpart
from pointnet2_tpu.evaluation import scannet_eval as jscan_eval
from pointnet2_tpu.evaluation.lockstep import (
    lockstep_batches as jax_lockstep_batches,
)
from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.utils import pc_util as jpc
from pointnet2_tpu_torch import evaluation as teval
from pointnet2_tpu_torch import flax_to_torch, get_model
from pointnet2_tpu_torch.data import augment as taug
from pointnet2_tpu_torch.data import scannet as tscannet
from pointnet2_tpu_torch.data.shapenet_part import (
    NUM_PARTS,
    SyntheticShapeNetPart,
)
from pointnet2_tpu_torch.data.synthetic import SyntheticClassification
from pointnet2_tpu_torch.evaluation import cls_vote as tcls_vote
from pointnet2_tpu_torch.evaluation.lockstep import lockstep_batches
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.utils import pc_util as tpc
from tests.test_torch_model import _jax_init, _randomize
from tests.test_torch_scale_out import run_ranks

# the f32 models: matmul summation order (XLA:CPU vs oneDNN) and XLA's
# FMA-contracted distances, as tests/test_torch_seg.py
F32_TOL = 1e-4
QUIET = dict(log_fn=lambda s: None)


def _equal_metrics(got, want, path="metrics"):
    """Metric dicts equal exactly: same keys, floats equal, arrays equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _equal_metrics(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------------------
# data, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [0.02, 0.0484])
@pytest.mark.parametrize("label_dims", [1, 2])
def test_surface_voxel_labels_equal_jax(res, label_dims):
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 0.6, (700, 3)).astype(np.float32)
    pts[:40] = pts[40:80]  # shared voxels
    pts[-1] = pts.max(0)  # the max-coordinate point: the aliased index
    shape = (700,) if label_dims == 1 else (700, 2)
    label = rng.integers(0, 21, shape).astype(np.int64)
    for ours, theirs in (
            (tpc.point_cloud_label_to_surface_voxel_label,
             jpc.point_cloud_label_to_surface_voxel_label),
            (tpc.point_cloud_label_to_surface_voxel_label_fast,
             jpc.point_cloud_label_to_surface_voxel_label_fast)):
        got, want = ours(pts, label, res=res), theirs(pts, label, res=res)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # first-point rule: the first point of each voxel names it
    uvidx, uvlabel, _ = tpc.point_cloud_label_to_surface_voxel_label_fast(
        np.array([[0.001, 0, 0], [0.001, 0, 0], [1.0, 1, 1]]),
        np.array([3, 4, 5]), res=0.05)
    assert len(uvidx) == 2 and uvlabel.tolist() == [3, 5]


@pytest.mark.parametrize("channels", [3, 6])
def test_rotate_point_cloud_z_equals_jax(channels):
    pts = np.random.default_rng(1).standard_normal(
        (5, 33, channels)).astype(np.float32)
    ours, theirs = np.random.default_rng(8), np.random.default_rng(8)
    got = taug.rotate_point_cloud_z(pts, ours)
    want = jaug.rotate_point_cloud_z(pts, theirs)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert ours.random() == theirs.random()  # the same draws were made
    np.testing.assert_array_equal(taug.rotate_point_cloud_z(pts, 4),
                                  jaug.rotate_point_cloud_z(pts, 4))


def _scenes():
    scenes = jscannet.make_synthetic_scenes(2, 3000, seed=5)
    planar = scenes[1][0].copy()
    planar[:, 1] = 0.7  # a zero-extent axis still owns one block
    return scenes + [(planar, scenes[1][1])]


def test_whole_scene_blocks_equal_jax():
    kw = dict(scenes=_scenes(), npoints=96, split="test", seed=3)
    ours = tscannet.ScannetDatasetWholeScene(**kw)
    theirs = jscannet.ScannetDatasetWholeScene(**kw)
    for _ in range(2):  # the second pass reads the cached tiling
        got, want = list(ours.blocks()), list(theirs.blocks())
        assert len(got) == len(want) > 9
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    ps, seg, w = ours.get_item(2)
    assert ps.shape[0] >= 1 and ps.shape[1:] == (96, 3)
    np.testing.assert_array_equal(ps, theirs.get_item(2)[0])


def test_scannet_epoch_with_workers_equals_jax():
    kw = dict(scenes=jscannet.make_synthetic_scenes(5, 3000, seed=2),
              npoints=64, split="train", batch_size=2, seed=7, num_workers=2)
    ours, theirs = tscannet.ScannetDataset(**kw), jscannet.ScannetDataset(**kw)
    inline = tscannet.ScannetDataset(**dict(kw, num_workers=1))
    for _ in range(2):  # the order and seed draws advance alike
        got, want = list(ours.epoch()), list(theirs.epoch())
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and a["nvalid"] == b["nvalid"]
            for k in ("points", "seg", "smpw"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    # per-item seeds drawn up front: a stream of its own, as in JAX
    first = next(iter(inline.epoch()))["points"]
    assert not np.array_equal(first, got[0]["points"])


def test_lockstep_zero_local_batches_feeds_metadata_zero_batches():
    """A process whose shard holds no batch still feeds the agreed number
    of zero batches, built from the dataset's shape metadata."""
    ds = SyntheticClassification(num_classes=5, samples_per_class=1,
                                 npoints=32, batch_size=4, seed=0)
    ds.data, ds.label = ds.data[:0], ds.label[:0]
    assert ds.num_batches() == 0

    class FakeMultihost:
        @staticmethod
        def sync_num_batches(n, reduce="max"):
            assert reduce == "max"
            return 3

    batches = list(lockstep_batches(ds, FakeMultihost))
    jds = JaxSyntheticClassification(num_classes=5, samples_per_class=1,
                                     npoints=32, batch_size=4, seed=0)
    jds.data, jds.label = jds.data[:0], jds.label[:0]
    want = list(jax_lockstep_batches(jds, FakeMultihost))
    assert len(batches) == len(want) == 3
    for b, w in zip(batches, want):
        assert b["nvalid"] == w["nvalid"] == 0
        for k in ("points", "label"):
            assert b[k].dtype == w[k].dtype and b[k].shape == w[k].shape
            assert not b[k].any()
    batches[0]["points"][:] = 1.0  # fresh arrays each yield
    assert not batches[1]["points"].any()


def test_multihost_refuses_more_than_one_rank(tmp_path):
    """Without a process group every helper gives the one-process answer.
    More than one rank no longer raises: on two gloo ranks each helper
    acts over both (the name is the test's from before scale-out was
    ported; tests/test_torch_scale_out.py holds four ranks)."""
    assert multihost.is_primary() and multihost.process_count() == 1
    assert multihost.sync_num_batches(7, "max") == 7
    x = np.arange(3)
    assert multihost.allreduce_sum(x) is x
    multihost.barrier("one")
    ranks = run_ranks({"mh": {"kind": "multihost"}}, 2, tmp_path)
    for r, res in enumerate(ranks):
        mh = res["mh"]
        assert (mh["index"], mh["count"], mh["primary"]) == (r, 2, r == 0)
        assert (mh["min"], mh["max"]) == (3, 4)
        np.testing.assert_array_equal(mh["sum_i"], np.arange(4))
        assert mh["local_batch"] == 4


# ---------------------------------------------------------------------------
# protocols on a shared numpy logits oracle
# ---------------------------------------------------------------------------


def _linear_oracle(k, seed):
    w = np.random.default_rng(seed).standard_normal((6, k)).astype(np.float32)

    def logits(points):
        c = points.shape[-1]
        return np.tanh(points @ w[:c] + 0.1 * (points ** 2) @ w[:c])
    return logits


def test_cls_voting_equals_jax_on_an_oracle():
    kw = dict(num_classes=5, samples_per_class=3, npoints=24, batch_size=4,
              seed=2)
    w = np.random.default_rng(4).standard_normal((5, 5))

    def fn(points):  # features the votes' y rotations leave alone
        y, r = points[..., 1], np.linalg.norm(points[..., ::2], axis=-1)
        f = np.stack([y.mean(1), r.mean(1), y.std(1), r.std(1),
                      np.ones(len(y))], 1)
        return np.tanh(f @ w)

    got = teval.evaluate_cls_voting(fn, SyntheticClassification(**kw),
                                    num_votes=3, num_classes=5, rng=0, **QUIET)
    want = jeval.evaluate_cls_voting(fn, JaxSyntheticClassification(**kw),
                                     num_votes=3, num_classes=5, rng=0,
                                     **QUIET)
    _equal_metrics(got, want)
    assert got["per_class_seen"].sum() == 15  # nvalid rows only
    assert 0 < got["accuracy"] < 1


def _part_fn(batch):
    return _linear_oracle(NUM_PARTS, 11)(batch["points"])


def test_part_seg_voting_equals_jax_on_an_oracle():
    kw = dict(num_samples=6, npoints=32, batch_size=4, seed=1)
    got = teval.evaluate_part_seg_voting(_part_fn, SyntheticShapeNetPart(**kw),
                                         num_votes=3, rng=5, **QUIET)
    want = jpart.evaluate_part_seg_voting(
        _part_fn, JaxSyntheticShapeNetPart(**kw), num_votes=3, rng=5, **QUIET)
    _equal_metrics(got, want)


@pytest.mark.parametrize("case, want_miou", [("absent", 1.0),
                                             ("half_wrong", 0.25)])
def test_part_metrics_absent_part_and_half_wrong(case, want_miou):
    # Laptop has parts [28, 29]
    seg = np.full((1, 16), 28, np.int32)
    logits = np.full((1, 16, NUM_PARTS), -10.0)
    if case == "absent":  # part 29 neither true nor predicted: IoU 1
        logits[:, :, 28] = 10.0
    else:  # IoU(28) = 8/16, IoU(29) = 0/8
        logits[0, :8, 28] = 10.0
        logits[0, 8:, 29] = 10.0
    ours, theirs = teval.PartSegMetrics(), jeval.PartSegMetrics()
    ours.update(logits, seg)
    theirs.update(logits, seg)
    got = ours.allreduced().result(**QUIET)
    _equal_metrics(got, theirs.result(**QUIET))
    assert got["instance_miou"] == pytest.approx(want_miou)
    assert got["category_miou"]["Laptop"] == pytest.approx(want_miou)
    # the constrained argmax stays in the category's parts
    wide = np.full((1, 4, NUM_PARTS), -10.0)
    wide[:, :, 30] = 10.0
    wide[:, :, 2] = 1.0
    pred = teval.constrained_part_prediction(wide, np.zeros((1, 4), np.int32))
    assert set(pred.ravel()) == {2}


def _scan_fn(batch):
    return _linear_oracle(21, 13)(batch["points"] * 0.5)


def test_scannet_chopped_and_whole_scene_equal_jax_on_an_oracle():
    scenes = _scenes()
    kw = dict(scenes=scenes, npoints=96, split="test", batch_size=2, seed=1)
    got = teval.evaluate_scannet_chopped(
        _scan_fn, tscannet.ScannetDataset(**kw), rng=0, **QUIET)
    want = jscan_eval.evaluate_scannet_chopped(
        _scan_fn, jscannet.ScannetDataset(**kw), rng=0, **QUIET)
    _equal_metrics(got, want)
    assert 0 < got["point_accuracy"] < 1
    got = teval.evaluate_scannet_whole_scene(
        _scan_fn, tscannet.ScannetDatasetWholeScene(**kw), batch_size=4,
        **QUIET)
    want = jscan_eval.evaluate_scannet_whole_scene(
        _scan_fn, jscannet.ScannetDatasetWholeScene(**kw), batch_size=4,
        **QUIET)
    _equal_metrics(got, want)
    assert 0 < got["calibrated_accuracy_vox"] < 1
    m = teval.ScanNetMetrics()
    m.update(np.random.default_rng(0).random((1, 50, 3)),
             np.ones((1, 50), np.int64), np.ones((1, 50), np.int64),
             np.ones((1, 50), np.float32))
    assert np.array_equal(
        teval.ScanNetMetrics().load_counters(m.counters()).counters(),
        m.counters())


def test_scannet_eval_protocol_scores_as_jax():
    """make_scannet_eval_protocol through a stand-in trainer: the
    whole-scene calibrated voxel accuracy, the two passes logged."""
    kw = dict(scenes=_scenes(), npoints=64, split="test", batch_size=2)

    class Stub:
        def __init__(self):
            self.rows = []

        def eval_logits_fn(self, state):
            return _scan_fn

        def log(self, msg):
            pass

        def log_metrics(self, **kv):
            self.rows.append(kv)

    scores = []
    for pkg, ds in ((teval, tscannet), (jscan_eval, jscannet)):
        protocol = pkg.make_scannet_eval_protocol(
            ds.ScannetDataset(**kw), ds.ScannetDatasetWholeScene(**kw),
            batch_size=2, seed=0)
        stub = Stub()
        scores.append([protocol(stub, None, e) for e in range(2)])
        assert [r["split"] for r in stub.rows] == [
            "eval_chopped", "eval_whole_scene"] * 2
    assert scores[0] == scores[1]


# ---------------------------------------------------------------------------
# protocols through real models on the same weights
# ---------------------------------------------------------------------------


def _models(name, channels, n):
    pc = np.random.default_rng(0).random((2, n, channels), np.float32)
    jmodel = JAX_REGISTRY[name].cls()
    variables = _randomize(_jax_init(jmodel, jnp.asarray(pc), train=False),
                           seed=9)
    apply = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False)[0])
    model = get_model(name, device="cpu")
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    model.eval()

    def jax_fn(batch):
        return np.asarray(apply(variables, jnp.asarray(batch["points"])))

    @torch.inference_mode()
    def port_fn(batch):
        return model(torch.from_numpy(
            np.asarray(batch["points"], np.float32))).numpy()
    return jax_fn, port_fn


def _margin(logits):
    """Smallest top-2 gap of the summed logits: a prediction can differ
    between the packages only where it is within their tolerance."""
    top = np.sort(logits, axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= F32_TOL * scale, (what, err, scale)
    return err


def _recorder(fn, calls):
    def run(batch):
        out = fn(batch)
        calls.append(np.asarray(out, np.float64))
        return out
    return run


def _vote_sums(calls, votes):
    return [sum(np.split(c, votes)) for c in calls]


def test_cls_voting_through_models_equals_jax():
    jax_fn, port_fn = _models("pointnet2_cls_ssg", 3, 128)
    kw = dict(num_classes=4, samples_per_class=2, npoints=128, batch_size=4,
              seed=3)
    ours, theirs = [], []
    got = teval.evaluate_cls_voting(
        _recorder(lambda p: port_fn({"points": p}), ours),
        SyntheticClassification(**kw), num_votes=3, num_classes=40, rng=0,
        **QUIET)
    want = jeval.evaluate_cls_voting(
        _recorder(lambda p: jax_fn({"points": p}), theirs),
        JaxSyntheticClassification(**kw), num_votes=3, num_classes=40, rng=0,
        **QUIET)
    assert len(ours) == len(theirs) == 2
    sums, jsums = _vote_sums(ours, 3), _vote_sums(theirs, 3)
    for a, b in zip(sums, jsums):
        _close(a, b, "summed vote logits")
    assert got["accuracy"] == want["accuracy"], \
        f"smallest top-2 margin {min(map(_margin, jsums))}"
    _equal_metrics(got, want)


def test_part_seg_voting_through_models_equals_jax():
    jax_fn, port_fn = _models("pointnet2_part_seg", 6, 128)
    kw = dict(num_samples=4, npoints=128, batch_size=4, seed=2)
    ours, theirs = [], []
    got = teval.evaluate_part_seg_voting(
        _recorder(port_fn, ours), SyntheticShapeNetPart(**kw), num_votes=2,
        rng=0, **QUIET)
    want = jpart.evaluate_part_seg_voting(
        _recorder(jax_fn, theirs), JaxSyntheticShapeNetPart(**kw),
        num_votes=2, rng=0, **QUIET)
    assert len(ours) == len(theirs) == 1
    # the protocol's one batch, its perms redrawn from the same seed: the
    # votes' logits scattered back to the points and summed
    pts = next(iter(SyntheticShapeNetPart(**kw).epoch()))["points"]
    rng = np.random.default_rng(0)
    perms = [rng.permutation(128) for _ in range(2)]
    sums = []
    for calls in (ours, theirs):
        summed = np.zeros((4, 128, NUM_PARTS))
        for v, perm in enumerate(perms):
            summed[:, perm] += calls[0].reshape(2, 4, 128, -1)[v]
        sums.append(summed)
    _close(sums[0], sums[1], "summed part logits")
    assert got["accuracy"] == want["accuracy"], \
        f"smallest top-2 margin {_margin(sums[1])}"
    _equal_metrics(got, want)


@pytest.mark.parametrize("which", ["chopped", "whole_scene"])
def test_scannet_protocols_through_models_equal_jax(which):
    jax_fn, port_fn = _models("pointnet2_sem_seg", 3, 128)
    kw = dict(scenes=jscannet.make_synthetic_scenes(2, 2500, seed=4),
              npoints=128, split="test", batch_size=4, seed=0)
    if which == "chopped":
        run, jrun = (teval.evaluate_scannet_chopped,
                     jscan_eval.evaluate_scannet_chopped)
        ds, extra = "ScannetDataset", dict(rng=0)
    else:
        run, jrun = (teval.evaluate_scannet_whole_scene,
                     jscan_eval.evaluate_scannet_whole_scene)
        ds, extra = "ScannetDatasetWholeScene", dict(batch_size=4)
    ours, theirs = [], []
    got = run(_recorder(port_fn, ours), getattr(tscannet, ds)(**kw),
              **extra, **QUIET)
    want = jrun(_recorder(jax_fn, theirs), getattr(jscannet, ds)(**kw),
                **extra, **QUIET)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        _close(a, b, f"{which} logits")
    assert got["point_accuracy"] == want["point_accuracy"], \
        f"smallest top-2 margin {min(map(_margin, theirs))}"
    _equal_metrics(got, want)
