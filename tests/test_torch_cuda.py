"""The port's CUDA kernels held against their plain PyTorch versions on the
card, at small shapes and at the edge cases of their contracts.

Needs an NVIDIA GPU and nvcc; every test skips without a card. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (BWD, LAYER_LIMITS, Checks, chain_terms,
                        check_tensor_cores, first_occurrence_case,
                        fixed_step, fused_layer_errs, g_ok, scatter_same,
                        sum_ok, y_ok)
from pointnet2_tpu_torch import Predictor, config
from pointnet2_tpu_torch import ops

pytestmark = pytest.mark.cuda

_CSRC = Path(__file__).resolve().parent.parent / "pointnet2_tpu_torch" / "csrc"


def _const(src: str, name: str) -> int:
    text = (_CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


TILE = _const("ball_query.cu", "kTile")
FIRST = {n: _const("fused_mlp.cu", n)
         for n in ("kFirstThreads", "kFirstRows", "kFirstBlocks")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rs():
    return np.random.RandomState(1234)


def _plain(fn, *args):
    with config.default_impl("torch"):
        return fn(*args)


@pytest.mark.parametrize("B,N,npoint", [(2, 1024, 512), (3, 100, 17),
                                        (1, 40, 64), (2, 5000, 64),
                                        (2, 8192, 1024), (2, 4096, 64),
                                        (1, 16384, 100), (1, 16385, 64),
                                        (2, 20000, 256), (2, 65536, 512),
                                        (1, 180000, 2048), (1, 262144, 64),
                                        (1, 262145, 64), (1, 1000000, 32)])
def test_fps_kernel_bit_identical(dev, rs, B, N, npoint):
    """(2, 8192, 1024) is sem_seg SA1's shape at B=2; at N=4096 the cloud
    alone fills the 48 KB of shared memory a block has without the
    opt-in, and the partials beside it need the opt-in. Above 16384
    points the cluster route: C = 2 (16385, 20000), 4 (65536) and 16
    (a whole ScanNet room of 180000; 262144, its registers' edge); above
    262144 the scratch route (262145; a lidar-sized 1000000)."""
    xyz = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32)).to(dev)
    before = ops.fps_kernel.launches
    got = ops.farthest_point_sample(xyz, npoint)
    assert ops.fps_kernel.launches == before + 1
    torch.testing.assert_close(got, _plain(ops.farthest_point_sample, xyz,
                                           npoint), rtol=0, atol=0)


def test_fps_kernel_repeated_points(dev):
    """Every distance is 0 after the seed: each step picks index 0, the
    lowest of the tied points, over the (bits 0, INT_MAX) sentinel of the
    threads without a point; two distinct points repeated: the other one,
    then 0."""
    same = torch.full((2, 1000, 3), 0.25, device=dev)
    got = ops.farthest_point_sample(same, 50)
    torch.testing.assert_close(got, _plain(ops.farthest_point_sample, same,
                                           50), rtol=0, atol=0)
    assert not bool(got.any())
    two = torch.zeros((1, 600, 3), device=dev)
    two[0, 1::2] = 1.0
    got = ops.farthest_point_sample(two, 6)
    torch.testing.assert_close(got, _plain(ops.farthest_point_sample, two, 6),
                               rtol=0, atol=0)
    assert got.tolist() == [[0, 1, 0, 0, 0, 0]]


def test_fps_kernel_ties(dev):
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1)
    xyz = torch.from_numpy(g.reshape(1, 64, 3).astype(np.float32)).to(dev)
    torch.testing.assert_close(ops.farthest_point_sample(xyz, 40),
                               _plain(ops.farthest_point_sample, xyz, 40),
                               rtol=0, atol=0)


def _far_copies(rs, n: int, at) -> np.ndarray:
    """A cloud of n points in the unit cube with one far point copied to
    each index of ``at``: the first pick ties across those indices."""
    xyz = rs.rand(1, n, 3).astype(np.float32)
    xyz[0, list(at)] = 5.0
    return xyz


@pytest.mark.parametrize("side,npoint", [(26, 200), (40, 256), (64, 64),
                                         (70, 48)])
def test_fps_cluster_ties_across_slices(dev, rs, monkeypatch, side,
                                        npoint):
    """Integer lattices of 17576 (C=2), 64000 (C=4), 262144 (C=16) and
    343000 points (the scratch route), whose equal distances straddle
    the slices; and one far point copied into the last, the second and
    the third slice of a 50000-point cloud (C=4, S=12500), where the
    lowest copy, in slice 1, must win. Bit for bit fps_plain, one launch
    a call, and the kernel route never reaches fps_plain."""
    from pointnet2_tpu_torch.ops import sampling

    g = np.stack(np.meshgrid(*[np.arange(float(side))] * 3, indexing="ij"),
                 -1).reshape(1, -1, 3).astype(np.float32)
    far = _far_copies(rs, 50000, (45000, 13000, 26000))
    for cloud in (g, far):
        xyz = torch.from_numpy(cloud).to(dev)
        want = sampling.fps_plain(xyz, npoint)
        before = ops.fps_kernel.launches
        with monkeypatch.context() as m:
            m.setattr(sampling, "fps_plain", None)  # any call would raise
            got = ops.farthest_point_sample(xyz, npoint)
        assert ops.fps_kernel.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(got[0, 1]) == 13000


def test_fps_cluster_identical_points(dev):
    """40000 identical points (C=4): every distance is 0 after the seed,
    so every pick is index 0, over slices that hold only ties."""
    same = torch.full((2, 40000, 3), -0.5, device=dev)
    got = ops.farthest_point_sample(same, 64)
    assert not bool(got.any())
    torch.testing.assert_close(got, _plain(ops.farthest_point_sample, same,
                                           64), rtol=0, atol=0)


def test_fps_scratch_route_needs_its_scratch(dev):
    """Above 262144 points the launch without the wrapper's scratch is
    refused by the C entry point, and the refusal raises."""
    from pointnet2_tpu_torch.ops import sampling

    xyz = torch.zeros((1, 262145, 3), device=dev)
    out = torch.empty((1, 4), dtype=torch.int32, device=dev)
    assert sampling.fps_route(262145) == ("scratch", 16)
    with pytest.raises(RuntimeError, match="fps launch"):
        sampling.launch_fps(xyz, out, None)


@pytest.mark.parametrize("B,N,M,radius,nsample",
                         [(2, 1024, 512, 0.2, 32), (2, 512, 128, 0.4, 64),
                          (3, 100, 17, 0.2, 8), (2, 20, 8, 0.5, 32),
                          (1, 300, 40, 2.0, 64),
                          # each side of the staged tiles' edges (1024 and
                          # 2048 points), walks through every tile and
                          # walks that end in the first
                          (2, 1023, 40, 0.1, 64), (2, 1024, 40, 0.1, 64),
                          (2, 1025, 40, 0.1, 64), (2, 2047, 24, 0.15, 32),
                          (2, 2048, 24, 0.5, 32), (2, 2049, 24, 0.15, 32),
                          (16, 8192, 1024, 0.1, 32),  # sem_seg SA1
                          (3, 700, 13, 0.3, 16),  # M not a multiple of 8
                          (2, 1, 5, 0.2, 4),  # N = 1
                          (2, 3000, 40, 2.0, 32)])  # every point a hit
def test_ball_query_kernel_bit_identical(dev, rs, B, N, M, radius, nsample):
    xyz1 = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32)).to(dev)
    xyz2 = xyz1[:, torch.from_numpy(rs.randint(0, N, M)).to(dev)]
    before = ops.ball_query_kernel.launches
    idx, cnt = ops.query_ball_point(radius, nsample, xyz1, xyz2)
    assert ops.ball_query_kernel.launches == before + 1
    widx, wcnt = _plain(ops.query_ball_point, radius, nsample, xyz1, xyz2)
    torch.testing.assert_close(cnt, wcnt, rtol=0, atol=0)
    torch.testing.assert_close(idx, widx, rtol=0, atol=0)


def test_ball_query_kernel_boundary_and_empty(dev):
    r = 0.1
    d = float(np.sqrt(np.float32(np.float32(r) ** 2)))
    xyz = torch.tensor([[[0.0, 0.0, 0.0], [d, 0.0, 0.0], [0.05, 0.0, 0.0],
                         [0.5, 0.5, 0.5]]], device=dev)
    q = torch.tensor([[[0.0, 0.0, 0.0], [-3.0, -3.0, -3.0]]], device=dev)
    idx, cnt = ops.query_ball_point(r, 3, xyz, q)
    assert idx.tolist() == [[[0, 2, 0], [0, 0, 0]]]
    assert cnt.tolist() == [[2, 0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3, 5, 64, 128])
def test_gather_kernel_bitwise(dev, rs, dtype, C):
    pts = torch.from_numpy(rs.randn(2, 300, C).astype(np.float32)).to(
        dev, dtype)
    idx = torch.from_numpy(rs.randint(0, 300, (2, 40, 7)).astype(
        np.int32)).to(dev)
    before = ops.gather_rows_kernel.launches
    got = ops.group_point(pts, idx)
    assert ops.gather_rows_kernel.launches == before + 1
    want = _plain(ops.group_point, pts, idx)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_kernel_wrappers_refuse_what_they_do_not_take(dev):
    with pytest.raises(TypeError):
        ops.fps_kernel(torch.zeros(1, 8, 3, device=dev, dtype=torch.float64),
                       4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_rows_kernel(torch.zeros(1, 3, 8, device=dev).transpose(1, 2),
                               torch.zeros(1, 2, dtype=torch.int32,
                                           device=dev))
    # N above one CTA's 16384 points answers (the cluster route), as JAX's
    # FPS does
    big = torch.rand((1, 20000, 3), device=dev)
    torch.testing.assert_close(ops.fps_kernel(big, 4),
                               _plain(ops.farthest_point_sample, big, 4),
                               rtol=0, atol=0)


def test_predictor_on_card_matches_cpu(dev, rs):
    """Kernel path on the card vs plain path on the CPU, f32, same seeded
    weights: only matmul summation order differs."""
    pts = rs.rand(3, 256, 3).astype(np.float32)
    gpu = Predictor("pointnet2_cls_ssg", dtype=None, buckets=(4,))
    cpu = Predictor("pointnet2_cls_ssg", dtype=None, buckets=(4,),
                    device="cpu")
    np.testing.assert_allclose(gpu(pts), cpu(pts), rtol=1e-4, atol=1e-4)


def test_predictor_results_land_in_page_locked_memory(dev, rs):
    """bf16 sem_seg requests of 16 blocks and of 65 (above the largest
    bucket, 64): each result is page-locked, equals the model's own float32
    logits bit for bit, and shares no memory with the other live result;
    ``pinned_rows`` counts every row served. After a warm-up request, ten
    more make no new page-locked allocation: dropped results go back to
    PyTorch's host cache and are handed out again."""
    from pointnet2_tpu_torch.utils import profiling

    pred = Predictor("pointnet2_sem_seg")
    small, big = (rs.rand(b, 8192, 3).astype(np.float32) for b in (16, 65))

    def own(x):
        with torch.inference_mode():
            return pred.model(torch.from_numpy(x).to(dev)).float().cpu() \
                .numpy()

    profiling.clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got_small, got_big = pred(small), pred(big)
        fetch = profiling.span_stats()["predictor.fetch"]
    finally:
        profiling.clear_spans()
    assert fetch["counts"] == {"pinned_rows": 16 + 65}
    for got in (got_small, got_big):
        assert torch.from_numpy(got).is_pinned()
        assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got_small, own(small))
    np.testing.assert_array_equal(
        got_big, np.concatenate([own(big[:64]), own(big[64:])]))
    assert not np.shares_memory(got_small, got_big)

    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})
    pred(small)
    before = stats().get("num_host_alloc")
    for _ in range(10):
        pred(small)
    assert stats().get("num_host_alloc") == before


# ---------------------------------------------------------------------------
# the scatter-add kernel and the train path
# ---------------------------------------------------------------------------

from pointnet2_tpu_torch.ops import grouping  # noqa: E402


def _scatter_inputs(rs, dev, B, K, n, C, dtype):
    g = torch.from_numpy(rs.randn(B, K, C).astype(np.float32)).to(dev, dtype)
    idx = rs.randint(0, n, (B, K)).astype(np.int32)
    idx[:, ::5] = 2  # a hot row
    idx[:, 1::17] = -3  # out of range: adds nothing
    idx[:, 2::19] = n + 4
    return g, torch.from_numpy(idx).to(dev)


def _check_scatter(got, g, idx, n):
    """Bit for bit the plain version on CPU copies of the same inputs:
    both add each row's terms in f32 in ascending k and round once."""
    same, err = scatter_same(torch, got, g, idx, n)
    assert got.dtype == g.dtype and same, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,n,C", [(2, 300, 64, 3), (2, 300, 64, 5),
                                     (2, 300, 64, 64), (3, 5000, 100, 128),
                                     (2, 16384, 1024, 64), (1, 40, 7, 200),
                                     (2, 8192, 512, 128),
                                     (2, 16384, 1024, 3)])
def test_scatter_kernel_matches_plain_and_is_deterministic(dev, rs, dtype, B,
                                                           K, n, C):
    """At small shapes and at the SA1 (n=1024, C=64 and the xyz C=3) and
    SA2 (n=512, C=128) backward's: bit for bit the CPU plain version, the
    kernel's CSR equal to the plain CSR, two launches bitwise equal."""
    g, idx = _scatter_inputs(rs, dev, B, K, n, C, dtype)
    before = ops.scatter_rows_kernel.launches
    got = ops.scatter_rows(g, idx, n)
    again, off, perm = ops.scatter_rows_kernel(g, idx, n, return_csr=True)
    assert ops.scatter_rows_kernel.launches == before + 2
    _check_scatter(got, g, idx, n)
    woff, wperm = grouping.scatter_csr_plain(idx.cpu(), n)
    assert torch.equal(off.cpu(), woff) and torch.equal(perm.cpu(), wperm)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), again.view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernel_more_clouds_than_one_grid_row(dev, rs, dtype):
    """B = 65537 clouds, past gridDim.y's 65535: two launches of each pass
    at their clouds' offsets, bit for bit the plain version, one count."""
    g, idx = _scatter_inputs(rs, dev, 65537, 8, 5, 3, dtype)
    before = ops.scatter_rows_kernel.launches
    got = ops.scatter_rows(g, idx, 5)
    assert ops.scatter_rows_kernel.launches == before + 1
    _check_scatter(got, g, idx, 5)


def test_scatter_kernel_edge_cases(dev):
    g = torch.ones(2, 0, 4, device=dev)
    idx = torch.zeros(2, 0, dtype=torch.int32, device=dev)
    out = ops.scatter_rows(g, idx, 6)
    assert out.shape == (2, 6, 4) and not out.any()
    _check_scatter(out, g, idx, 6)
    g = torch.ones(1, 3, 2, device=dev)
    idx = torch.tensor([[-1, 4, 9]], dtype=torch.int32, device=dev)
    out = ops.scatter_rows(g, idx, 4)
    assert not out.any()
    _check_scatter(out, g, idx, 4)
    hot = torch.full((1, 4096 * 3 + 5, 8), 0.5, device=dev)
    idx = torch.full((1, hot.shape[1]), 3, dtype=torch.int32, device=dev)
    out = ops.scatter_rows(hot, idx, 5)
    assert float(out[0, 3, 0]) == 0.5 * hot.shape[1]
    assert not out[0, :3].any() and not out[0, 4].any()
    _check_scatter(out, hot, idx, 5)
    zero = torch.zeros_like(idx[:, :100])  # n = 1: every index on row 0
    one = ops.scatter_rows(hot[:, :100], zero, 1)
    assert float(one[0, 0, 0]) == 50.0
    _check_scatter(one, hot[:, :100], zero, 1)
    with pytest.raises(TypeError):
        ops.scatter_rows_kernel(hot.double(), torch.zeros(
            1, hot.shape[1], dtype=torch.int32, device=dev), 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_grad_goes_through_the_scatter_kernel(dev, rs, dtype):
    pts = torch.from_numpy(rs.randn(2, 300, 64).astype(np.float32)).to(
        dev, dtype)
    idx = torch.from_numpy(rs.randint(0, 300, (2, 40, 16)).astype(
        np.int32)).to(dev)
    ct = torch.from_numpy(rs.randn(2, 40, 16, 64).astype(np.float32)).to(
        dev, dtype)
    x = pts.clone().requires_grad_()
    before = ops.scatter_rows_kernel.launches
    ops.group_point(x, idx).backward(ct)
    assert ops.scatter_rows_kernel.launches == before + 1
    assert x.grad is not None
    y = pts.clone().requires_grad_()
    with config.default_impl("torch"):
        ops.group_point(y, idx).backward(ct)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(x.grad.float(), y.grad.float(), rtol=tol,
                               atol=tol * float(y.grad.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_grad_first_occurrence_on_card(dev, rs, dtype):
    x = torch.from_numpy((rs.randint(-3, 4, (4, 64, 32, 16)) * 0.5).astype(
        np.float32)).to(dev, dtype).requires_grad_()
    out = ops.max_pool(x, 2)
    out.backward(torch.ones_like(out))
    xc = x.detach().cpu().float()
    first = xc.argmax(2, keepdim=True)  # CPU argmax: first occurrence
    want = torch.zeros_like(xc).scatter_(2, first, 1.0)
    torch.testing.assert_close(x.grad.cpu().float(), want, rtol=0, atol=0)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_kernels_vs_plain(dev, rs, dtype, tmp_path):
    """One train step at B=4, N=512 through the kernels and through the
    plain versions on the card, from the same weights, batch and generator
    seed. The forward is the same bits (exact gathers, identical indices),
    so loss and running statistics are equal; gradients differ by the
    scatter's summation order (atomic index_add_ in the plain path): each
    within 1e-4 (f32) or 1e-2 (bf16) of its norm."""
    from pointnet2_tpu_torch.train import TrainConfig, Trainer
    from pointnet2_tpu_torch.train.steps import run_one_step

    batch = {"points": torch.from_numpy(rs.rand(4, 512, 3).astype(
        np.float32)).to(dev),
        "label": torch.from_numpy(rs.randint(0, 40, 4)).to(dev),
        "mask": torch.ones(4, device=dev)}
    out = {}
    for impl in ("auto", "torch"):
        with Trainer(TrainConfig(log_dir=str(tmp_path / impl),
                                 compute_dtype=dtype,
                                 augment="cls"), device=dev) as tr:
            state = tr.init_state()
            tr.generator.manual_seed(5)
            with config.default_impl(impl):
                m = run_one_step(state, batch, tr.loss_fn, tr.bn_schedule,
                                 tr.augment_fn, tr.generator)
            model = state.model
            out[impl] = (float(m["loss"]),
                         {k: p.grad.clone() for k, p in
                          model.named_parameters()},
                         {k: b.clone() for k, b in model.named_buffers()})
    (la, ga, ba), (lb, gb, bb) = out["auto"], out["torch"]
    assert la == lb
    for k in ba:
        torch.testing.assert_close(ba[k], bb[k], rtol=0, atol=0, msg=k)
    tol = 1e-4 if dtype == "float32" else 1e-2
    for k in ga:
        if _bn_fed_bias(k):
            continue
        assert _rel(ga[k], gb[k]) <= tol, (k, _rel(ga[k], gb[k]))


@pytest.mark.parametrize("name,n", [("pointnet2_sem_seg", 2048),
                                    ("pointnet2_part_seg", 1024),
                                    ("pointnet2_part_seg_msg_one_hot", 1024)])
def test_seg_train_step_kernels_vs_plain(dev, name, n, tmp_path):
    """One f32 train step of a segmentation model at B=4 through the
    kernels and through the plain versions on the card, from the same
    weights, batch (chip_smoke's data: a ScanNet crop with its wdp-zeroed
    weights and the z rotation, or part clouds with normals and category
    labels, cut to n points) and generator seed: loss and running
    statistics equal (the forward is the same bits), each gradient within
    1e-4 of its scale (chip_smoke.grad_differences, the biases whose
    exact gradient is zero by chip_smoke.exact_zero_biases: the scatter's
    summation order)."""
    from chip_smoke import (
        SEG_TRAIN,
        exact_zero_biases,
        grad_differences,
        seg_datasets,
    )
    from pointnet2_tpu_torch.train import TrainConfig, Trainer
    from pointnet2_tpu_torch.train.steps import run_one_step

    host = next(seg_datasets(name)[0].epoch())
    host = {k: v[:4, :n] if k in ("points", "seg", "smpw") else
            (v[:4] if k == "cls_label" else min(v, 4))
            for k, v in host.items()}
    assert name != "pointnet2_sem_seg" or (host["smpw"] == 0).any()
    out = {}
    for impl in ("auto", "torch"):
        cfg = TrainConfig(model=name, batch_size=4, num_point=n,
                          augment=SEG_TRAIN[name]["augment"],
                          log_dir=str(tmp_path / impl))
        with Trainer(cfg, device=dev) as tr:
            state = tr.init_state()
            tr.generator.manual_seed(5)
            before = ops.scatter_rows_kernel.launches
            with config.default_impl(impl):
                m = run_one_step(state, tr._to_device(host), tr.loss_fn,
                                 tr.bn_schedule, tr.augment_fn, tr.generator,
                                 tr.task)
            launched = ops.scatter_rows_kernel.launches - before
            assert (launched > 0) == (impl == "auto")
            model = state.model
            out[impl] = (float(m["loss"]),
                         {k: p.grad.clone() for k, p in
                          model.named_parameters()},
                         {k: b.clone() for k, b in model.named_buffers()})
    (la, ga, ba), (lb, gb, bb) = out["auto"], out["torch"]
    assert la == lb and np.isfinite(la)
    for k in ba:
        torch.testing.assert_close(ba[k], bb[k], rtol=0, atol=0, msg=k)
    diffs = grad_differences(torch, ga, gb, exact_zero_biases(model))
    assert len(diffs) == len(ga) > 40
    assert diffs[0][0] <= 1e-4, diffs[:3]



def test_virtual_scan_train_step_kernels_vs_plain(dev, tmp_path):
    """One bf16 sem_seg train step at B=4 on a virtual-scan batch (two
    generated rooms, 2048 points a view, the wdp input dropout) through
    the kernels and through the plain versions on the card: loss and
    running statistics equal, gradients within chip_smoke's bf16 limits
    (SEG_STEP_TOL: 0.5 of a tensor's scale, the median 2e-2), and every
    scatter of the step bit for bit its plain version on CPU copies."""
    from chip_smoke import (
        SEG_STEP_TOL,
        capture_scatters,
        exact_zero_biases,
        grad_differences,
    )
    from pointnet2_tpu_torch.data import ScannetDatasetVirtualScan
    from pointnet2_tpu_torch.data.procedural_scannet import generate_scenes
    from pointnet2_tpu_torch.train import TrainConfig, Trainer
    from pointnet2_tpu_torch.train.steps import run_one_step

    rooms = generate_scenes(2, seed=3, min_points=20000, max_points=30000)
    views = ScannetDatasetVirtualScan(scenes=rooms, npoints=2048,
                                      batch_size=4)
    host = next(views.epoch())
    assert host["nvalid"] == 4 and (host["smpw"] == 0).any()
    cfg = TrainConfig(model="pointnet2_sem_seg", batch_size=4,
                      num_point=2048, augment="scannet",
                      compute_dtype="bfloat16", log_dir=str(tmp_path))
    out = {}
    with Trainer(cfg, device=dev) as tr:
        batch = tr._to_device(host)
        for impl in ("auto", "torch"):
            state = tr.init_state()
            tr.generator.manual_seed(5)
            with capture_scatters() as calls, config.default_impl(impl):
                m = run_one_step(state, batch, tr.loss_fn, tr.bn_schedule,
                                 tr.augment_fn, tr.generator, tr.task)
            model = state.model
            out[impl] = (float(m["loss"]),
                         {k: p.grad.clone() for k, p in
                          model.named_parameters()},
                         {k: b.clone() for k, b in model.named_buffers()},
                         list(calls))
    (la, ga, ba, calls), (lb, gb, bb, plain_calls) = (out["auto"],
                                                     out["torch"])
    assert la == lb and np.isfinite(la)
    assert len(calls) > 0 and not plain_calls
    for g, idx, got in calls:
        ok, err = scatter_same(torch, got, g, idx, got.shape[1])
        assert ok, err
    for k in ba:
        torch.testing.assert_close(ba[k], bb[k], rtol=0, atol=0, msg=k)
    tol, median_tol = SEG_STEP_TOL["bfloat16"]
    diffs = grad_differences(torch, ga, gb, exact_zero_biases(model))
    assert diffs[0][0] <= tol, diffs[:3]
    assert float(np.median([d for d, _ in diffs])) <= median_tol


@pytest.mark.parametrize("dtype,name", [(torch.float32, "f32"),
                                        (torch.bfloat16, "bf16")])
def test_fused_sem_seg_layers_kernels_vs_plain(dev, dtype, name):
    """sem_seg's four SA layers in train mode with the gate on, on a
    ScanNet crop (chip_smoke's data) cut to B=2 and 2048 points, through
    the kernels and through the plain versions on the same inputs and
    cotangents (`chip_smoke.fused_layer_errs`): the chain's backward
    kernels launched for each layer; outputs, gradients and running
    statistics within `chip_smoke.LAYER_LIMITS`."""
    from chip_smoke import SEM, seg_datasets

    config.disable_tf32()
    host = next(seg_datasets(SEM)[0].epoch())["points"][:2, :2048, :3]
    xyz = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
    before = {k: ops.KERNELS[k].launches for k in BWD}
    errs = fused_layer_errs(torch, dev, dtype, xyz, SEM,
                            ("sa1", "sa2", "sa3", "sa4"))
    assert {k: ops.KERNELS[k].launches - before[k] for k in BWD} == {
        "fused_top_stats": 4, "fused_dense_bwd": 8, "fused_first_bwd": 4}
    assert all(errs[k] <= LAYER_LIMITS[name][k] for k in errs), errs

def test_three_interpolate_backward_through_the_scatter_at_fp4(dev, rs):
    """sem_seg FP4's shape (8192 unknown points from 1024 known, 128
    channels) at B=2: the gradient into the known points is one scatter
    launch, bit for bit the plain scatter on CPU copies of the same
    cotangent rows and indices; the gradient into the weights equals the
    plain path's on the card."""
    B, n, m, C = 2, 8192, 1024, 128
    unknown = torch.from_numpy(rs.rand(B, n, 3).astype(np.float32)).to(dev)
    known = unknown[:, torch.from_numpy(rs.choice(n, m, replace=False)).to(
        dev)].contiguous()
    dist, idx = ops.three_nn(unknown, known)
    w = 1.0 / (dist + 1e-8)
    w = (w / w.sum(-1, keepdim=True)).requires_grad_()
    pts = torch.from_numpy(rs.randn(B, m, C).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rs.randn(B, n, C).astype(np.float32)).to(dev)
    x = pts.clone().requires_grad_()
    before = (ops.scatter_rows_kernel.launches,
              ops.gather_rows_kernel.launches)
    ops.three_interpolate(x, idx, w).backward(ct)
    assert (ops.scatter_rows_kernel.launches,
            ops.gather_rows_kernel.launches) == (before[0] + 1,
                                                 before[1] + 1)
    # the cotangent of the gathered rows: ct * w[..., k] for slot k
    rows_ct = (ct[:, :, None, :] * w.detach()[..., None]).reshape(B, 3 * n,
                                                                  C)
    same, err = scatter_same(torch, x.grad, rows_ct, idx.reshape(B, 3 * n), m)
    assert same, err
    y = pts.clone().requires_grad_()
    v = w.detach().clone().requires_grad_()
    with config.default_impl("torch"):
        ops.three_interpolate(y, idx, v).backward(ct)
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-5,
                               atol=1e-5 * float(y.grad.abs().max()))
    torch.testing.assert_close(w.grad, v.grad, rtol=0, atol=0)


def _bn_fed_bias(name: str) -> bool:
    """A dense bias that feeds a train-mode BN: BN subtracts the batch mean,
    so its gradient is zero in exact arithmetic and what either side
    computes is the rounding residue of cancelling sums, not compared."""
    return name.endswith("dense.bias") and not name.startswith("fc3.")


def test_trainer_on_card_takes_steps(dev, tmp_path):
    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    ds = SyntheticClassification(num_classes=4, samples_per_class=4,
                                 npoints=256, batch_size=8)
    before = ops.scatter_rows_kernel.launches
    with Trainer(TrainConfig(batch_size=8, augment="cls",
                             log_dir=str(tmp_path))) as tr:
        state = tr.fit(ds, eval_dataset=ds, max_epoch=2)
    assert state.step == 4
    assert ops.scatter_rows_kernel.launches == before + 2 * state.step
    assert all(p.device.type == "cuda" for p in state.model.parameters())


# ---------------------------------------------------------------------------
# three-NN and the segmentation path
# ---------------------------------------------------------------------------


def _three_nn_bitwise(xyz1, xyz2):
    before = ops.three_nn_kernel.launches
    dist, idx = ops.three_nn(xyz1, xyz2)
    assert ops.three_nn_kernel.launches == before + 1
    wdist, widx = _plain(ops.three_nn, xyz1, xyz2)
    assert torch.equal(idx, widx)
    assert torch.equal(dist.view(torch.int32), wdist.view(torch.int32))
    return dist, idx


@pytest.mark.parametrize("B,N,M", [(2, 1024, 256), (3, 100, 17),
                                   (2, 1000, 1), (2, 257, 2), (1, 300, 3),
                                   (2, 300, 5000), (1, 8192, 1024),
                                   (16, 64, 16), (16, 256, 64),
                                   (16, 1024, 256), (2, 4 * 256 + 5, 64),
                                   (2, 300, 1023), (2, 300, 1024),
                                   (2, 300, 1025), (1, 37, 1), (1, 37, 2),
                                   (9, 8191, 100), (2, 300, 64),
                                   (2, 300, 65), (16, 4096, 64)])
def test_three_nn_kernel_bit_identical(dev, rs, B, N, M):
    """Random clouds; M = 1, 2, 3; M past one shared-memory tile (1024)
    and at its edges; N not a multiple of a block's unknown points, with
    one (B*N under 65536) and two (9 x 8191, 16 x 4096) a thread; sem_seg
    FP1-FP3's shapes at B=16; M = 1 and 2 at few unknown points; and M at
    the edge of the direct walk (kDirect = 64 known points, each inserted
    without a bit), with one and two unknown points a thread."""
    xyz1 = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32)).to(dev)
    xyz2 = torch.from_numpy(rs.rand(B, M, 3).astype(np.float32)).to(dev)
    dist, idx = _three_nn_bitwise(xyz1, xyz2)
    if M < 3:
        assert torch.isinf(dist[..., M:]).all() and not idx[..., M:].any()


def test_three_nn_kernel_ties(dev, rs):
    """Exact ties: integer grids, the known set repeated three times, and
    unknown points that are known points (distance 0); and a known set
    repeated at a stride of 13 (260 points, the walk with bits) and of 7
    (63 points, the direct walk), at one and two unknown points a thread,
    so that the equal distances of an unknown point's nearest copies, at
    j, j + 13, j + 26, fall in one batch of 32 known points and in two."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1)
    grid = torch.from_numpy(g.reshape(1, 64, 3).astype(np.float32)).to(dev)
    _three_nn_bitwise(grid[:, ::3] + 0.5, grid)
    known = torch.from_numpy(rs.rand(2, 7, 3).astype(np.float32)).to(dev)
    _three_nn_bitwise(torch.from_numpy(rs.rand(2, 90, 3).astype(
        np.float32)).to(dev), known.repeat(1, 3, 1).contiguous())
    xyz = torch.from_numpy(rs.rand(2, 2000, 3).astype(np.float32)).to(dev)
    dist, _ = _three_nn_bitwise(xyz, xyz[:, 500:1700].contiguous())
    assert not dist[:, 500:1700, 0].any()
    for stride, copies in ((13, 20), (7, 9)):
        known = torch.from_numpy(rs.rand(16, stride, 3).astype(
            np.float32)).to(dev).repeat(1, copies, 1).contiguous()
        for n in (96, 4096):  # 1536 and 65536 unknown points
            dist, idx = _three_nn_bitwise(torch.from_numpy(rs.rand(
                16, n, 3).astype(np.float32)).to(dev), known)
            assert torch.equal(dist[..., 0], dist[..., 2])
            assert torch.equal(idx[..., 2] - idx[..., 0],
                               torch.full_like(idx[..., 0], 2 * stride))
            if stride == 13:
                assert (idx[..., 0] // 32 != idx[..., 2] // 32).any()


def test_three_nn_kernel_either_unknown_points_a_thread(dev, rs):
    """The launch with one and with two unknown points a thread, whichever
    the shape would take, gives the same bits; another count is refused."""
    import ctypes

    from pointnet2_tpu_torch.ops import _build, interpolate

    fn = _build.bind("three_nn", "pn2_three_nn_q",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    for B, N, M in ((2, 300, 100), (2, 300, 40), (4, 16384, 300)):
        xyz1 = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32)).to(dev)
        xyz2 = torch.from_numpy(rs.rand(B, M, 3).astype(np.float32)).to(dev)
        wd, wi = interpolate.three_nn_plain(xyz1, xyz2)
        for q in (1, 2):
            dist = torch.empty_like(wd)
            idx = torch.empty_like(wi)
            assert fn(xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(),
                      idx.data_ptr(), B, N, M, q, stream) == 0
            assert torch.equal(idx, wi)
            assert torch.equal(dist.view(torch.int32), wd.view(torch.int32))
        assert fn(xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(),
                  idx.data_ptr(), B, N, M, 3, stream) != 0


@pytest.mark.parametrize("centre", [1000.0, -1e5, 3e18])
def test_three_nn_kernel_far_from_the_origin(dev, rs, centre):
    """Clouds far from the origin: the known points' bits (|p|^2 - 2q.p
    against the third best, margin 2^-18 (|p|^2 + |q|^2)) let many more
    points through to the exact test, and past 2^120 every point; the bits
    stay those of the plain version."""
    xyz1 = torch.from_numpy((centre + rs.rand(2, 2000, 3)).astype(
        np.float32)).to(dev)
    xyz2 = torch.from_numpy((centre + rs.rand(2, 500, 3)).astype(
        np.float32)).to(dev)
    _three_nn_bitwise(xyz1, xyz2)


def test_three_nn_kernel_more_clouds_than_one_grid_row(dev, rs):
    """B = 65537 clouds, past gridDim.y's 65535: two launches at their
    clouds' offsets, bit for bit the plain version, one count."""
    xyz1 = torch.from_numpy(rs.rand(65537, 4, 3).astype(np.float32)).to(dev)
    xyz2 = torch.from_numpy(rs.rand(65537, 5, 3).astype(np.float32)).to(dev)
    _three_nn_bitwise(xyz1, xyz2)


def test_three_nn_kernel_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError, match="M >= 1"):
        ops.three_nn_kernel(torch.zeros(1, 4, 3, device=dev),
                            torch.zeros(1, 0, 3, device=dev))
    with pytest.raises(TypeError):
        ops.three_nn_kernel(torch.zeros(1, 4, 3, device=dev).double(),
                            torch.zeros(1, 4, 3, device=dev))
    dist, idx = ops.three_nn_kernel(torch.zeros(2, 0, 3, device=dev),
                                    torch.zeros(2, 5, 3, device=dev))
    assert dist.shape == idx.shape == (2, 0, 3)


@pytest.mark.parametrize("name,channels", [("pointnet2_sem_seg", 3),
                                           ("pointnet2_part_seg", 6)])
def test_seg_predictor_kernel_path_equals_plain_path(dev, rs, name,
                                                     channels):
    """f32 seg logits on the card through the kernels and through the plain
    versions: identical indices and exact gathers give every later op the
    same inputs; bound 1e-5 of the logits' range for a cuBLAS algorithm
    choice that might differ. The kernel path launches three_nn once per
    FP."""
    pts = rs.rand(3, 1024, channels).astype(np.float32)
    pred = Predictor(name, dtype=None, buckets=(4,))
    before = ops.three_nn_kernel.launches
    got = pred(pts)
    n_fp = 4 if name == "pointnet2_sem_seg" else 3
    assert ops.three_nn_kernel.launches == before + n_fp
    with config.default_impl("torch"):
        want = pred(pts)
    assert got.shape == (3, 1024, pred.model.num_classes)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# ball query with grouped xyz, multi-radius ball query, the MSG path
# ---------------------------------------------------------------------------


def _cloud_and_queries(rs, dev, B, N, M):
    xyz1 = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32)).to(dev)
    pick = torch.from_numpy(rs.randint(0, N, M)).to(dev)
    xyz2 = (xyz1[:, pick] + 0.01).contiguous()
    return xyz1, xyz2


@pytest.mark.parametrize("B,N,M,radius,nsample",
                         [(2, 1024, 512, 0.2, 32), (2, 512, 128, 0.8, 128),
                          (3, 100, 17, 0.2, 8), (2, 20, 8, 0.5, 32),
                          (1, 300, 40, 2.0, 64), (2, 64, 300000, 0.3, 4)])
def test_ball_query_group_xyz_kernel_matches_plain(dev, rs, B, N, M, radius,
                                                   nsample):
    """idx and cnt bit-identical to the plain version and to the ball query
    kernel, grouped equal by value to xyz1[idx]. Cases: nsample > N, M not
    a multiple of the block (8), and B*M = 600000 queries (75000 blocks,
    past one 65535-block grid row)."""
    xyz1, xyz2 = _cloud_and_queries(rs, dev, B, N, M)
    before = ops.ball_query_group_xyz_kernel.launches
    idx, cnt, grouped = ops.query_ball_and_group_xyz(radius, nsample, xyz1,
                                                     xyz2)
    assert ops.ball_query_group_xyz_kernel.launches == before + 1
    widx, wcnt, wgrp = _plain(ops.query_ball_and_group_xyz, radius, nsample,
                              xyz1, xyz2)
    sidx, scnt = ops.query_ball_point(radius, nsample, xyz1, xyz2)
    assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)
    assert torch.equal(idx, sidx) and torch.equal(cnt, scnt)
    assert torch.equal(grouped, wgrp)
    rows = torch.arange(B, device=dev)[:, None, None]
    assert torch.equal(grouped, xyz1[rows, idx.long()])


def test_ball_query_group_xyz_kernel_empty_ball_and_signed_zero(dev):
    """An empty ball: index 0 and point 0's coordinates in every slot; a
    -0.0 coordinate is copied as -0.0."""
    xyz = torch.tensor([[[5.0, 5.0, 5.0], [-0.0, 0.0, -0.0], [6.0, 6.0, 6.0],
                         [0.01, 0.0, 0.0]]], device=dev)
    q = torch.tensor([[[0.0, 0.0, 0.0], [-3.0, -3.0, -3.0]]], device=dev)
    idx, cnt, grouped = ops.query_ball_and_group_xyz(0.1, 4, xyz, q)
    assert idx.tolist() == [[[1, 3, 1, 1], [0, 0, 0, 0]]]
    assert cnt.tolist() == [[2, 0]]
    assert grouped[0, 1].tolist() == [[5.0, 5.0, 5.0]] * 4
    assert torch.signbit(grouped[0, 0, 0, 0]) and torch.signbit(
        grouped[0, 0, 2, 2])


def _shifted(t, offset: int):
    """t copied `offset` elements into fresh storage of its dtype."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N", [TILE - 1, TILE, TILE + 1, 2 * TILE + 1])
def test_ball_query_group_xyz_kernel_tiles(dev, rs, N, offset):
    """Around and past the staged tile (kTile points): idx and cnt bit for
    bit the plain ball query, grouped bit for bit xyz1[idx] and the plain
    version. N % 4 != 0 or xyz1 one float into its storage takes the
    4-byte cp.async route; -0.0 coordinates are copied as -0.0; the last
    query's ball is empty; an all-hit radius and nsample > N."""
    B, M = 2, 40
    x = rs.rand(B, N, 3).astype(np.float32)
    x[:, ::7, 0] = -0.0
    x[:, 3::11, 2] = -0.0
    xyz1 = _shifted(torch.from_numpy(x).to(dev), offset)
    assert xyz1.storage_offset() == offset
    pick = torch.from_numpy(rs.randint(0, N, M)).to(dev)
    xyz2 = (xyz1[:, pick] + 0.01).contiguous()
    xyz2[:, -1] = -3.0
    rows = torch.arange(B, device=dev)[:, None, None]
    for radius, nsample in ((0.15, 64), (0.5, 32), (2.0, N + 5)):
        before = ops.ball_query_group_xyz_kernel.launches
        idx, cnt, grouped = ops.query_ball_and_group_xyz(radius, nsample,
                                                         xyz1, xyz2)
        assert ops.ball_query_group_xyz_kernel.launches == before + 1
        widx, wcnt, wgrp = _plain(ops.query_ball_and_group_xyz, radius,
                                  nsample, xyz1, xyz2)
        assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)
        assert torch.equal(_bits(grouped), _bits(wgrp))
        assert torch.equal(_bits(grouped), _bits(xyz1[rows, idx.long()]))
        assert not cnt[:, -1].any() and not idx[:, -1].any()
        assert torch.signbit(grouped).any()


def test_ball_query_group_xyz_grad_goes_through_the_scatter_kernel(dev, rs):
    xyz1, xyz2 = _cloud_and_queries(rs, dev, 2, 512, 128)
    ct = torch.from_numpy(rs.randn(2, 128, 32, 3).astype(np.float32)).to(dev)
    x = xyz1.clone().requires_grad_()
    before = (ops.scatter_rows_kernel.launches,
              ops.ball_query_group_xyz_kernel.launches)
    ops.query_ball_and_group_xyz(0.2, 32, x, xyz2)[2].backward(ct)
    assert (ops.scatter_rows_kernel.launches,
            ops.ball_query_group_xyz_kernel.launches) == (before[0] + 1,
                                                          before[1] + 1)
    y = xyz1.clone().requires_grad_()
    with config.default_impl("torch"):
        ops.query_ball_and_group_xyz(0.2, 32, y, xyz2)[2].backward(ct)
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-5,
                               atol=1e-5 * float(y.grad.abs().max()))


@pytest.mark.parametrize("B,N,M,radii,nsamples,offset", [
    (2, 1024, 512, (0.1, 0.2, 0.4), (16, 32, 128), 0),
    (2, 512, 128, (0.8, 0.2, 0.4), (128, 32, 64), 0),  # unsorted
    (3, 100, 17, (0.3, 0.3), (8, 16), 0),  # repeated
    (2, 20, 9, (0.5,), (32,), 0),  # a single radius, nsample > N
    (1, 40, 8, (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8), (4,) * 8, 0),
    (2, 64, 300000, (0.2, 0.4), (4, 8), 0),  # past one grid row
    (2, TILE + 1, 37, (0.1, 0.2, 0.4), (16, 32, 128), 0),  # past one tile
    (1, 2 * TILE + 1, 20, (0.4, 0.05), (64, 8), 0),  # three tiles
    (2, 1023, 41, (0.2, 0.1, 0.8), (32, 16, 2000), 0),  # N % 4, ns > N
    (2, 2048, 40, (0.1, 0.2, 0.4), (16, 32, 128), 1),  # one float in
    (1, 2 * TILE - 1, 19, (0.3, 0.15, 0.6, 0.05), (8, 4, 64, 2), 1),
])
def test_ball_query_multi_kernel_matches_per_radius(dev, rs, B, N, M, radii,
                                                    nsamples, offset):
    """Each radius bit-identical to the ball query kernel at that radius
    and to the plain version; one launch for all. The last query's ball
    is empty at every radius below 2, so its block walks every tile; at
    offset 1 the cloud starts one float into its storage (4-byte
    staging)."""
    xyz1, xyz2 = _cloud_and_queries(rs, dev, B, N, M)
    xyz1 = _shifted(xyz1, offset)
    assert xyz1.storage_offset() == offset
    xyz2[:, -1] = -3.0
    before = ops.ball_query_multi_kernel.launches
    got = ops.query_ball_point_multi(radii, nsamples, xyz1, xyz2)
    assert ops.ball_query_multi_kernel.launches == before + 1
    want = _plain(ops.query_ball_point_multi, radii, nsamples, xyz1, xyz2)
    for (idx, cnt), (widx, wcnt), r, ns in zip(got, want, radii, nsamples):
        sidx, scnt = ops.query_ball_point(r, ns, xyz1, xyz2)
        assert torch.equal(idx, sidx) and torch.equal(cnt, scnt)
        assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)
        assert not cnt[:, -1].any() and not idx[:, -1].any()


def test_ball_query_multi_kernel_refuses_what_it_does_not_take(dev):
    xyz = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="radii"):
        ops.KERNELS["ball_query_multi"]((0.1,) * 9, (4,) * 9, xyz, xyz)
    with pytest.raises(ValueError, match="radii"):
        ops.KERNELS["ball_query_multi"]((0.1, 0.2), (4,), xyz, xyz)
    with pytest.raises(ValueError, match="nsample"):
        ops.KERNELS["ball_query_multi"]((0.1,), (0,), xyz, xyz)
    outs = ops.KERNELS["ball_query_multi"]((0.1,), (4,), xyz,
                                           torch.zeros(1, 0, 3, device=dev))
    assert outs[0][0].shape == (1, 0, 4)


@pytest.mark.parametrize("name,channels,label",
                         [("pointnet2_cls_msg", 3, False),
                          ("pointnet2_part_seg_msg_one_hot", 6, True),
                          ("pointnet_cls_basic", 3, False)])
def test_msg_predictor_kernel_path_equals_plain_path(dev, rs, name, channels,
                                                     label):
    """f32 logits through the kernels and through the plain versions on the
    card: identical indices and exact gathers (bound 1e-5 of the range for
    a cuBLAS algorithm choice that might differ)."""
    pts = rs.rand(3, 1024, channels).astype(np.float32)
    args = (pts, rs.randint(0, 16, 3)) if label else (pts,)
    pred = Predictor(name, dtype=None, buckets=(4,))
    got = pred(*args)
    with config.default_impl("torch"):
        want = pred(*args)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_unfused_msg_layer_launches_grouped_xyz_kernel(dev, rs):
    """SetAbstractionMSG(fuse_first=False) launches the ball query with
    grouped xyz once per radius and matches the fused layer on the same
    weights (f32, rtol 1e-4 / atol 3e-5 as the JAX test)."""
    from pointnet2_tpu_torch.nn import SetAbstractionMSG

    xyz = torch.from_numpy(rs.rand(2, 1024, 3).astype(np.float32)).to(dev)
    args = (512, (0.1, 0.2, 0.4), (16, 32, 128), 0,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
    fused = SetAbstractionMSG(*args).to(dev).eval()
    plain = SetAbstractionMSG(*args, fuse_first=False).to(dev).eval()
    plain.load_state_dict(fused.state_dict())
    before = ops.ball_query_group_xyz_kernel.launches
    with torch.inference_mode():
        _, want = fused(xyz, None)
        _, got = plain(xyz, None)
    assert ops.ball_query_group_xyz_kernel.launches == before + 3
    torch.testing.assert_close(got, want, rtol=1e-4, atol=3e-5)


# --- the fused SA chain (csrc/fused_mlp.cu) ---------------------------------


def _dense_inputs(rs, dev, R, cin, cout, dtype):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return (t(rs.randn(R, cin)).to(dtype), t(rs.uniform(-1.5, 1.5, cin)),
            t(0.1 * rs.randn(cin)), t(rs.randn(cout, cin) / np.sqrt(cin)),
            t(0.1 * rs.randn(cout)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,cin,cout", [(2 * 512 * 32, 64, 128),
                                        (1000, 196, 40), (77, 3, 3),
                                        (2 * 512 * 128, 96, 128),
                                        (333, 24, 131)])
def test_fused_dense_kernel_matches_plain(dev, rs, dtype, R, cin, cout):
    """y: f32 within 1e-5 of max|y| of plain (summation order), bf16 within
    one bf16 ulp of the exact product of its rounded operands plus the f32
    accumulation bound (`chip_smoke.y_ok`); the column statistics against
    the exact sums of the same rounded y (`sum_ok`), and bit for bit across
    two launches. cls_msg's fused denses take Cin 32, 64, 96 and 128:
    (2*512*128, 96, 128) is SA1's third scale at B=2, whose Cin ends half
    way through a 32-deep chunk; Cin 196, 24 and 3 are no multiple of 16
    (k past Cin stages as z = 0 and W = 0), Cout 131 and 3 no multiple of
    the 64-column tile."""
    from pointnet2_tpu_torch.ops import fused_mlp

    args = _dense_inputs(rs, dev, R, cin, cout, dtype)
    before = ops.fused_dense_kernel.launches
    y, s, ss = fused_mlp.dense_fwd(*args, want_stats=True)
    _, s2, ss2 = fused_mlp.dense_fwd(*args, want_stats=True)
    assert ops.fused_dense_kernel.launches == before + 2
    wy, _, _ = fused_mlp.dense_fwd_plain(*args)
    y1, y2 = y.double(), (y.float() * y.float()).double()
    assert y.dtype == dtype and y.shape == (R, cout)
    d = (y.float() - wy.float()).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * float(wy.abs().max())
    else:
        assert y_ok(torch, y, *args)
    assert sum_ok(s, y1.sum(0), y1.abs().sum(0))
    assert sum_ok(ss, y2.sum(0), y2.sum(0))
    assert torch.equal(s, s2) and torch.equal(ss, ss2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,C", [(2 * 512, 32, 128), (1000, 7, 40),
                                   (3, 1, 3)])
def test_fused_pool_and_affine_kernels_bitwise(dev, rs, dtype, G, S, C):
    from pointnet2_tpu_torch.ops import fused_mlp

    y = torch.from_numpy(rs.randn(G, S, C).astype(np.float32)).to(dev, dtype)
    a = torch.from_numpy(rs.randn(C).astype(np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rs.randn(C).astype(np.float32)).to(dev)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    before = (ops.fused_pool_kernel.launches,
              ops.fused_affine_kernel.launches)
    got = fused_mlp.pool_fwd(y, a, b)
    aff = fused_mlp.affine_fwd(y.reshape(-1, C), a, b)
    assert (ops.fused_pool_kernel.launches,
            ops.fused_affine_kernel.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert torch.equal(got.view(view),
                       fused_mlp.pool_fwd_plain(y, a, b).view(view))
    assert torch.equal(aff.view(view), fused_mlp.affine_fwd_plain(
        y.reshape(-1, C), a, b).view(view))


def _one_stride(C: int, isz: int) -> int:
    """Rows the launch of rows 12 and 15 takes in one pass of its grid."""
    tx = min(-(-C * isz // 16), FIRST["kFirstThreads"])
    return (FIRST["kFirstBlocks"] * (FIRST["kFirstThreads"] // tx)
            * FIRST["kFirstRows"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("R,C", [(1000, 1), (1000, 3), (777, 40),
                                 (1001, 131), (513, 256)])
def test_fused_affine_kernel_bitwise(dev, rs, dtype, offset, R, C):
    """Row 12 bit for bit affine_fwd_plain: C a multiple of the 16-byte
    vector or not, y at storage offset 0 or 1 (element by element), with
    +-inf, NaN, and zero scales (inf * 0 gives NaN) from C = 2 on."""
    from pointnet2_tpu_torch.ops import fused_mlp

    y = rs.randn(R, C).astype(np.float32)
    y.flat[::97] = np.inf
    y.flat[1::97] = -np.inf
    y.flat[2::89] = np.nan
    a = rs.randn(C).astype(np.float32)
    a[1::5] = 0.0
    y = _shifted(torch.from_numpy(y).to(dev, dtype), offset)
    a = torch.from_numpy(a).to(dev)
    b = torch.from_numpy(0.1 * rs.randn(C).astype(np.float32)).to(dev)
    before = ops.fused_affine_kernel.launches
    got = fused_mlp.affine_fwd(y, a, b)
    assert ops.fused_affine_kernel.launches == before + 1
    want = fused_mlp.affine_fwd_plain(y, a, b)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 256])
def test_fused_affine_kernel_past_one_grid_stride(dev, dtype, C):
    """More rows than kFirstBlocks row blocks take in one pass: the grid
    strides; bit for bit affine_fwd_plain."""
    from pointnet2_tpu_torch.ops import fused_mlp

    R = _one_stride(C, torch.empty((), dtype=dtype).element_size()) + 777
    g = torch.Generator(device=dev).manual_seed(12)
    y = torch.randn((R, C), generator=g, device=dev).to(dtype)
    a = torch.randn(C, generator=g, device=dev)
    b = 0.1 * torch.randn(C, generator=g, device=dev)
    got = fused_mlp.affine_fwd(y, a, b)
    assert torch.equal(_bits(got), _bits(fused_mlp.affine_fwd_plain(y, a, b)))


def test_fused_kernels_refuse_what_they_do_not_take(dev, rs):
    x, a, b, w, bias = _dense_inputs(rs, dev, 64, 8, 4, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_dense_kernel(x.cpu(), a, b, w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_dense_kernel(x.t().contiguous().t(), a, b, w, bias)
    with pytest.raises(TypeError):
        ops.fused_dense_kernel(x.double(), a, b, w, bias)
    with pytest.raises(ValueError):
        ops.fused_dense_kernel(x, a, b, w.t().contiguous(), bias)
    y = x.reshape(4, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_pool_kernel(y.cpu(), a.cpu(), b.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_pool_kernel(y.transpose(0, 1), a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_affine_kernel(x.cpu(), a, b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_affine_kernel(x[:, ::2], a[:4], b[:4])
    assert ops.fused_dense_kernel(x[:0], a, b, w, bias)[0].shape == (0, 4)


def test_predictor_fused_route_matches_plain(dev, rs):
    """One Predictor forward with the gate on through the kernels and
    through the plain versions on the card (f32, bound 1e-4 of the range:
    the kernel and cuBLAS sum in other orders), and against the unfused
    route."""
    pts = rs.rand(3, 1024, 3).astype(np.float32)
    pred = Predictor("pointnet2_cls_ssg", dtype=None, buckets=(4,))
    unfused = pred(pts)
    before = {k: ops.KERNELS[k].launches for k in ("fused_dense",
                                                   "fused_pool")}
    with config.fused_mlp(True):
        got = pred(pts)
        assert {k: ops.KERNELS[k].launches - before[k] for k in before} == {
            "fused_dense": 4, "fused_pool": 2}
        with config.default_impl("torch"):
            want = pred(pts)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - unfused).max() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# the fused chain's backward (rows 13-15) and its train mode
# ---------------------------------------------------------------------------


def _pack_on(rs, dev, c, m=True):
    from pointnet2_tpu_torch.ops import fused_mlp

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ms = (t(0.1 * rs.randn(c)), t(0.1 * rs.randn(c))) if m else (None, None)
    return fused_mlp.bn_pack(t(rs.uniform(-1.5, 1.5, c)), t(0.1 * rs.randn(c)),
                             t(0.3 * rs.randn(c)), t(rs.uniform(0.3, 2, c)),
                             1e-3, *ms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("G,S,C", [(2 * 512, 32, 128), (1000, 7, 40),
                                   (3, 1, 3),
                                   (2048, 64, 256),  # cls_ssg SA2 at B=16
                                   (2 * 512, 128, 128),  # cls_msg SA1 r=0.4
                                   (333, 5, 131)])
def test_fused_top_stats_kernel_matches_plain(dev, rs, dtype, pool, G, S, C):
    """Also on copies of y and g that start one element into their storage
    (not on a 16-byte boundary: the kernel loads them element by element),
    which must give the same bits: the summation order is the shape's."""
    from pointnet2_tpu_torch.ops import fused_mlp

    shape = (G, S, C) if pool else (G * S, C)
    y = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rs.randn(G if pool else G * S, C).astype(
        np.float32)).to(dev, dtype)
    p = _pack_on(rs, dev, C, m=False)
    before = ops.fused_top_stats_kernel.launches
    t1, t2 = fused_mlp.top_stats(y, g, p, pool)
    u1, u2 = fused_mlp.top_stats(y, g, p, pool)
    assert ops.fused_top_stats_kernel.launches == before + 2
    assert torch.equal(t1, u1) and torch.equal(t2, u2)
    (w1, w2), (a1, a2) = chain_terms(torch, y, g, p, pool)
    assert sum_ok(t1, w1, a1) and sum_ok(t2, w2, a2)

    yo, go = _shifted(y, 1), _shifted(g, 1)
    assert yo.storage_offset() == go.storage_offset() == 1
    o1, o2 = fused_mlp.top_stats(yo, go, p, pool)
    assert torch.equal(t1, o1) and torch.equal(t2, o2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("G,S,C", [(64, 32, 128), (50, 13, 40),
                                   (16, 64, 16)])
def test_fused_top_stats_first_occurrence(dev, dtype, nan, G, S, C):
    """Tied z whose rows' y differ, and NaNs before and after a channel's
    max (chip_smoke.first_occurrence_case): only the first-occurrence
    argmax (a NaN the largest) passes; a kernel that took the last tied
    row, or the other lanes' row on a tie, would move T2 far past
    `sum_ok` (tests/test_torch_top_stats_order.py shows it on the CPU)."""
    from pointnet2_tpu_torch.ops import fused_mlp

    y, g, p = (t.to(dev) for t in first_occurrence_case(torch, G, S, C,
                                                         dtype, 7, nan))
    t1, t2 = fused_mlp.top_stats(y, g, p, True)
    w1, w2 = fused_mlp.top_stats_plain(y, g, p, True)
    assert torch.equal(t1.isnan(), w1.isnan())
    assert torch.equal(t2.isnan(), w2.isnan())
    assert bool(t2.isnan().any()) == nan and not bool(t1.isnan().any())
    (e1, e2), (a1, a2) = chain_terms(torch, y, g, p, True)
    fin = ~e2.isnan()
    assert sum_ok(t1, e1, a1) and sum_ok(t2[fin], e2[fin], a2[fin])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_pool", [True, False])
@pytest.mark.parametrize("G,S,ck,cp", [(2 * 512, 32, 128, 64),
                                       (1000, 7, 40, 196), (3, 1, 3, 5),
                                       (333, 3, 131, 40), (129, 5, 24, 131)])
def test_fused_dense_bwd_kernel_matches_plain(dev, rs, dtype, top_pool, G, S,
                                              ck, cp):
    """g_{k-1}: f32 within 1e-5 of max|g| of plain, bf16 within one bf16
    ulp of the exact product plus the f32 accumulation bound
    (`chip_smoke.g_ok`); dW, db and the T1/T2 of the kernel's own g against
    the exact sums of the plain version's terms (`sum_ok`); two launches
    bitwise equal. The shapes include channel counts that are no multiple
    of the mma tiles' 8 or 16 (131, 40, 24, 3, 5) and row counts that are
    no multiple of the 64-row tile or the 1024-row slab."""
    from pointnet2_tpu_torch.ops import fused_mlp

    config.disable_tf32()
    R = G * S
    yk = torch.from_numpy(rs.randn(*((G, S, ck) if top_pool else (R, ck)))
                          .astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rs.randn(G if top_pool else R, ck).astype(
        np.float32)).to(dev, dtype)
    yp = torch.from_numpy(rs.randn(R, cp).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rs.randn(ck, cp) / np.sqrt(cp)).astype(
        np.float32)).to(dev)
    pk, pp = _pack_on(rs, dev, ck), _pack_on(rs, dev, cp, m=False)
    before = ops.fused_dense_bwd_kernel.launches
    got = fused_mlp.dense_bwd(yk, yp, g, pk, pp, w, top_pool)
    again = fused_mlp.dense_bwd(yk, yp, g, pk, pp, w, top_pool)
    assert ops.fused_dense_bwd_kernel.launches == before + 2
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[0].view(view), again[0].view(view))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
    gp, dw, db, t1, t2 = got
    wg, _, _, _, _ = fused_mlp.dense_bwd_plain(yk, yp, g, pk, pp, w,
                                               top_pool)
    # dy and z_{k-1} as the plain version forms them
    if top_pool:
        dz = fused_mlp._pooled_cotangent(yk, g, pk).reshape(R, ck)
    else:
        dz = g.float()
    dout, yhat = fused_mlp._bn_bwd_terms(yk.reshape(R, ck), dz, pk)
    dy = fused_mlp._bn_dy(dout, yhat, pk)
    if dtype == torch.float32:
        d = (gp - wg).abs()
        assert float(d.max()) <= 1e-5 * float(wg.abs().max())
    else:
        assert g_ok(torch, gp, dy.to(dtype), w)
    dyc = dy.to(dtype).double()
    z = fused_mlp.affine_fwd_plain(yp, pp[0], pp[1]).double()  # >= 0
    assert sum_ok(dw, dyc.t() @ z, dyc.abs().t() @ z)
    # the packs are random, not the data's statistics, so db is not zero
    assert sum_ok(db, dy.double().sum(0), dy.double().abs().sum(0))
    (w1, w2), (a1, a2) = chain_terms(torch, yp, gp, pp, False)
    assert sum_ok(t1, w1, a1) and sum_ok(t2, w2, a2)


def test_dense_bwd_products_on_the_tensor_cores_in_bf16_only(dev):
    """The built library's SASS: HMMA/HGMMA in the bf16 g and dW kernels,
    none in the f32 ones (CUDA cores, no TF32)."""
    from pointnet2_tpu_torch.ops import _build

    check = Checks()
    check_tensor_cores(_build, check)
    assert not check.failed, check.failed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(2 * 512 * 32, 64), (1000, 3),
                                 (2 * 128 * 64, 128), (2 * 512 * 16, 32),
                                 (1000, 40), (777, 131), (1, 64), (1, 131)])
def test_fused_first_bwd_kernel_bitwise(dev, rs, dtype, R, C):
    """cls_ssg SA1's and SA2's shapes at B=2, a cls_msg SA1 scale (C=32),
    C not a multiple of the 16-byte vector (3, 40, 131), one row."""
    from pointnet2_tpu_torch.ops import fused_mlp

    x = torch.from_numpy(rs.randn(R, C).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rs.randn(R, C).astype(np.float32)).to(dev, dtype)
    p = _pack_on(rs, dev, C)
    before = ops.fused_first_bwd_kernel.launches
    got = fused_mlp.first_bwd(x, g, p)
    assert ops.fused_first_bwd_kernel.launches == before + 1
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view),
                       fused_mlp.first_bwd_plain(x, g, p).view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(2 * 512 * 32, 64), (777, 131)])
def test_fused_first_bwd_kernel_unaligned(dev, rs, dtype, R, C):
    """x and g one element into their storage (rows off the 16-byte
    boundary): element by element, the same bits."""
    from pointnet2_tpu_torch.ops import fused_mlp

    x = torch.from_numpy(rs.randn(R, C).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rs.randn(R, C).astype(np.float32)).to(dev, dtype)
    p = _pack_on(rs, dev, C)

    xo, go = _shifted(x, 1), _shifted(g, 1)
    assert xo.storage_offset() == go.storage_offset() == 1
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    want = fused_mlp.first_bwd_plain(x, g, p).view(view)
    assert torch.equal(fused_mlp.first_bwd(xo, go, p).view(view), want)
    assert torch.equal(fused_mlp.first_bwd(xo, g, p).view(view), want)


def test_fused_backward_kernels_refuse_what_they_do_not_take(dev, rs):
    y = torch.zeros(64, 8, device=dev)
    p = _pack_on(rs, dev, 8)
    w = torch.zeros(8, 4, device=dev)
    yp = torch.zeros(64, 4, device=dev)
    pp = _pack_on(rs, dev, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_top_stats_kernel(y.cpu(), y.cpu(), p.cpu(), False)
    with pytest.raises(ValueError, match="g must be"):
        ops.fused_top_stats_kernel(y.reshape(4, 16, 8), y, p, True)
    with pytest.raises(ValueError, match="p must be"):
        ops.fused_top_stats_kernel(y, y, pp, False)
    with pytest.raises(TypeError):
        ops.fused_first_bwd_kernel(y, y.bfloat16(), p)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_first_bwd_kernel(y.t().contiguous().t(), y, p)
    with pytest.raises(ValueError, match="w must be"):
        ops.fused_dense_bwd_kernel(y, yp, y, p, pp, w.t().contiguous(),
                                   False)
    with pytest.raises(ValueError, match="yp must be"):
        ops.fused_dense_bwd_kernel(y, yp[:5], y, p, pp, w, False)
    gp, dw, db, t1, t2 = ops.fused_dense_bwd_kernel(y[:0], yp[:0], y[:0], p,
                                                    pp, w, False)
    assert gp.shape == (0, 4) and not dw.any() and not db.any()


def test_eval_fused_chain_backward_raises_on_card(dev, rs):
    """An eval-mode SA layer with the gate on: the output has a grad_fn
    (the kernels write into fresh buffers; before, it had none and the
    layer's parameters silently got no gradient) and its backward raises,
    as the JAX package's eval chain has no gradient."""
    from pointnet2_tpu_torch import nn as tnn

    sa = tnn.SetAbstraction(16, 0.3, 8, 5, (8, 16)).to(dev).eval()
    xyz = torch.from_numpy(rs.rand(2, 64, 3).astype(np.float32)).to(dev)
    pts = torch.from_numpy(rs.randn(2, 64, 5).astype(np.float32)).to(dev)
    before = ops.fused_dense_kernel.launches
    with config.fused_mlp(True):
        _, out, _ = sa(xyz, pts)
    assert ops.fused_dense_kernel.launches == before + 1
    assert out.grad_fn is not None
    with pytest.raises(RuntimeError, match="not differentiable"):
        out.sum().backward()


def _points(rs, dev):
    return torch.from_numpy(rs.rand(4, 512, 3).astype(np.float32)).to(dev)


def test_fused_train_step_against_float64(dev, rs):
    """One f32 cls_ssg step at B=4, N=512 with the gate on, through the
    kernels and through the plain versions, and unfused, each against a
    float64 run of the same step. No two f32 routes are equal: the kernels
    sum in other orders than cuBLAS and PyTorch's reductions, and
    train-mode BN's E[y^2] - E[y]^2 magnifies that. So each route's loss
    within 1e-5 of float64, running statistics within 1e-3 of each
    tensor's scale, every gradient not zero in exact arithmetic within
    2e-2 of its norm (measured on the H100 at B=16: 5e-3 to 6e-3 for every
    route). No bf16 step is held to float64: every bf16 route is ~1.0 from
    it at init (chip_smoke.py phase 20); the bf16 chain is held layer by
    layer in `test_fused_layers_kernels_vs_plain`."""
    config.disable_tf32()
    batch = {"points": _points(rs, dev),
             "label": torch.from_numpy(rs.randint(0, 40, 4)).to(dev),
             "mask": torch.ones(4, device=dev)}
    ref = fixed_step(torch, dev, batch, None, "torch", False, double=True)
    top = max(float(g.norm()) for g in ref[1].values())
    compared = [k for k, g in ref[1].items() if float(g.norm()) >= 1e-6 * top]
    for impl, fused in (("auto", True), ("torch", True), ("auto", False)):
        loss, g, b, launched = fixed_step(torch, dev, batch, None, impl,
                                          fused)
        assert launched == ({"fused_top_stats": 2, "fused_dense_bwd": 4,
                             "fused_first_bwd": 2}
                            if impl == "auto" and fused
                            else dict.fromkeys(BWD, 0))
        worst = max(float((g[k] - ref[1][k]).norm() / ref[1][k].norm())
                    for k in compared)
        stats = max(float((b[k] - ref[2][k]).abs().max()
                          / ref[2][k].abs().max().clamp_min(1e-30))
                    for k in b)
        assert abs(loss - ref[0]) / ref[0] <= 1e-5
        assert stats <= 1e-3 and worst <= 2e-2, (impl, fused, stats, worst)


@pytest.mark.parametrize("dtype,name", [(torch.float32, "f32"),
                                        (torch.bfloat16, "bf16")])
def test_fused_layers_kernels_vs_plain(dev, rs, dtype, name):
    """cls_ssg's SA1 and SA2 in train mode with the gate on, at B=4, N=512,
    through the kernels and through the plain versions on the same inputs
    and cotangents (`chip_smoke.fused_layer_errs`): outputs, gradients and
    running statistics within `chip_smoke.LAYER_LIMITS`."""
    config.disable_tf32()
    before = {k: ops.KERNELS[k].launches for k in BWD}
    errs = fused_layer_errs(torch, dev, dtype, _points(rs, dev))
    assert {k: ops.KERNELS[k].launches - before[k] for k in BWD} == {
        "fused_top_stats": 2, "fused_dense_bwd": 4, "fused_first_bwd": 2}
    assert all(errs[k] <= LAYER_LIMITS[name][k] for k in errs), errs


@pytest.mark.parametrize("name,chains", [("pointnet2_cls_ssg", 2),
                                         ("pointnet2_cls_msg", 6)])
def test_trainer_on_card_with_the_gate_on(dev, tmp_path, name, chains):
    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    ds = SyntheticClassification(num_classes=4, samples_per_class=4,
                                 npoints=256, batch_size=8)
    before = {k: ops.KERNELS[k].launches for k in BWD}
    with config.fused_mlp(True), Trainer(TrainConfig(
            model=name, batch_size=8, augment="cls",
            log_dir=str(tmp_path))) as tr:
        state = tr.fit(ds, max_epoch=2)
    assert state.step == 4
    assert {k: ops.KERNELS[k].launches - before[k] for k in BWD} == {
        "fused_top_stats": chains * 4, "fused_dense_bwd": 2 * chains * 4,
        "fused_first_bwd": chains * 4}
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


# ---------------------------------------------------------------------------
# checkpoints and the evaluation protocols
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,fused", [("float32", False),
                                         ("bfloat16", True)])
def test_resume_on_card_equals_uninterrupted(dev, tmp_path, dtype, fused):
    """Trainer.fit stopped after 2 epochs and resumed to 4 on the card ends
    where two uninterrupted runs end: bit for bit when they agree
    (`chip_smoke.resume_verdict`)."""
    from chip_smoke import resume_verdict, train_snapshot
    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    def data():
        return tuple(SyntheticClassification(
            num_classes=4, samples_per_class=k, npoints=256, batch_size=4,
            seed=s) for s, k in ((0, 2), (1, 1)))

    def trainer(name):
        return Trainer(TrainConfig(batch_size=4, augment="cls", max_epoch=4,
                                   compute_dtype=dtype,
                                   log_dir=str(tmp_path / name)))

    refs = []
    with config.fused_mlp(fused):
        for r in range(2):
            train, evals = data()
            with trainer(f"ref{r}") as tr:
                refs.append(train_snapshot(
                    torch, tr, tr.fit(train, eval_dataset=evals)))
        train, evals = data()
        with trainer("resumed") as tr:
            tr.fit(train, eval_dataset=evals, max_epoch=2)
        with trainer("resumed") as tr:
            state = tr.fit(train, eval_dataset=evals)
            got = train_snapshot(torch, tr, state)
    assert state.step == 8 and got["generator"].device.type == "cpu"
    ok, what = resume_verdict(torch, got, refs)
    assert ok, what


def _protocol_fn(name, n, impl, log_dir):
    from chip_smoke import random_state_dict
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    tr = Trainer(TrainConfig(model=name, num_point=n, batch_size=4,
                             log_dir=log_dir))
    state = tr.init_state()
    state.model.load_state_dict(random_state_dict(torch, 0, name))
    fn = tr.eval_logits_fn(state)

    def run(batch):
        with config.default_impl(impl):
            return fn(batch)
    return tr, run


@pytest.mark.parametrize("which", ["cls", "part", "chopped", "whole"])
def test_protocol_kernels_equal_plain_on_card(dev, tmp_path, which):
    """Each evaluation protocol through the kernels and through the plain
    versions on the card, f32, same weights and seed: equal metric dicts
    (`chip_smoke.equal_metrics`)."""
    from chip_smoke import equal_metrics, labelled_room
    from pointnet2_tpu_torch import evaluation
    from pointnet2_tpu_torch.data import (
        ScannetDataset,
        ScannetDatasetWholeScene,
        SyntheticClassification,
        SyntheticShapeNetPart,
    )

    quiet = dict(log_fn=lambda s: None)
    rooms = [labelled_room(s) for s in (1, 2)]
    name, n, protocol = {
        "cls": ("pointnet2_cls_ssg", 256, lambda fn: (
            evaluation.evaluate_cls_voting(
                lambda p: fn({"points": p}), SyntheticClassification(
                    num_classes=40, samples_per_class=1, npoints=256,
                    batch_size=4, seed=2), num_votes=3, rng=0, **quiet))),
        "part": ("pointnet2_part_seg", 256, lambda fn: (
            evaluation.evaluate_part_seg_voting(
                fn, SyntheticShapeNetPart(num_samples=8, npoints=256,
                                          batch_size=4, seed=2),
                num_votes=3, rng=0, **quiet))),
        "chopped": ("pointnet2_sem_seg", 1024, lambda fn: (
            evaluation.evaluate_scannet_chopped(
                fn, ScannetDataset(scenes=rooms, npoints=1024, split="test",
                                   batch_size=4), rng=0, **quiet))),
        "whole": ("pointnet2_sem_seg", 1024, lambda fn: (
            evaluation.evaluate_scannet_whole_scene(
                fn, ScannetDatasetWholeScene(scenes=rooms, npoints=1024,
                                             split="test"),
                batch_size=4, **quiet))),
    }[which]
    results = []
    for impl in ("auto", "torch"):
        before = ops.fps_kernel.launches
        tr, fn = _protocol_fn(name, n, impl, str(tmp_path))
        with tr:
            results.append(protocol(fn))
        assert (ops.fps_kernel.launches > before) == (impl == "auto")
    assert equal_metrics(*results), results


def _small_epoch(tmp_path, name, K, fused, **kw):
    """One epoch of 5 batches of 4 synthetic clouds (256 points, dropout and
    augment "cls") with steps_per_call=K on the card; the snapshot, the
    launches and the K-step object."""
    from chip_smoke import train_snapshot
    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    data = SyntheticClassification(num_classes=4, samples_per_class=5,
                                   npoints=256, batch_size=4, seed=0)
    cfg = TrainConfig(batch_size=4, num_point=256, augment="cls",
                      steps_per_call=K, compute_dtype="bfloat16",
                      log_dir=str(tmp_path / f"{name}{K}"), **kw)
    with config.fused_mlp(fused), Trainer(cfg) as tr:
        for w in ops.KERNELS.values():
            w.launches = 0
        state = tr.train_epoch(tr.init_state(), data, 0)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in ops.KERNELS.items()}
        return train_snapshot(torch, tr, state), counts, tr._multi


@pytest.mark.parametrize("fused,remat", [(False, "none"), (True, "none"),
                                         (True, "full")])
def test_graphed_steps_equal_single_steps_on_card(dev, tmp_path, fused,
                                                  remat):
    """steps_per_call=3 over 5 batches (a replay of 3, two single steps)
    ends bit for bit where 5 single steps end, a checkpointed forward
    captured too; a replay counts 3 steps' launches, the epoch the 5
    steps' and the warm-up step's."""
    from chip_smoke import snapshot_diff

    want, per5, _ = _small_epoch(tmp_path, "single", 1, fused, remat=remat)
    got, counts, multi = _small_epoch(tmp_path, "graphed", 3, fused,
                                      remat=remat)
    _, names = snapshot_diff(torch, want, got)
    assert not names, names
    (graphed,) = multi.graphs.values()
    assert graphed.launches == {k: 3 * n // 5 for k, n in per5.items()}
    assert counts == {k: 6 * n // 5 for k, n in per5.items()}


def test_graphed_epoch_spans_on_card(dev, tmp_path):
    """The same K=3 epoch under a profiler records one capture, one replay
    of 3 steps, the call's two stages (its host views, counted, then the
    graph's buffers) and the two eager steps, and ends bit for bit where
    the untraced epoch ends."""
    from chip_smoke import snapshot_diff
    from pointnet2_tpu_torch.utils import profiling

    want, _, _ = _small_epoch(tmp_path, "untraced", 3, False)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got, _, _ = _small_epoch(tmp_path, "traced", 3, False)
    stats = profiling.span_stats()
    _, names = snapshot_diff(torch, want, got)
    assert not names, names
    assert {k: v["count"] for k, v in stats.items()
            if k.startswith("step.")} == {"step.capture": 1,
                                          "step.replay": 1,
                                          "step.stage": 2, "step.eager": 2}
    assert stats["step.replay"]["counts"] == {"steps": 3}
    assert stats["step.stage"]["counts"] == {"batches": 3}
    assert stats["trainer.epoch"]["counts"] == {"steps": 5, "examples": 20}


@pytest.mark.parametrize("remat", ["full", "dots", "dots_nobatch"])
def test_remat_equals_none_on_card(dev, tmp_path, remat):
    """An epoch under each remat policy, the fused chain on, ends bit for
    bit where remat='none' ends; the forwards run twice."""
    from chip_smoke import snapshot_diff

    want, per, _ = _small_epoch(tmp_path, "none", 1, True)
    got, counts, _ = _small_epoch(tmp_path, remat, 1, True, remat=remat)
    _, names = snapshot_diff(torch, want, got)
    assert not names, names
    assert counts["fps"] == 2 * per["fps"]
    assert counts["scatter_rows"] == per["scatter_rows"]


@pytest.mark.parametrize("B,T,S,npoint", [(1, 20, 8192, 1024),
                                          (3, 500, 4000, 333)])
def test_sample_mesh_kernels_equal_plain_on_card(dev, rs, B, T, S, npoint):
    """ops.sample_mesh: the corner gather and FPS through the kernels,
    against the plain route on the same uniforms: exact."""
    tris = torch.from_numpy(rs.normal(size=(B, T, 3, 3)).astype(
        np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    draws = tuple(torch.rand((B, S), generator=g, device=dev)
                  for _ in range(3))
    before = (ops.fps_kernel.launches, ops.gather_rows_kernel.launches)
    got = ops.sample_mesh(tris, S, npoint=npoint, uniforms=draws)
    assert (ops.fps_kernel.launches - before[0],
            ops.gather_rows_kernel.launches - before[1]) == (1, 2)
    want = _plain(lambda: ops.sample_mesh(tris, S, npoint=npoint,
                                          uniforms=draws))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name,spatial,kernel", [
    ("Conv1D", (64,), (5,)), ("Conv2D", (15, 16), (3, 3)),
    ("Conv3D", (7, 8, 9), (3, 2, 3)), ("Conv2DTranspose", (7, 8), (3, 4))])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_extras_on_card_match_cpu(dev, name, spatial, kernel, padding):
    """nn.extras in f32 (TF32 off) on the card within 1e-5 of max|y| of
    the CPU, strides 2, BN in train mode."""
    import copy

    from pointnet2_tpu_torch.nn import extras

    config.disable_tf32()
    layer = getattr(extras, name)(6, 10, kernel, (2,) * len(kernel),
                                  padding, bn=True).train()
    card = copy.deepcopy(layer).to(dev)
    x = torch.randn((2, *spatial, 6), generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        want, got = layer(x), card(x.to(dev)).cpu()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
