"""The port's point ops held against the JAX package on the CPU.

The same numpy inputs (from a seed) go through pointnet2_tpu.ops, with
impl="xla" and with impl="pallas" (the Pallas kernels in interpret mode),
and through pointnet2_tpu_torch.ops on CPU tensors, which take the plain
PyTorch versions of the CUDA kernels. Indices must be bit-identical and
gathers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import ops as jops
from pointnet2_tpu_torch import config
from pointnet2_tpu_torch import ops as tops
from pointnet2_tpu_torch.ops import _build

IMPLS = ["xla", "pallas"]


def _queries(rng, xyz1, M):
    qidx = rng.randint(0, xyz1.shape[1], (xyz1.shape[0], M))
    return np.stack([xyz1[b][qidx[b]] for b in range(xyz1.shape[0])])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("B,N,npoint", [(2, 128, 32), (3, 100, 17),
                                        (2, 256, 64), (1, 40, 64)])
def test_fps_bit_identical(rng, impl, B, N, npoint):
    xyz = rng.rand(B, N, 3).astype(np.float32)
    want = np.asarray(jops.farthest_point_sample(jnp.asarray(xyz), npoint,
                                                 impl=impl))
    got = tops.farthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_fps_ties_take_lowest_index(impl):
    # a 4x4x4 integer grid: every step has many exactly tied candidates
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1)
    xyz = np.ascontiguousarray(g.reshape(1, 64, 3).astype(np.float32))
    want = np.asarray(jops.farthest_point_sample(jnp.asarray(xyz), 20,
                                                 impl=impl))
    got = tops.farthest_point_sample(torch.from_numpy(xyz), 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize(
    "B,N,M,radius,nsample",
    [(2, 128, 32, 0.4, 16), (3, 100, 17, 0.2, 8), (2, 256, 64, 0.1, 32),
     (2, 20, 8, 0.5, 32)],  # the last: nsample > N
)
def test_ball_query_bit_identical(rng, impl, B, N, M, radius, nsample):
    xyz1 = rng.rand(B, N, 3).astype(np.float32)
    xyz2 = _queries(rng, xyz1, M)
    widx, wcnt = jops.query_ball_point(radius, nsample, jnp.asarray(xyz1),
                                       jnp.asarray(xyz2), impl=impl)
    idx, cnt = tops.query_ball_point(radius, nsample, torch.from_numpy(xyz1),
                                     torch.from_numpy(xyz2))
    assert idx.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))


@pytest.mark.parametrize("impl", IMPLS)
def test_ball_query_empty_ball_and_pad(impl):
    xyz1 = np.array([[[5.0, 5, 5], [0.0, 0, 0], [6.0, 6, 6], [0.01, 0, 0]]],
                    np.float32)
    xyz2 = np.array([[[0.0, 0, 0], [-3.0, -3, -3]]], np.float32)
    widx, wcnt = jops.query_ball_point(0.1, 4, jnp.asarray(xyz1),
                                       jnp.asarray(xyz2), impl=impl)
    idx, cnt = tops.query_ball_point(0.1, 4, torch.from_numpy(xyz1),
                                     torch.from_numpy(xyz2))
    np.testing.assert_array_equal(idx.numpy(), [[[1, 3, 1, 1], [0, 0, 0, 0]]])
    np.testing.assert_array_equal(cnt.numpy(), [[2, 0]])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("impl", IMPLS)
def test_ball_query_radius_boundary(impl):
    """A point at exactly the f32-rounded radius is outside (d2 < r2 is
    strict, r2 = float32(r)**2 rounded in f32), as in the JAX package."""
    r = 0.1
    d = float(np.sqrt(np.float32(np.float32(r) ** 2)))  # d2 == f32(r)^2
    xyz = np.array([[[0.0, 0.0, 0.0], [d, 0.0, 0.0], [0.05, 0.0, 0.0],
                     [0.5, 0.5, 0.5]]], np.float32)
    q = xyz[:, :1]
    widx, wcnt = jops.query_ball_point(r, 3, jnp.asarray(xyz), jnp.asarray(q),
                                       impl=impl)
    idx, cnt = tops.query_ball_point(r, 3, torch.from_numpy(xyz),
                                     torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


def _as_f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,M,S,C", [(2, 64, 16, 8, 32), (1, 100, 7, 3, 5),
                                       (2, 128, 32, 4, 3)])
def test_group_point_exact(rng, impl, dtype, B, N, M, S, C):
    pts = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, M, S)).astype(np.int32)
    want = jops.group_point(jnp.asarray(pts).astype(dtype), jnp.asarray(idx),
                            impl=impl)
    got = tops.group_point(torch.from_numpy(pts).to(getattr(torch, dtype)),
                           torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, M, S, C)
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_point_exact(rng, impl, dtype):
    pts = rng.randn(2, 50, 3).astype(np.float32)
    idx = rng.randint(0, 50, (2, 20)).astype(np.int32)
    want = jops.gather_point(jnp.asarray(pts).astype(dtype), jnp.asarray(idx),
                             impl=impl)
    got = tops.gather_point(torch.from_numpy(pts).to(getattr(torch, dtype)),
                            torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))


def test_max_pool_forward(rng):
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    got = tops.max_pool(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.max_pool(jnp.asarray(x), 2)))


def test_cpu_tensors_take_plain_versions_without_nvcc(rng, monkeypatch):
    """The op modules import and run on CPU tensors with no nvcc and no
    build: any attempt to build or load a kernel library fails the test,
    and no launch counter moves."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "nvcc_path", refuse)
    before = {k: w.launches for k, w in tops.KERNELS.items()}
    xyz = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32))
    new_xyz = tops.gather_point(xyz, tops.farthest_point_sample(xyz, 16))
    idx, _ = tops.query_ball_point(0.3, 8, xyz, new_xyz)
    tops.group_point(xyz, idx)
    assert {k: w.launches for k, w in tops.KERNELS.items()} == before
    assert not config.use_kernel(xyz)


def test_kernel_wrappers_refuse_cpu_tensors():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tops.fps_kernel(xyz, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tops.ball_query_kernel(0.1, 4, xyz, xyz)
    with pytest.raises(ValueError, match="CUDA"):
        tops.gather_rows_kernel(xyz, torch.zeros(1, 4, dtype=torch.int32))


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        config.use_kernel(torch.zeros(1, device="meta"))


def test_default_impl_switch_validates():
    with pytest.raises(ValueError):
        config.set_default_impl("pallas")
    with config.default_impl("torch"):
        assert config.get_default_impl() == "torch"
    assert config.get_default_impl() == "auto"


# ---------------------------------------------------------------------------
# the scatter-add (the gather's backward) and the gradients of the ops
# ---------------------------------------------------------------------------

from pointnet2_tpu.ops.pallas import group as jgroup  # noqa: E402
from pointnet2_tpu_torch.ops import grouping as tgrouping  # noqa: E402
from pointnet2_tpu_torch.ops import pooling as tpooling  # noqa: E402


def _scatter_case(rng, B, K, n, C):
    """g (B, K, C) and idx (B, K) with duplicates (indices drawn from a
    quarter of the rows), a hot row, and out-of-range indices (-1 and n,
    which the Pallas kernels' one-hot matches with no row)."""
    g = rng.randn(B, K, C).astype(np.float32)
    idx = rng.randint(0, max(n // 4, 1), (B, K)).astype(np.int32)
    idx[:, ::7] = 1  # a hot row
    idx[:, 3::11] = -1
    idx[:, 5::13] = n
    return g, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 5, 32, 64])
def test_scatter_plain_matches_pallas(rng, dtype, C):
    """The plain scatter-add against _scatter_rows (C > 16) and
    _scatter_rows_t (C <= 16) in interpret mode. Both sum in f32 and cast
    once; the one-hot dot sums in another order, so f32 agrees to 1e-5 of
    the largest row sum and bf16 to one bf16 ulp (2^-7 relative) of it."""
    B, K, n = 2, 300, 64
    g, idx = _scatter_case(rng, B, K, n, C)
    gj = jnp.asarray(g).astype(dtype)
    want = np.asarray(jgroup._scatter_rows(gj, jnp.asarray(idx), n)
                      ).astype(np.float32)
    got = tgrouping.scatter_rows_plain(
        torch.from_numpy(g).to(getattr(torch, dtype)), torch.from_numpy(idx),
        n)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, n, C)
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def test_scatter_plain_edge_cases():
    """K = 0 and B = 0 give zeros; an index outside [0, n) adds nothing."""
    for B, K in ((2, 0), (0, 5)):
        out = tgrouping.scatter_rows(torch.ones(B, K, 4),
                                     torch.zeros(B, K, dtype=torch.int32), 6)
        assert out.shape == (B, 6, 4) and not out.any()
    g = torch.ones(1, 3, 2)
    out = tgrouping.scatter_rows(g, torch.tensor([[-1, 4, 9]]), 4)
    assert not out.any()


@pytest.mark.parametrize("impl", ["pallas", "mxu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 64])
def test_group_point_grad_matches_jax_vjp(rng, impl, dtype, C):
    """d(group_point)/d(points) through the port's GatherRows against
    jax.vjp of group_point with impl="pallas" (_scatter_rows in interpret
    mode) and impl="mxu" (onehot_scatter_rows); both accumulate in f32.
    Tolerance as in test_scatter_plain_matches_pallas."""
    B, N, M, S = 2, 64, 16, 8
    pts = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, M, S)).astype(np.int32)
    ct = rng.randn(B, M, S, C).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jops.group_point(p, jnp.asarray(idx),
                                                impl=impl),
                     jnp.asarray(pts).astype(dtype))
    want = np.asarray(vjp(jnp.asarray(ct).astype(dtype))[0]).astype(
        np.float32)
    x = torch.from_numpy(pts).to(getattr(torch, dtype)).requires_grad_()
    out = tops.group_point(x, torch.from_numpy(idx))
    # the (B, M*S, C) gather's node, under group_point's reshape
    node = out.grad_fn.next_functions[0][0]
    assert type(node).__name__ == "GatherRowsBackward"
    out.backward(torch.from_numpy(ct).to(getattr(torch, dtype)))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(x.grad.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_gather_point_grad_only_when_needed(rng, monkeypatch):
    """gather_point differentiates in points, and its backward runs no
    scatter when the points need no gradient (xyz in cls_ssg)."""
    pts = torch.from_numpy(rng.randn(2, 30, 3).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 30, (2, 10)).astype(np.int32))
    x = pts.clone().requires_grad_()
    tops.gather_point(x, idx).square().sum().backward()
    want = tgrouping.scatter_rows_plain(2 * tgrouping.gather_rows_plain(
        pts, idx), idx, 30)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)

    def refuse(*args):
        raise AssertionError("scatter ran for an input without a gradient")

    monkeypatch.setattr(tgrouping, "scatter_rows", refuse)
    w = torch.ones(3, requires_grad=True)
    (tops.gather_point(pts, idx) * w).sum().backward()
    assert w.grad is not None


def _ties(rng, shape, dtype):
    """Values on a coarse grid, so that most windows have exact ties."""
    return (rng.randint(-3, 4, shape) * 0.5).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [1, 2, -1])
def test_max_pool_grad_first_occurrence_matches_jax(rng, dtype, dim):
    """With exact ties, the whole cotangent goes to the first maximal index,
    as jax.grad of pointnet2_tpu.ops.max_pool; amax would split it."""
    x = _ties(rng, (2, 6, 5, 4), np.float32)
    ct = rng.randn(*np.delete(x.shape, dim % 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jops.max_pool(v, dim),
                     jnp.asarray(x).astype(dtype))
    want = np.asarray(vjp(jnp.asarray(ct).astype(dtype))[0]).astype(
        np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    out = tops.max_pool(t, dim)
    assert type(out.grad_fn).__name__ == "MaxPoolBackward"
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        np.asarray(jops.max_pool(jnp.asarray(x).astype(dtype), dim)
                   ).astype(np.float32))
    out.backward(torch.from_numpy(ct).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(t.grad.float().numpy(), want)
    # exactly one nonzero (the first max) per window where ct != 0
    assert ((t.grad != 0).sum(dim) <= 1).all()


def test_max_pool_without_grad_is_plain_amax(rng, monkeypatch):
    """Under no_grad (serving) the pool records nothing and computes no
    argmax."""
    def refuse(*args):
        raise AssertionError("the autograd pool ran without autograd")

    monkeypatch.setattr(tpooling.MaxPool, "apply", refuse)
    x = torch.from_numpy(rng.randn(2, 5, 3).astype(np.float32))
    with torch.no_grad():
        out = tops.max_pool(x.requires_grad_(), 1)
    torch.testing.assert_close(out, x.detach().amax(1), rtol=0, atol=0)
