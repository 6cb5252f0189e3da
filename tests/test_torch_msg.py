"""The port's multi-scale-grouping ops and layers held against the JAX
package on the CPU: the ball query with the neighbours' xyz and its
gradient, the multi-radius ball query, kNN, every option of
SetAbstraction, and SetAbstractionMSG in both layouts.

The same numpy inputs (from a seed) go through pointnet2_tpu with
impl="xla" and impl="pallas" (the Pallas kernels in interpret mode), and
through pointnet2_tpu_torch on CPU tensors, which take the plain PyTorch
versions of the CUDA kernels. Indices are bit-identical; coordinates are
compared by value (see test_group_xyz_keeps_signed_zero); layer outputs at
the f32 tolerance of test_torch_model (matmul summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import nn as jnn
from pointnet2_tpu import ops as jops
from pointnet2_tpu_torch import config, flax_to_torch
from pointnet2_tpu_torch import nn as tnn
from pointnet2_tpu_torch import ops as tops
from pointnet2_tpu_torch.ops import grouping as tgrouping
from tests.test_torch_model import F32_TOL, _jax_init, _randomize

IMPLS = ["xla", "pallas"]
B = 2


def _queries(rng, xyz1, M):
    qidx = rng.randint(0, xyz1.shape[1], (xyz1.shape[0], M))
    return np.stack([xyz1[b][qidx[b]] for b in range(xyz1.shape[0])])


def _rows(xyz1, idx):
    """xyz1[b, idx[b]] in numpy: (B, M, S, 3)."""
    return np.stack([xyz1[b][idx[b]] for b in range(xyz1.shape[0])])


# ---------------------------------------------------------------------------
# ball query with the neighbours' xyz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize(
    "Bq,N,M,radius,nsample",
    [(2, 128, 32, 0.4, 16), (3, 100, 17, 0.2, 8), (2, 256, 64, 0.1, 32),
     (2, 20, 8, 0.5, 32)],  # the last: nsample > N
)
def test_query_ball_and_group_xyz_matches_jax(rng, impl, Bq, N, M, radius,
                                              nsample):
    xyz1 = rng.rand(Bq, N, 3).astype(np.float32)
    xyz2 = _queries(rng, xyz1, M)
    widx, wcnt, wgrp = jops.query_ball_and_group_xyz(
        radius, nsample, jnp.asarray(xyz1), jnp.asarray(xyz2), impl=impl)
    idx, cnt, grouped = tops.query_ball_and_group_xyz(
        radius, nsample, torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    assert idx.dtype == cnt.dtype == torch.int32
    assert grouped.dtype == torch.float32
    assert grouped.shape == (Bq, M, nsample, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(wgrp))
    np.testing.assert_array_equal(grouped.numpy(), _rows(xyz1, idx.numpy()))


@pytest.mark.parametrize("impl", IMPLS)
def test_query_ball_and_group_xyz_empty_ball(impl):
    """An empty ball: index 0 in every slot and point 0's coordinates;
    a partial ball pads with the first hit's."""
    xyz1 = np.array([[[5.0, 5, 5], [0.0, 0, 0], [6.0, 6, 6], [0.01, 0, 0]]],
                    np.float32)
    xyz2 = np.array([[[0.0, 0, 0], [-3.0, -3, -3]]], np.float32)
    widx, wcnt, wgrp = jops.query_ball_and_group_xyz(
        0.1, 4, jnp.asarray(xyz1), jnp.asarray(xyz2), impl=impl)
    idx, cnt, grouped = tops.query_ball_and_group_xyz(
        0.1, 4, torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    np.testing.assert_array_equal(idx.numpy(), [[[1, 3, 1, 1], [0, 0, 0, 0]]])
    np.testing.assert_array_equal(cnt.numpy(), [[2, 0]])
    np.testing.assert_array_equal(grouped.numpy()[0, 1], np.full((4, 3), 5.0))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(wgrp))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


def test_group_xyz_keeps_signed_zero():
    """The TPU kernel extracts each coordinate by a masked sum, which turns
    -0.0 into +0.0; the port copies the point (as group_point does), so it
    keeps -0.0. The two agree by value, and the tests compare by value."""
    xyz1 = np.array([[[-0.0, 0.0, -0.0], [0.05, -0.0, 0.0]]], np.float32)
    xyz2 = np.zeros((1, 1, 3), np.float32)
    _, _, wgrp = jops.query_ball_and_group_xyz(
        0.1, 3, jnp.asarray(xyz1), jnp.asarray(xyz2), impl="pallas")
    _, _, grouped = tops.query_ball_and_group_xyz(
        0.1, 3, torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(wgrp))
    assert np.signbit(grouped.numpy()[0, 0, 0, 0])
    assert not np.signbit(np.asarray(wgrp)[0, 0, 0, 0])


def _group_xyz_case(rng, N=96, M=24, nsample=8, radius=0.3):
    xyz1 = rng.rand(B, N, 3).astype(np.float32)
    xyz2 = _queries(rng, xyz1, M)
    ct = rng.randn(B, M, nsample, 3).astype(np.float32)
    return xyz1, xyz2, ct, radius, nsample


@pytest.mark.parametrize("impl", IMPLS)
def test_query_ball_and_group_xyz_grad_matches_jax_vjp(rng, impl):
    """f32: d(grouped)/d(xyz1) is the scatter-add of the cotangent;
    against jax.vjp (the Pallas custom VJP's one-hot scatter, or XLA's
    scatter), to 1e-5 of the largest row sum (summation order). xyz2 gets
    no gradient."""
    xyz1, xyz2, ct, radius, nsample = _group_xyz_case(rng)
    _, vjp = jax.vjp(lambda p: jops.query_ball_and_group_xyz(
        radius, nsample, p, jnp.asarray(xyz2), impl=impl)[2],
        jnp.asarray(xyz1))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    x = torch.from_numpy(xyz1).requires_grad_()
    q = torch.from_numpy(xyz2).requires_grad_()
    _, _, grouped = tops.query_ball_and_group_xyz(radius, nsample, x, q)
    assert type(grouped.grad_fn).__name__ == "BallQueryGroupXyzBackward"
    grouped.backward(torch.from_numpy(ct))
    assert q.grad is None
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("impl", ["pallas", "mxu"])
def test_query_ball_and_group_xyz_grad_bf16(rng, impl):
    """bf16 points (exact in bf16, so both sides find the same
    neighbours): the port scatters the f32 cotangent in f32 and rounds once
    to bf16. Against the Pallas route (its custom VJP returns the f32 sum)
    and the mxu route (onehot_scatter_rows of the same indices, f32
    accumulation of bf16 terms); within one bf16 ulp (2^-7 relative) of
    the largest row sum."""
    xyz1, xyz2, ct, radius, nsample = _group_xyz_case(rng)
    xyz1 = np.array(jnp.asarray(xyz1).astype(jnp.bfloat16).astype(
        jnp.float32))
    ct = np.array(jnp.asarray(ct).astype(jnp.bfloat16).astype(jnp.float32))
    x = torch.from_numpy(xyz1).to(torch.bfloat16).requires_grad_()
    idx, _, grouped = tops.query_ball_and_group_xyz(
        radius, nsample, x, torch.from_numpy(xyz2))
    grouped.backward(torch.from_numpy(ct))
    assert x.grad.dtype == torch.bfloat16
    xj = jnp.asarray(xyz1).astype(jnp.bfloat16)
    if impl == "pallas":
        fn = lambda p: jops.query_ball_and_group_xyz(  # noqa: E731
            radius, nsample, p, jnp.asarray(xyz2), impl="pallas")[2]
        ctj = jnp.asarray(ct)
    else:
        fn = lambda p: jops.group_point(  # noqa: E731
            p, jnp.asarray(idx.numpy()), impl="mxu")
        ctj = jnp.asarray(ct).astype(jnp.bfloat16)
    _, vjp = jax.vjp(fn, xj)
    want = np.asarray(vjp(ctj)[0]).astype(np.float32)
    tol = 2.0 ** -7
    np.testing.assert_allclose(x.grad.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# multi-radius ball query, kNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("radii,nsamples", [
    ((0.4, 0.1, 0.2), (16, 8, 32)),  # unsorted
    ((0.2, 0.2, 0.3), (8, 16, 8)),  # a radius repeated
    ((0.3,), (12,)),  # a single radius
])
def test_query_ball_point_multi_matches_jax(rng, impl, radii, nsamples):
    xyz1 = rng.rand(B, 128, 3).astype(np.float32)
    xyz2 = _queries(rng, xyz1, 40)
    want = jops.query_ball_point_multi(radii, nsamples, jnp.asarray(xyz1),
                                       jnp.asarray(xyz2), impl=impl)
    got = tops.query_ball_point_multi(radii, nsamples, torch.from_numpy(xyz1),
                                      torch.from_numpy(xyz2))
    assert len(got) == len(want) == len(radii)
    for (idx, cnt), (widx, wcnt), r, ns in zip(got, want, radii, nsamples):
        assert idx.shape == (B, 40, ns)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
        sidx, scnt = tops.query_ball_point(r, ns, torch.from_numpy(xyz1),
                                           torch.from_numpy(xyz2))
        assert torch.equal(idx, sidx) and torch.equal(cnt, scnt)


def test_knn_point_ties_take_lowest_index(rng):
    """Every dataset point appears twice (exact ties); indices match
    jax.lax.top_k's (lowest index first among ties) bit for bit, distances
    to 2^-21 relative (XLA:CPU contracts the squared distances into FMAs,
    see test_torch_interpolate)."""
    base = rng.rand(B, 48, 3).astype(np.float32)
    xyz1 = np.concatenate([base, base[:, ::-1]], axis=1)
    xyz2 = np.concatenate([base[:, :5], rng.rand(B, 11, 3).astype(
        np.float32)], axis=1)
    wval, widx = jops.knn_point(6, jnp.asarray(xyz1), jnp.asarray(xyz2))
    val, idx = tops.knn_point(6, torch.from_numpy(xyz1),
                              torch.from_numpy(xyz2))
    assert idx.dtype == torch.int32 and idx.shape == (B, 16, 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(val.numpy(), np.asarray(wval), rtol=2.0 ** -21,
                               atol=1e-12)
    # the first five queries are dataset points: two exact zeros each
    assert (val.numpy()[:, :5, :2] == 0).all()


def test_new_kernel_wrappers_refuse_cpu_tensors():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["ball_query_group_xyz"](0.1, 4, xyz, xyz)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["ball_query_multi"]((0.1, 0.2), (4, 8), xyz, xyz)
    # the plain versions are what the CPU runs
    before = {k: w.launches for k, w in tops.KERNELS.items()}
    tops.query_ball_and_group_xyz(0.1, 4, xyz, xyz)
    tops.query_ball_point_multi((0.1, 0.2), (4, 8), xyz, xyz)
    assert {k: w.launches for k, w in tops.KERNELS.items()} == before
    assert tgrouping.MAX_RADII == 8


# ---------------------------------------------------------------------------
# SetAbstraction options and SetAbstractionMSG
# ---------------------------------------------------------------------------


def _sa_pair(jmod, tmod, xyz, pts, seed, jax_kw=None):
    """Randomised Flax variables of jmod, converted strictly into tmod;
    both outputs on the same numpy inputs."""
    args = (jnp.asarray(xyz), None if pts is None else jnp.asarray(pts))
    variables = _randomize(_jax_init(jmod, *args), seed=seed)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, **(jax_kw or {})))(
        variables, *args)
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    with torch.inference_mode():
        got = tmod.eval()(torch.from_numpy(xyz),
                          None if pts is None else torch.from_numpy(pts))
    return got, want


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("pooling", ["max", "avg", "weighted_avg",
                                     "max_and_avg"])
def test_set_abstraction_pooling_modes_match_jax(rng, pooling, fuse):
    xyz = rng.rand(B, 96, 3).astype(np.float32)
    pts = rng.randn(B, 96, 5).astype(np.float32)
    kw = dict(pooling=pooling, fuse_first=fuse)
    (nxyz, npts, idx), (wxyz, wpts, widx) = _sa_pair(
        jnn.SetAbstraction(24, 0.3, 8, (16, 32), **kw),
        tnn.SetAbstraction(24, 0.3, 8, 5, (16, 32), **kw), xyz, pts, 21)
    np.testing.assert_array_equal(nxyz.numpy(), np.asarray(wxyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    assert npts.shape == (B, 24, 64 if pooling == "max_and_avg" else 32)
    _close(npts, wpts)


@pytest.mark.parametrize("fuse", [True, False])
def test_set_abstraction_knn_matches_jax(rng, fuse):
    xyz = rng.rand(B, 96, 3).astype(np.float32)
    pts = rng.randn(B, 96, 5).astype(np.float32)
    (_, npts, idx), (_, wpts, widx) = _sa_pair(
        jnn.SetAbstraction(24, None, 8, (16, 32), knn=True, fuse_first=fuse),
        tnn.SetAbstraction(24, None, 8, 5, (16, 32), knn=True,
                           fuse_first=fuse), xyz, pts, 22)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    _close(npts, wpts)


@pytest.mark.parametrize("group_all", [False, True])
def test_set_abstraction_mlp2_matches_jax(rng, group_all):
    xyz = rng.rand(B, 96, 3).astype(np.float32)
    pts = rng.randn(B, 96, 5).astype(np.float32)
    npoint, ns = (None, None) if group_all else (24, 8)
    (_, npts, _), (_, wpts, _) = _sa_pair(
        jnn.SetAbstraction(npoint, 0.3, ns, (16, 32), mlp2=(24, 12),
                           group_all=group_all),
        tnn.SetAbstraction(npoint, 0.3, ns, 5, (16, 32), mlp2=(24, 12),
                           group_all=group_all), xyz, pts, 23)
    assert npts.shape == (B, 1 if group_all else 24, 12)
    _close(npts, wpts)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("option", ["use_xyz=False", "bn=False"])
def test_set_abstraction_use_xyz_and_bn_match_jax(rng, option, fuse):
    xyz = rng.rand(B, 96, 3).astype(np.float32)
    pts = rng.randn(B, 96, 5).astype(np.float32)
    kw = {"use_xyz": False} if option == "use_xyz=False" else {"bn": False}
    (_, npts, _), (_, wpts, _) = _sa_pair(
        jnn.SetAbstraction(24, 0.3, 8, (16, 32), fuse_first=fuse, **kw),
        tnn.SetAbstraction(24, 0.3, 8, 5, (16, 32), fuse_first=fuse, **kw),
        xyz, pts, 24)
    _close(npts, wpts)


def test_set_abstraction_unfused_runs_the_grouped_xyz_op(rng, monkeypatch):
    """The unfused ball-query path groups coordinates through
    query_ball_and_group_xyz (the op with row 3's kernel on the card)."""
    from pointnet2_tpu_torch.nn import pointnet

    calls = []
    real = pointnet.query_ball_and_group_xyz

    def spy(*args):
        calls.append(args[:2])
        return real(*args)

    monkeypatch.setattr(pointnet, "query_ball_and_group_xyz", spy)
    xyz = torch.from_numpy(rng.rand(B, 64, 3).astype(np.float32))
    sa = tnn.SetAbstraction(16, 0.3, 8, 0, (8, 16), fuse_first=False).eval()
    msg = tnn.SetAbstractionMSG(16, (0.2, 0.4), (4, 8), 0, ((8,), (8, 16)),
                                fuse_first=False).eval()
    with torch.inference_mode():
        sa(xyz, None)
        msg(xyz, None)
    assert calls == [(0.3, 8), (0.2, 4), (0.4, 8)]


MSG_ARGS = (32, (0.2, 0.4, 0.3), (8, 16, 4), ((16, 32), (16, 16, 24), (8,)))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("C", [0, 5])
def test_set_abstraction_msg_matches_jax(rng, C, fuse, dtype):
    """Both layouts of the MSG layer against the JAX module: f32 at the f32
    tolerance, bf16 within 2% of the output's range (test_torch_model's
    bf16 bound); new_xyz bit for bit."""
    xyz = rng.rand(B, 128, 3).astype(np.float32)
    pts = rng.randn(B, 128, C).astype(np.float32) if C else None
    npoint, radii, nss, mlps = MSG_ARGS
    (nxyz, npts), (wxyz, wpts) = _sa_pair(
        jnn.SetAbstractionMSG(npoint, radii, nss, mlps, fuse_first=fuse,
                              dtype=None if dtype is None else jnp.bfloat16),
        tnn.SetAbstractionMSG(npoint, radii, nss, C, mlps, fuse_first=fuse,
                              dtype=None if dtype is None else torch.bfloat16),
        xyz, pts, 25 + C)
    np.testing.assert_array_equal(nxyz.numpy(), np.asarray(wxyz))
    assert npts.shape == (B, npoint, 32 + 24 + 8)
    if dtype is None:
        _close(npts, wpts)
    else:
        want = np.asarray(wpts).astype(np.float32)
        assert np.abs(npts.float().numpy() - want).max() <= (
            0.02 * np.abs(want).max())


def test_set_abstraction_msg_fused_matches_unfused(rng):
    """The lifted first dense against the reference layout on the same
    weights (tests/test_models.py:203-220's tolerance on the CPU)."""
    xyz = torch.from_numpy(rng.rand(B, 128, 3).astype(np.float32))
    pts = torch.from_numpy(rng.rand(B, 128, 16).astype(np.float32))
    npoint, radii, nss, mlps = MSG_ARGS
    fused = tnn.SetAbstractionMSG(npoint, radii, nss, 16, mlps).eval()
    plain = tnn.SetAbstractionMSG(npoint, radii, nss, 16, mlps,
                                  fuse_first=False).eval()
    plain.load_state_dict(fused.state_dict(), strict=True)
    with torch.inference_mode(), config.pooled_max(True):
        _, got = fused(xyz, pts)
        _, want = plain(xyz, pts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=3e-5)
