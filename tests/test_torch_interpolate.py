"""The port's three-NN search, interpolation and feature propagation held
against the JAX package on the CPU.

The same numpy inputs (from a seed) go through pointnet2_tpu: three_nn with
impl="xla" and impl="pallas" (the Pallas kernel in interpret mode),
three_interpolate with impl="mxu" (the route the port follows), and
FeaturePropagation on the same weights; and through pointnet2_tpu_torch on
CPU tensors, which take the plain PyTorch version of the CUDA kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import nn as jnn
from pointnet2_tpu import ops as jops
from pointnet2_tpu_torch import flax_to_torch
from pointnet2_tpu_torch import nn as tnn
from pointnet2_tpu_torch import ops as tops
from pointnet2_tpu_torch.ops import interpolate
from tests import golden
from tests.test_torch_model import _jax_init, _randomize

IMPLS = ["xla", "pallas"]


def _grid(n):
    g = np.stack(np.meshgrid(*[np.arange(float(n))] * 3, indexing="ij"), -1)
    return g.reshape(1, n ** 3, 3).astype(np.float32)


def _case(name, rs):
    """(xyz1 unknown, xyz2 known) numpy clouds for one named case."""
    if name == "random":
        return rs.rand(2, 70, 3), rs.rand(2, 33, 3)
    if name == "M=300":  # not a multiple of the TPU's 128 lanes
        return rs.rand(2, 50, 3), rs.rand(2, 300, 3)
    if name == "grid ties":  # integer grids: many exactly equal distances
        return _grid(3) + 0.5, _grid(4)
    if name == "duplicate known points":
        known = rs.rand(1, 6, 3)
        return rs.rand(1, 40, 3), np.concatenate([known, known, known], 1)
    if name == "unknown points in the known set":  # distance exactly 0
        xyz1 = rs.rand(2, 64, 3)
        return xyz1, xyz1[:, rs.permutation(64)[:16]]
    m = int(name[2:])  # "M=1", "M=2", "M=3"
    return rs.rand(2, 20, 3), rs.rand(2, m, 3)


CASES = ["random", "M=300", "grid ties", "duplicate known points",
         "unknown points in the known set", "M=1", "M=2", "M=3"]


def _diffs(xyz1, xyz2):
    d = xyz1[:, :, None, :] - xyz2[:, None, :, :]
    return d[..., 0], d[..., 1], d[..., 2]


def _sq_dist_op_by_op(xyz1, xyz2):
    """(B,N,M) squared distances ((dx*dx + dy*dy) + dz*dz), every operation
    rounded to f32 on its own (numpy contracts nothing): the Pallas
    kernel's arithmetic as the TPU runs it, and the CUDA kernel's."""
    dx, dy, dz = _diffs(xyz1, xyz2)
    return (dx * dx + dy * dy) + dz * dz


def _fma(a, b, c):
    """f32 fused multiply-add a*b + c: the f32 product is exact in f64, so
    only the sum is rounded, to f64 and then to f32 (which differs from one
    fused rounding only where the f64 sum falls on an f32 midpoint)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _sq_dist_contracted(xyz1, xyz2, impl):
    """(B,N,M) squared distances as XLA:CPU contracts them into two fused
    multiply-adds: fma(dz, dz, fma(dy, dy, dx*dx)) in the xla path,
    fma(dz, dz, fma(dx, dx, dy*dy)) in the Pallas interpreter."""
    dx, dy, dz = _diffs(xyz1, xyz2)
    if impl == "xla":
        return _fma(dz, dz, _fma(dy, dy, dx * dx))
    return _fma(dz, dz, _fma(dx, dx, dy * dy))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_three_nn_bit_identical(rng, impl, case):
    """idx bit-identical to JAX (and to the golden stable argsort); dist
    bitwise equal to the op-by-op squared distances at those indices (inf
    in the slots no known point reaches). XLA:CPU contracts the distance
    into fused multiply-adds, in the xla path and in the Pallas
    interpreter alike, so JAX's own CPU distances differ from op-by-op
    rounding in the last bits: JAX's dist is held bitwise to the
    contracted form (or to the op-by-op one, where the CPU has no FMA).
    Both sum three nonnegative terms, each within about 3 roundings
    (u = 2^-24 relative) of the exact sum, so they are held to 8u of each
    other."""
    xyz1, xyz2 = (np.ascontiguousarray(a, np.float32)
                  for a in _case(case, rng))
    wd, wi = (np.asarray(a) for a in jops.three_nn(
        jnp.asarray(xyz1), jnp.asarray(xyz2), impl=impl))
    dist, idx = tops.three_nn(torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    dist, idx = dist.numpy(), idx.numpy()
    np.testing.assert_array_equal(idx, wi)
    np.testing.assert_array_equal(idx, golden.three_nn_np(xyz1, xyz2)[1])
    m = xyz2.shape[1]

    def at_idx(d2):
        out = np.full(dist.shape, np.inf, np.float32)
        out[..., :m] = np.take_along_axis(d2, idx[..., :m], 2)
        return out.view(np.int32)

    want = at_idx(_sq_dist_op_by_op(xyz1, xyz2))
    np.testing.assert_array_equal(dist.view(np.int32), want)
    jax_bits = wd.view(np.int32)
    assert (np.array_equal(jax_bits,
                           at_idx(_sq_dist_contracted(xyz1, xyz2, impl)))
            or np.array_equal(jax_bits, want))
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(dist[fin], wd[fin], rtol=2.0 ** -21, atol=0)


def test_three_nn_contract():
    """Fewer than 3 known points: the missing slots are (inf, 0); M = 0 is
    refused; no gradient flows; N = 0 gives empty outputs."""
    xyz1 = torch.tensor([[[0.0, 0, 0], [1.0, 0, 0]]], requires_grad=True)
    dist, idx = tops.three_nn(xyz1, torch.tensor([[[0.5, 0, 0]]]))
    assert idx.tolist() == [[[0, 0, 0], [0, 0, 0]]]
    assert dist[:, :, 0].tolist() == [[0.25, 0.25]]
    assert torch.isinf(dist[:, :, 1:]).all() and not dist.requires_grad
    with pytest.raises(ValueError, match="M >= 1"):
        tops.three_nn(xyz1, torch.zeros(1, 0, 3))
    dist, idx = tops.three_nn(torch.zeros(1, 0, 3), torch.zeros(1, 4, 3))
    assert dist.shape == idx.shape == (1, 0, 3)


def _interp_inputs(rng, C=8, dtype=np.float32):
    pts = rng.randn(2, 16, C).astype(dtype)
    idx = rng.randint(0, 16, (2, 24, 3)).astype(np.int32)
    idx[:, 3] = [5, 5, 0]  # a repeated neighbour
    w = rng.rand(2, 24, 3).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return pts, idx, w


def test_three_interpolate_f32_matches_mxu(rng):
    pts, idx, w = _interp_inputs(rng)
    want = jops.three_interpolate(jnp.asarray(pts), jnp.asarray(idx),
                                  jnp.asarray(w), impl="mxu")
    got = tops.three_interpolate(torch.from_numpy(pts), torch.from_numpy(idx),
                                 torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_three_interpolate_bf16_matches_mxu(rng):
    """bf16 rows, f32 weights: the gather is exact and the combine f32 on
    both sides, so the f32 result agrees as in f32."""
    pts, idx, w = _interp_inputs(rng)
    pj = jnp.asarray(pts, jnp.bfloat16)
    want = jops.three_interpolate(pj, jnp.asarray(idx), jnp.asarray(w),
                                  impl="mxu")
    pt = torch.tensor(np.asarray(pj.astype(jnp.float32))).bfloat16()
    got = tops.three_interpolate(pt, torch.from_numpy(idx),
                                 torch.from_numpy(w))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_three_interpolate_grads_match_jax_vjp(rng):
    pts, idx, w = _interp_inputs(rng)
    ct = rng.randn(2, 24, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda p, wt: jops.three_interpolate(
        p, jnp.asarray(idx), wt, impl="mxu"), jnp.asarray(pts),
        jnp.asarray(w))
    gp_want, gw_want = vjp(jnp.asarray(ct))
    p = torch.from_numpy(pts).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tops.three_interpolate(p, torch.from_numpy(idx), wt).backward(
        torch.from_numpy(ct))
    for got, want in ((p.grad, gp_want), (wt.grad, gw_want)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_cpu_tensors_launch_no_kernel(rng):
    """On CPU tensors the plain versions run: no kernel is counted."""
    pts, idx, w = _interp_inputs(rng)
    before = {k: f.launches for k, f in tops.KERNELS.items()}
    tops.three_interpolate(torch.from_numpy(pts), torch.from_numpy(idx),
                           torch.from_numpy(w))
    tops.three_nn(torch.rand(1, 5, 3), torch.rand(1, 4, 3))
    assert {k: f.launches for k, f in tops.KERNELS.items()} == before
    assert "three_nn" in tops.KERNELS
    assert interpolate.three_nn_kernel is tops.KERNELS["three_nn"]


# f32: the two sides differ in matmul summation order and in the split
# dense (JAX multiplies the concat's zero blocks and subtracts Dense(0))
F32_TOL = 1e-4


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("skip,M", [(5, 12), (0, 12), (7, 1)])
def test_feature_propagation_matches_jax(rng, dtype, skip, M):
    """With and without points1, and M = 1 (part_seg's FP1: the known set
    is one point, weights [1, 0, 0]). f32 within 1e-4 of the output range;
    bf16 within 2% of it (bf16 rounds a dense before or after its bias
    differently in the two frameworks)."""
    B, N, C2 = 2, 40, 6
    xyz1 = rng.rand(B, N, 3).astype(np.float32)
    xyz2 = (xyz1[:, :M] if M > 1 else np.zeros((B, 1, 3))).astype(np.float32)
    p1 = rng.randn(B, N, skip).astype(np.float32) if skip else None
    p2 = rng.randn(B, M, C2).astype(np.float32)
    args = (jnp.asarray(xyz1), jnp.asarray(xyz2),
            None if p1 is None else jnp.asarray(p1), jnp.asarray(p2))
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    variables = _randomize(_jax_init(jnn.FeaturePropagation((16, 12)), *args),
                           seed=21)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnn.FeaturePropagation((16, 12), dtype=jdt).apply(
            variables, *args), np.float32)
    tdt = torch.bfloat16 if dtype == "bf16" else None
    fp = tnn.FeaturePropagation(C2, skip, (16, 12), dtype=tdt).eval()
    fp.load_state_dict(flax_to_torch(variables, fp), strict=True)
    with torch.inference_mode():
        got = fp(torch.from_numpy(xyz1), torch.from_numpy(xyz2),
                 None if p1 is None else torch.from_numpy(p1),
                 torch.from_numpy(p2))
    assert got.shape == (B, N, 12)
    assert got.dtype == (torch.bfloat16 if tdt else torch.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    tol = F32_TOL if dtype == "f32" else 0.02
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()
