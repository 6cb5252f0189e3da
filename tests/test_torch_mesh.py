"""The port's ``prob_sample`` and mesh sampler (``ops/mesh.py``) against
the JAX package's, on the same numpy inputs and the same random draws.

- ``prob_sample``: bit for bit on weights whose float32 prefix sums are
  exact (small integers, dyadic values), where every summation order
  agrees. On random weights ``torch.cumsum`` and XLA's cumsum round
  differently, so an index may differ only where its draw lies within the
  two prefix sums' difference of a boundary; such cases are counted and
  must stay rare.
- ``triangle_areas`` within 1e-6 relative.
- ``sample_mesh`` given JAX's own (r, u, v) draws (``jax.random.split(key,
  3)`` as pointnet2_tpu/ops/mesh.py does): the triangle picks equal
  wherever ``prob_sample`` agrees, the points within 1e-6, and the FPS
  reduction's indices bit for bit JAX's on the same points.
- Ports of tests/test_ops_mesh.py's checks: areas, points on the surface,
  area-proportional picks, the FPS reduction, independent meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.ops import farthest_point_sample as jfps
from pointnet2_tpu.ops import prob_sample as jprob
from pointnet2_tpu.ops import sample_mesh as jsample
from pointnet2_tpu.ops import triangle_areas as jareas
from pointnet2_tpu_torch.ops import (
    farthest_point_sample,
    prob_sample,
    sample_mesh,
    triangle_areas,
)


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread leaves the cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _right_triangles():
    # two disjoint right triangles in the z=0 and z=1 planes, areas 0.5, 4.5
    t0 = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    t1 = [[0, 0, 1], [3, 0, 1], [0, 3, 1]]
    return np.array([[t0, t1]], np.float32)  # (1, 2, 3, 3)


def _random_mesh(B, T, seed):
    return np.random.default_rng(seed).normal(size=(B, T, 3, 3)).astype(
        np.float32)


def _jax_draws(key, B, S):
    """The (r, u, v) uniforms JAX's sample_mesh draws from ``key``."""
    k_tri, k_u, k_v = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.uniform(k, (B, S), jnp.float32))
                 for k in (k_tri, k_u, k_v))


# ---------------------------------------------------------------------------
# prob_sample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["integers", "dyadic"])
@pytest.mark.parametrize("B,N,M", [(2, 20, 64), (3, 1000, 500),
                                   (1, 4096, 2048)])
def test_prob_sample_bit_identical_on_exact_sums(kind, B, N, M):
    rng = np.random.default_rng(N)
    if kind == "integers":
        w = rng.integers(0, 6, (B, N)).astype(np.float32)
    else:  # multiples of 1/8 below 4: exact prefix sums below 2^24
        w = (rng.integers(0, 32, (B, N)) / 8.0).astype(np.float32)
    w[:, 0] += 1.0  # a positive total
    r = rng.random((B, M), dtype=np.float32)
    want = np.asarray(jprob(jnp.asarray(w), jnp.asarray(r)))
    got = prob_sample(_t(w), _t(r)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [20, 1000, 20000])
def test_prob_sample_random_weights_within_the_cumsum_gap(N):
    B, M = 2, 4000
    rng = np.random.default_rng(N + 1)
    w = rng.random((B, N), dtype=np.float32)
    r = rng.random((B, M), dtype=np.float32)
    want = np.asarray(jprob(jnp.asarray(w), jnp.asarray(r)))
    got = prob_sample(_t(w), _t(r)).numpy()
    cs_j = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=1))(w),
                      np.float64)
    cs_t = torch.cumsum(_t(w), dim=1).numpy().astype(np.float64)
    q_j = r.astype(np.float64) * cs_j[:, -1:].astype(np.float32)
    gap = np.abs(cs_j - cs_t).max() + np.abs(cs_j[:, -1] - cs_t[:, -1]).max()
    differ = np.argwhere(got != want)
    for b, m in differ:
        lo = min(got[b, m], want[b, m])
        assert abs(int(got[b, m]) - int(want[b, m])) == 1
        assert abs(q_j[b, m] - cs_j[b, lo]) <= gap + 1e-6 * cs_j[b, -1]
    # the gap grows with N (9.5e-7 at N=20, 1.2e-2 at N=100000 on a CPU):
    # draws that close to a boundary stay rare
    assert len(differ) <= max(2, B * M // 500), len(differ)


def test_prob_sample_clamps_and_skips_zero_weights():
    w = np.array([[0, 0, 1, 0, 2, 0]], np.float32)
    r = np.array([[0.0, 0.1, 0.33, 0.34, 0.999, 0.9999999]], np.float32)
    want = np.asarray(jprob(jnp.asarray(w), jnp.asarray(r)))
    got = prob_sample(_t(w), _t(r)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got[0].tolist()) <= {0, 2, 4}


# ---------------------------------------------------------------------------
# triangle_areas and sample_mesh
# ---------------------------------------------------------------------------


def test_triangle_areas_match_jax():
    tris = _random_mesh(3, 50, 0)
    tris[0, 0] = tris[0, 0, 0]  # a degenerate triangle keeps a tiny weight
    want = np.asarray(jareas(jnp.asarray(tris)))
    got = triangle_areas(_t(tris)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(triangle_areas(_t(_right_triangles())).numpy(),
                               [[1.0, 9.0]], rtol=1e-5)


@pytest.mark.parametrize("B,T,S,seed", [(1, 2, 512, 0), (2, 40, 1024, 1),
                                        (3, 200, 256, 2)])
def test_sample_mesh_with_jax_draws(B, T, S, seed):
    tris = _right_triangles() if T == 2 else _random_mesh(B, T, seed)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, B, S)
    want = np.asarray(jsample(jnp.asarray(tris), S, key))
    got = sample_mesh(_t(tris), S, uniforms=tuple(_t(d) for d in draws))
    assert got.shape == (B, S, 3)
    picks_j = np.asarray(jprob(jareas(jnp.asarray(tris)),
                               jnp.asarray(draws[0])))
    picks_t = prob_sample(triangle_areas(_t(tris)), _t(draws[0])).numpy()
    same = picks_j == picks_t
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("S,npoint", [(1024, 128), (2048, 1024)])
def test_sample_mesh_fps_reduction_bit_identical(S, npoint):
    tris = _random_mesh(2, 30, 3)
    key = jax.random.PRNGKey(7)
    dense = np.asarray(jsample(jnp.asarray(tris), S, key))
    want = np.asarray(jfps(jnp.asarray(dense), npoint))
    got = farthest_point_sample(_t(dense), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    # the reduction inside sample_mesh: FPS of its own dense draws
    draws = tuple(_t(d) for d in _jax_draws(key, 2, S))
    ours = sample_mesh(_t(tris), S, uniforms=draws)
    reduced = sample_mesh(_t(tris), S, npoint=npoint, uniforms=draws)
    idx = farthest_point_sample(ours, npoint).long()
    assert torch.equal(reduced, ours[torch.arange(2)[:, None], idx])


def test_samples_lie_on_surface():
    pts = sample_mesh(_t(_right_triangles()), 512,
                      torch.Generator().manual_seed(0)).numpy()
    assert pts.shape == (1, 512, 3)
    z = pts[0, :, 2]
    on0, on1 = np.isclose(z, 0.0), np.isclose(z, 1.0)
    assert np.all(on0 | on1)
    x, y = pts[0, :, 0], pts[0, :, 1]
    assert np.all(x >= -1e-6) and np.all(y >= -1e-6)
    assert np.all(x[on0] + y[on0] <= 1 + 1e-5)
    assert np.all(x[on1] + y[on1] <= 3 + 1e-5)


def test_area_proportional_selection():
    pts = sample_mesh(_t(_right_triangles()), 4096,
                      torch.Generator().manual_seed(1)).numpy()
    frac_big = np.mean(np.isclose(pts[0, :, 2], 1.0))
    assert 0.85 < frac_big < 0.95  # 9x the area: about 0.9 of the draws


def test_fps_reduction_keeps_both_planes():
    reduced = sample_mesh(_t(_right_triangles()), 1024,
                          torch.Generator().manual_seed(2),
                          npoint=128).numpy()
    assert reduced.shape == (1, 128, 3)
    z = reduced[0, :, 2]
    assert np.any(np.isclose(z, 0.0)) and np.any(np.isclose(z, 1.0))


def test_batched_meshes_independent():
    tris = np.concatenate([_right_triangles(), _right_triangles() + 10.0], 0)
    pts = sample_mesh(_t(tris), 256, torch.Generator().manual_seed(3))
    assert pts.shape == (2, 256, 3)
    assert (pts[0] < 5.0).all() and (pts[1] > 5.0).all()


def test_generator_draws_are_reproducible():
    tris = _t(_random_mesh(2, 10, 4))
    a = sample_mesh(tris, 300, torch.Generator().manual_seed(5), npoint=20)
    b = sample_mesh(tris, 300, torch.Generator().manual_seed(5), npoint=20)
    assert torch.equal(a, b)
