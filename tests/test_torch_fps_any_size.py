"""FPS at any cloud size: the port against the JAX package above one CTA's
16384 points, and a numpy model of csrc/fps.cu's thread-block-cluster
route.

- ``farthest_point_sample`` on the CPU (the plain version) at 16385,
  40000 and 70000 points, bit for bit JAX's (its XLA route on the CPU).
- The cluster route's reduction tree in numpy: C CTAs a cloud, CTA r on
  the contiguous slice [r*S, min(N, (r+1)*S)) with S = ceil(N / C), thread
  t of a CTA on its slice's points t, t + 1024, ... (ascending, the first
  real point replacing the (0, INT_MAX) sentinel, then a strict >), then
  the warps, the CTA and the cluster merged by (largest distance bits,
  lowest index), the pick's coordinates carried with the winning partial.
  For C in {2, 4, 8, 16} it equals ``fps_plain`` on random clouds, on a
  lattice and on copies of one point placed in different slices.
- ``sample_mesh`` with 20000 draws reduced to 1024 points: FPS bit for
  bit JAX's on JAX's draws, and the reduction FPS of the port's own draws.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.ops import farthest_point_sample as jfps
from pointnet2_tpu.ops import sample_mesh as jsample
from pointnet2_tpu_torch.ops import farthest_point_sample, sample_mesh
from pointnet2_tpu_torch.ops import sampling

INT_MAX = 2 ** 31 - 1
FPS_CU = (Path(__file__).resolve().parent.parent / "pointnet2_tpu_torch"
          / "csrc" / "fps.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", FPS_CU).group(1))


BLOCK = _const("kClusterBlock")
WARP = 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B,N,npoint,seed", [(1, 16385, 48, 0),
                                             (2, 40000, 32, 1),
                                             (1, 70000, 16, 2)])
def test_fps_above_one_cta_matches_jax(B, N, npoint, seed):
    xyz = np.random.default_rng(seed).normal(size=(B, N, 3)).astype(
        np.float32)
    want = np.asarray(jfps(jnp.asarray(xyz), npoint))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)


def test_route_and_its_constants():
    """The wrapper's route table is csrc/fps.cu's: C the smallest power of
    two from 2 with ceil(N / C) <= 16384, the scratch above 16 x 16384."""
    assert sampling.CTA_POINTS == BLOCK * _const("kSlicePerThread") == 16384
    assert sampling.MAX_CLUSTER == _const("kMaxCluster") == 16
    cases = {1: ("cta", 1), 16384: ("cta", 1), 16385: ("cluster", 2),
             32768: ("cluster", 2), 32769: ("cluster", 4),
             65537: ("cluster", 8), 131073: ("cluster", 16),
             262144: ("cluster", 16), 262145: ("scratch", 16),
             1_000_000: ("scratch", 16)}
    for n, route in cases.items():
        assert sampling.fps_route(n) == route
        c = route[1]
        if route[0] == "cluster":
            assert -(-n // c) <= 16384
            assert c == 2 or -(-n // (c // 2)) > 16384


def _sq_dist(xyz, p):
    """((dx*dx + dy*dy) + dz*dz) in float32, each operation rounded: the
    order of csrc/common.cuh's sq_dist and of fps_plain."""
    d = xyz - p
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _merge(bits, idx, pts, axis):
    """Partials merged along ``axis`` by (largest bits, lowest index),
    the winner's coordinates carried with it."""
    top = bits.max(axis, keepdims=True)
    cand = np.where(bits == top, idx, INT_MAX)
    win = cand.argmin(axis)[..., None]
    take = lambda a: np.take_along_axis(  # noqa: E731
        np.moveaxis(a, axis, -1), win, -1)[..., 0]
    return take(bits), take(idx), np.stack(
        [take(pts[..., q]) for q in range(3)], -1)


def cluster_fps(xyz: np.ndarray, npoint: int, c: int) -> np.ndarray:
    """The cluster route's picks for one cloud xyz (N, 3) float32 over c
    CTAs of BLOCK threads."""
    n = len(xyz)
    s = -(-n // c)
    per = -(-s // BLOCK)  # points a thread
    local = np.arange(per)[:, None] * BLOCK + np.arange(BLOCK)  # (per, T)
    gidx = np.arange(c)[:, None, None] * s + local  # (c, per, T)
    real = (local < s) & (gidx < n)
    safe = np.where(real, gidx, 0)
    idx = np.where(real, gidx, INT_MAX)
    pts = np.where(real[..., None], xyz[safe], np.float32(0))
    dmin = np.full(n, 1e38, np.float32)
    out, last = [0], xyz[0]
    for _ in range(1, npoint):
        dmin = np.minimum(dmin, _sq_dist(xyz, last))
        bits = np.where(real, dmin.view(np.uint32)[safe], 0)
        # a thread's scan over ascending points: the first of its largest
        # bits (real points precede the padding, so a real one if any)
        j = bits.argmax(1)[:, None]
        tb = np.take_along_axis(bits, j, 1)[:, 0]  # (c, T)
        ti = np.take_along_axis(idx, j, 1)[:, 0]
        tp = np.take_along_axis(pts, j[..., None], 1)[:, 0]  # (c, T, 3)
        warps = BLOCK // WARP
        wb, wi, wp = _merge(tb.reshape(c, warps, WARP),
                            ti.reshape(c, warps, WARP),
                            tp.reshape(c, warps, WARP, 3), 2)
        cb, ci, cp = _merge(wb, wi, wp, 1)  # warp 0: the CTA's partial
        _, pick, coords = _merge(cb[None], ci[None], cp[None], 1)
        out.append(int(pick[0]))
        last = coords[0]
    return np.array(out, np.int32)


def _clouds():
    rng = np.random.default_rng(5)
    lattice = np.stack(np.meshgrid(*[np.arange(30.0)] * 3, indexing="ij"),
                       -1).reshape(-1, 3).astype(np.float32)  # 27000
    dup = rng.uniform(0, 1, (20000, 3)).astype(np.float32)
    # one far point and one middle point, each copied into several
    # slices (of 10000, 5000, 2500 and 1250 points at C = 2 ... 16)
    dup[[19999, 9000, 3000, 11000]] = 4.0
    dup[[17500, 600, 6400]] = (-2.0, 0.5, 0.5)
    return {"random": rng.normal(size=(17000, 3)).astype(np.float32),
            "lattice": lattice, "copies across slices": dup}


@pytest.mark.parametrize("c", [2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["random", "lattice",
                                  "copies across slices"])
def test_cluster_merge_model_equals_plain(kind, c):
    xyz = _clouds()[kind]
    npoint = 24
    want = sampling.fps_plain(torch.from_numpy(xyz)[None], npoint)[0]
    got = cluster_fps(xyz, npoint, c)
    np.testing.assert_array_equal(got, want.numpy())
    if kind == "copies across slices":
        assert got[1] == 3000  # the lowest of the far point's copies


def test_identical_points_pick_zero():
    xyz = np.full((40000, 3), 0.25, np.float32)
    assert not cluster_fps(xyz, 8, 4).any()
    assert not farthest_point_sample(torch.from_numpy(xyz)[None], 8).any()


def test_sample_mesh_20000_draws_to_1024_matches_jax():
    """As tests/test_torch_mesh.py holds the FPS reduction: JAX's draws
    reduced by the port's FPS bit for bit JAX's, and the port's reduction
    the FPS subset of its own draws on the same (r, u, v) uniforms."""
    S, npoint = 20000, 1024
    tris = np.random.default_rng(3).normal(size=(2, 30, 3, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    dense = np.array(jsample(jnp.asarray(tris), S, key))
    want = np.asarray(jfps(jnp.asarray(dense), npoint))
    got = farthest_point_sample(torch.from_numpy(dense), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    reduced_j = np.asarray(jsample(jnp.asarray(tris), S, key, npoint=npoint))
    np.testing.assert_array_equal(reduced_j,
                                  dense[np.arange(2)[:, None], want])
    draws = tuple(torch.from_numpy(np.array(
        jax.random.uniform(k, (2, S), jnp.float32)))
        for k in jax.random.split(key, 3))
    ours = sample_mesh(torch.from_numpy(tris), S, uniforms=draws)
    reduced = sample_mesh(torch.from_numpy(tris), S, npoint=npoint,
                          uniforms=draws)
    idx = farthest_point_sample(ours, npoint).long()
    assert reduced.shape == (2, npoint, 3)
    assert torch.equal(reduced, ours[torch.arange(2)[:, None], idx])
