"""The walk of rows 2 and 3's CUDA kernel (csrc/ball_query.cu
ball_query_kernel, row 3 its kWithXyz instance), emulated in numpy on the
CPU.

A block serves kQueryWarps queries of one cloud, stages the cloud in tiles
of kTile points, and each warp walks a tile kLanePts * 32 points an
iteration: the distances of every lane's points first, then one ballot per
32-point chunk in scan order. A warp stops once its query holds nsample
hits, and the block leaves the tile loop once every warp has stopped. The
emulation reads those constants from the source and must give the same
indices and counts as ``ball_query_plain`` and JAX's ``ball_query_pallas``
(interpret mode) bit for bit, at and around the tile edges, with nsample >
N, an empty ball and a ball that holds every point. With grouped xyz the
lane that owns a hit copies its coordinates from the staged tile into its
slot, and the pad slots take the first hit's, read from its tile when it
is found (point 0's, from the first tile, for an empty ball): the
emulated ``grouped`` must equal ``xyz1[b, idx]``
and ``ball_query_group_xyz_plain`` bit for bit (-0.0 included) and JAX's
``query_ball_and_group_xyz(impl="pallas")`` by value (its masked sum turns
-0.0 into +0.0).

Row 4 (ball_query_multi_kernel, one instance a radius count) walks the same
tiles for several radii: every lane's distances once, then per chunk one
ballot for each radius not full yet; the block stops once every radius of
every query is full. Its emulation must give each radius's
indices and counts bit for bit as ``ball_query_plain`` and JAX's
``ball_query_multi_pallas``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import ops as jops
from pointnet2_tpu_torch.ops import grouping

SRC = (Path(__file__).resolve().parent.parent / "pointnet2_tpu_torch"
       / "csrc" / "ball_query.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


WARPS, TILE, LANE_PTS = (_const("kQueryWarps"), _const("kTile"),
                         _const("kLanePts"))
MAX_RADII = _const("kMaxRadii")


def emulate(radius: float, nsample: int, xyz1: np.ndarray,
            xyz2: np.ndarray):
    """(idx, cnt, tiles walked by each block, grouped) of the kernel's
    walk."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    r2 = np.float32(grouping._r2(radius))
    idx = np.zeros((B, M, nsample), np.int32)
    cnt = np.zeros((B, M), np.int32)
    grouped = np.full((B, M, nsample, 3), np.nan, np.float32)
    walked = []
    lanes = np.arange(32)
    for b in range(B):
        for q0 in range(0, M, WARPS):
            qs = range(q0, min(q0 + WARPS, M))
            found = {q: 0 for q in qs}
            first = {q: 0 for q in qs}
            pad = {q: xyz1[b, 0] for q in qs}  # from tile 0
            tiles = 0
            for t0 in range(0, N, TILE):
                tiles += 1
                pts = xyz1[b, t0:t0 + TILE]
                np_ = len(pts)
                for q in qs:
                    qx, qy, qz = xyz2[b, q]
                    base = 0
                    while base < np_ and found[q] < nsample:
                        k = base + np.arange(32 * LANE_PTS)
                        ok = k < np_
                        p = pts[np.minimum(k, np_ - 1)]
                        dx, dy, dz = qx - p[:, 0], qy - p[:, 1], qz - p[:, 2]
                        d2 = (dx * dx + dy * dy) + dz * dz  # f32, no FMA
                        hit = ok & (d2 < r2)
                        for j in range(LANE_PTS):
                            h = hit[32 * j:32 * j + 32]
                            if not h.any():
                                continue
                            if found[q] == 0:
                                first[q] = t0 + base + 32 * j + int(
                                    np.argmax(h))
                                pad[q] = pts[first[q] - t0]  # from the tile
                            slot = found[q] + np.cumsum(h) - 1
                            put = h & (slot < nsample)
                            idx[b, q, slot[put]] = t0 + base + 32 * j \
                                + lanes[put]
                            # each hit's lane: its point from the tile
                            grouped[b, q, slot[put]] = p[32 * j + lanes[put]]
                            found[q] += int(h.sum())
                        base += 32 * LANE_PTS
                if not any(found[q] < nsample for q in qs):
                    break  # __syncthreads_or: every query is full
            walked.append(tiles)
            for q in qs:
                c = min(found[q], nsample)
                idx[b, q, c:] = first[q]
                grouped[b, q, c:] = pad[q]
                cnt[b, q] = c
    return idx, cnt, walked, grouped


def _cloud(rng, B, N, M, empty: bool):
    xyz1 = rng.rand(B, N, 3).astype(np.float32)
    qidx = rng.randint(0, N, (B, M))
    xyz2 = np.stack([xyz1[b][qidx[b]] for b in range(B)])
    if empty:
        xyz2[:, -1] = -3.0  # an empty ball, in the last block
    return xyz1, xyz2


@pytest.mark.parametrize("B,N,M,radius,nsample", [
    (2, TILE - 1, 12, 0.1, 64), (2, TILE, 12, 0.1, 64),
    (2, TILE + 1, 12, 0.1, 64), (1, 2 * TILE - 1, 9, 0.15, 32),
    (1, 2 * TILE, 9, 0.5, 32), (1, 2 * TILE + 1, 9, 0.15, 32),
    (2, 20, 9, 0.5, 32),  # nsample > N
    (2, 1, 5, 0.2, 4),  # N = 1
    (1, 2 * TILE + 7, 10, 2.0, 32),  # every point a hit
])
def test_emulated_walk_bit_identical(rng, B, N, M, radius, nsample):
    full = radius == 2.0
    xyz1, xyz2 = _cloud(rng, B, N, M, empty=not full)
    idx, cnt, walked, _ = emulate(radius, nsample, xyz1, xyz2)
    widx, wcnt = grouping.ball_query_plain(radius, nsample,
                                           torch.from_numpy(xyz1),
                                           torch.from_numpy(xyz2))
    np.testing.assert_array_equal(cnt, wcnt.numpy())
    np.testing.assert_array_equal(idx, widx.numpy())
    jidx, jcnt = jops.query_ball_point(radius, nsample, jnp.asarray(xyz1),
                                       jnp.asarray(xyz2), impl="pallas")
    np.testing.assert_array_equal(cnt, np.asarray(jcnt))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    tiles = -(-N // TILE)
    if full:  # every block is full in the first tile and walks no other
        assert (cnt == nsample).all() and walked == [1] * len(walked)
        return
    assert not cnt[:, -1].any() and not idx[:, -1].any()  # the empty ball
    assert max(walked) == tiles  # the empty ball's block walks every tile
    if radius >= 0.5 and N > TILE:  # the other blocks stop after one
        assert min(walked) == 1


def _signed_zeros(xyz1: np.ndarray) -> np.ndarray:
    """xyz1 with some coordinates set to -0.0 (and points at the origin)."""
    out = xyz1.copy()
    out[:, ::7, 0] = -0.0
    out[:, 3::11, 2] = -0.0
    out[:, 5::13] = -0.0
    return out


@pytest.mark.parametrize("signed_zero", [False, True])
@pytest.mark.parametrize("B,N,M,radius,nsample", [
    (2, TILE - 1, 12, 0.1, 64), (2, TILE, 12, 0.1, 64),
    (2, TILE + 1, 12, 0.1, 64), (1, 2 * TILE + 1, 9, 0.15, 32),
    (2, 20, 9, 0.5, 32),  # nsample > N
    (2, 1, 5, 0.2, 4),  # N = 1
    (1, 2 * TILE + 7, 10, 2.0, 32),  # every point a hit
])
def test_emulated_grouped_xyz(rng, B, N, M, radius, nsample, signed_zero):
    """Row 3: idx and cnt bit for bit as row 2, grouped bit for bit
    xyz1[b, idx] and the plain version, by value JAX's Pallas kernel; the
    last query's ball is empty (unless every point is a hit)."""
    full = radius == 2.0
    xyz1, xyz2 = _cloud(rng, B, N, M, empty=not full)
    if signed_zero:
        xyz1 = _signed_zeros(xyz1)
        assert np.signbit(xyz1).any()
    idx, cnt, _, grouped = emulate(radius, nsample, xyz1, xyz2)
    rows = np.arange(B)[:, None, None]
    want = xyz1[rows, idx]
    np.testing.assert_array_equal(grouped.view(np.int32), want.view(np.int32))
    pidx, pcnt, pgrp = grouping.ball_query_group_xyz_plain(
        radius, nsample, torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(cnt, pcnt.numpy())
    np.testing.assert_array_equal(grouped.view(np.int32),
                                  pgrp.numpy().view(np.int32))
    jidx, jcnt, jgrp = jops.query_ball_and_group_xyz(
        radius, nsample, jnp.asarray(xyz1), jnp.asarray(xyz2), impl="pallas")
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(cnt, np.asarray(jcnt))
    np.testing.assert_array_equal(grouped, np.asarray(jgrp))  # by value
    if not full:
        assert (grouped[:, -1] == xyz1[:, :1]).all()  # point 0's, empty
    if signed_zero and N > 1:
        assert np.signbit(grouped).any()  # copied as -0.0


def emulate_multi(radii, nsamples, xyz1: np.ndarray, xyz2: np.ndarray):
    """(a list of (idx, cnt) per radius, tiles walked by each block) of
    row 4's walk."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    R = len(radii)
    r2 = [np.float32(grouping._r2(r)) for r in radii]
    idx = [np.zeros((B, M, ns), np.int32) for ns in nsamples]
    cnt = [np.zeros((B, M), np.int32) for _ in radii]
    walked = []
    lanes = np.arange(32)
    for b in range(B):
        for q0 in range(0, M, WARPS):
            qs = range(q0, min(q0 + WARPS, M))
            found = {q: [0] * R for q in qs}
            first = {q: [0] * R for q in qs}

            def is_open(q):
                return any(found[q][i] < nsamples[i] for i in range(R))

            tiles = 0
            for t0 in range(0, N, TILE):
                tiles += 1
                pts = xyz1[b, t0:t0 + TILE]
                np_ = len(pts)
                for q in qs:
                    qx, qy, qz = xyz2[b, q]
                    base = 0
                    while base < np_ and is_open(q):
                        k = base + np.arange(32 * LANE_PTS)
                        p = pts[np.minimum(k, np_ - 1)]
                        dx, dy, dz = qx - p[:, 0], qy - p[:, 1], qz - p[:, 2]
                        d2 = (dx * dx + dy * dy) + dz * dz  # f32, no FMA
                        d2[k >= np_] = np.inf  # the +inf padding
                        for j in range(LANE_PTS):
                            dj = d2[32 * j:32 * j + 32]
                            for i in range(R):
                                if found[q][i] >= nsamples[i]:
                                    continue
                                h = dj < r2[i]
                                if not h.any():
                                    continue
                                if found[q][i] == 0:
                                    first[q][i] = t0 + base + 32 * j + int(
                                        np.argmax(h))
                                slot = found[q][i] + np.cumsum(h) - 1
                                put = h & (slot < nsamples[i])
                                idx[i][b, q, slot[put]] = (t0 + base + 32 * j
                                                           + lanes[put])
                                found[q][i] += int(h.sum())
                        base += 32 * LANE_PTS
                if not any(is_open(q) for q in qs):
                    break  # __syncthreads_or: every radius of every query
            walked.append(tiles)
            for q in qs:
                for i in range(R):
                    c = min(found[q][i], nsamples[i])
                    idx[i][b, q, c:] = first[q][i]
                    cnt[i][b, q] = c
    return list(zip(idx, cnt)), walked


@pytest.mark.parametrize("B,N,M,radii,nsamples", [
    (2, 20, 9, (0.5, 0.1, 0.3), (32, 4, 40)),  # unsorted, nsample > N
    (1, TILE - 1, 10, (0.2, 0.2, 0.05), (16, 64, 8)),  # repeated
    (1, TILE + 1, 12, (0.1, 0.2, 0.4), (16, 32, 128)),  # cls_msg SA1's
    (1, 2 * TILE + 1, 9, (0.4, 0.2), (64, 32)),
    (1, 2 * TILE + 7, 9, (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 2.0),
     (4, 8, 8, 16, 16, 32, 32, 64)),  # eight radii, one takes every point
])
def test_emulated_multi_walk_bit_identical(rng, B, N, M, radii, nsamples):
    """Each radius bit for bit the plain ball query and JAX's multi-radius
    Pallas kernel (interpret mode); the last query's ball is empty at every
    radius but 2.0, so its block walks every tile."""
    assert len(radii) <= MAX_RADII
    xyz1, xyz2 = _cloud(rng, B, N, M, empty=True)
    got, walked = emulate_multi(radii, nsamples, xyz1, xyz2)
    jax_out = jops.query_ball_point_multi(radii, nsamples, jnp.asarray(xyz1),
                                          jnp.asarray(xyz2), impl="pallas")
    for (idx, cnt), (jidx, jcnt), r, ns in zip(got, jax_out, radii,
                                               nsamples):
        widx, wcnt = grouping.ball_query_plain(r, ns, torch.from_numpy(xyz1),
                                               torch.from_numpy(xyz2))
        np.testing.assert_array_equal(cnt, wcnt.numpy())
        np.testing.assert_array_equal(idx, widx.numpy())
        np.testing.assert_array_equal(cnt, np.asarray(jcnt))
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        if r < 2.0:  # the empty ball
            assert not cnt[:, -1].any() and not idx[:, -1].any()
    assert max(walked) == -(-N // TILE)
