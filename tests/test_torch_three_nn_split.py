"""The walk of row 9's CUDA kernel (csrc/three_nn.cu three_nn_kernel),
emulated in numpy on the CPU.

A thread owns Q unknown points of one cloud (kQWide where the launch's
unknown points reach kWide, else one) and scans the known points of each
kTile-point tile, padded with +inf points to a whole number of kUnroll
steps, in ascending order. Past kDirect known points it takes them in
batches of kBatch (then kUnroll at the tile's tail): first a bit for each
point whose f = fma(-2qx, px, fma(-2qy, py, fma(-2qz, pz, |p|^2 (1 -
2^-18)))) is not above t = fma(third best, 1 + 2^-18, 2^-100 - |q|^2 (1 -
2^-18)) at the batch's start, then a strict < insertion of those points
alone, with the op-by-op distance, into its three (dist, index)
registers; a point without its bit must not have entered (checked). Up to
kDirect known points every point goes straight to the insertion. The
emulation reads those constants from the source. Both walks must give the
bits of ``three_nn_plain`` and of an op-by-op numpy reference, and JAX's
``three_nn_pallas`` indices (interpret mode; its distances within 2^-21,
since XLA:CPU contracts them into FMAs, ROADMAP parity deltas), at M = 1
to 5, at the edges of a batch, a tile and the direct walk, at an N ragged
against a block's unknown points and N = 1, far from the origin, at tiny
coordinates and on ties; an insertion that let an equal
distance displace an earlier one fails on those ties.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import ops as jops
from pointnet2_tpu_torch.ops import interpolate

SRC = (Path(__file__).resolve().parent.parent / "pointnet2_tpu_torch"
       / "csrc" / "three_nn.cu").read_text()


def _const(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", SRC).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


BLOCK, Q_WIDE, WIDE, BATCH, UNROLL, TILE, DIRECT = (
    _const(n) for n in ("kBlock", "kQWide", "kWide", "kBatch", "kUnroll",
                        "kTile", "kDirect"))


def queries_a_thread(b: int, n: int) -> int:
    """The launch's unknown points a thread (csrc/three_nn.cu
    pn2_three_nn_q with q = 0)."""
    return Q_WIDE if b * n >= WIDE else 1


def insert(dd, ii, d, i, ties_displace: bool = False):
    """(d, i) into the ascending triples (dd, ii) (..., 3), the kernel's
    `insert` on every query at once: strict < on d (`ties_displace`: <=,
    so an equal distance met later takes the earlier one's place)."""

    def less(k):
        return (d <= dd[..., k]) if ties_displace else (d < dd[..., k])

    l0, l1, l2 = less(0), less(1), less(2)
    nd = np.stack([np.where(l0, d, dd[..., 0]),
                   np.where(l0, dd[..., 0], np.where(l1, d, dd[..., 1])),
                   np.where(l1, dd[..., 1], np.where(l2, d, dd[..., 2]))], -1)
    ni = np.stack([np.where(l0, i, ii[..., 0]),
                   np.where(l0, ii[..., 0], np.where(l1, i, ii[..., 1])),
                   np.where(l1, ii[..., 1], np.where(l2, i, ii[..., 2]))], -1)
    return nd.astype(np.float32), ni.astype(np.int32)


def emulate(xyz1: np.ndarray, xyz2: np.ndarray, walk: str,
            ties_displace: bool = False):
    """(dist, idx) of the kernel's walk, "bits" (batches of kBatch, a bit a
    point, then the inserts) or "direct" (every point inserted)."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    dd = np.full((B, N, 3), np.inf, np.float32)
    ii = np.zeros((B, N, 3), np.int32)
    nq = query_term(xyz1)[..., None]
    for base in range(0, M, TILE):
        count = min(TILE, M - base)
        padded = -(-count // UNROLL) * UNROLL
        pts = np.full((B, padded, 3), np.inf, np.float32)
        pts[:, :count] = xyz2[:, base:base + count]
        j0 = 0
        while j0 < (count if walk == "direct" else padded):
            if walk == "direct":
                n_pts = count
            else:  # whole batches, then the tail's steps
                n_pts = BATCH if j0 + BATCH <= padded else UNROLL
            js = j0 + np.arange(n_pts)
            dx, dy, dz = (xyz1[..., None, c] - pts[:, None, js, c]
                          for c in range(3))
            d = (dx * dx + dy * dy) + dz * dz  # (B, N, n_pts) op by op
            if walk == "direct":
                hit = np.ones(d.shape, bool)
            else:  # the bits, at the batch's start
                t = _fma(dd[..., 2:3], np.float32(1 + MARGIN), nq)
                hit = ~(bit_f(xyz1, pts[:, js]) > t)
            for u in range(n_pts):
                nd, ni = insert(dd, ii, d[..., u], np.int32(base + js[u]),
                                ties_displace)
                # a point without its bit would not have entered
                assert np.array_equal(nd[~hit[..., u]], dd[~hit[..., u]])
                h = hit[..., u, None]
                dd = np.where(h, nd, dd)
                ii = np.where(h, ni, ii)
            j0 += n_pts
    return dd, ii


def launch_walk(m: int) -> str:
    """The walk the kernel takes with m known points."""
    return "direct" if m <= DIRECT else "bits"


def _fma(a, b, c):
    """f32 fused multiply-add a*b + c: the f32 product is exact in f64, so
    only the sum is rounded, to f64 and then to f32 (which differs from one
    fused rounding only where the f64 sum falls on an f32 midpoint)."""
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.float64(a) * b + c).astype(np.float32)


MARGIN, HUGE = np.float32(2.0 ** -18), np.float32(2.0 ** 120)


def _norm2(v):
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def query_term(q):
    """2^-100 - |q|^2 (1 - 2^-18) of each unknown point, +inf where |q|^2
    is 2^120 or more (or NaN)."""
    with np.errstate(invalid="ignore", over="ignore"):
        q2 = _norm2(q)
        nq = np.float32(2.0 ** -100) - q2 * (np.float32(1) - MARGIN)
    return np.where(q2 < HUGE, nq, np.float32(np.inf)).astype(np.float32)


def bit_f(q, p):
    """f of each (unknown, known) pair, (..., N, K) for q (..., N, 3) and p
    (..., K, 3): the staged w = |p|^2 (1 - 2^-18) (NaN from 2^120 on) and
    three fmas with a = -2q."""
    with np.errstate(invalid="ignore", over="ignore"):
        p2 = _norm2(p)
        w = np.where(p2 < HUGE, p2 * (np.float32(1) - MARGIN),
                     np.float32(np.nan)).astype(np.float32)[..., None, :]
        a = np.float32(-2) * q[..., :, None, :]
        pp = p[..., None, :, :]
        return _fma(a[..., 0], pp[..., 0], _fma(a[..., 1], pp[..., 1], _fma(
            a[..., 2], pp[..., 2], w)))


def writers(B: int, N: int, Q: int) -> np.ndarray:
    """How often the launch's lanes write each unknown point."""
    hits = np.zeros((B, N), np.int64)
    blocks = -(-N // (BLOCK * Q))
    t = np.arange(BLOCK)
    lane, warp = t % 32, t // 32
    for bx in range(blocks):
        first = (bx * (BLOCK // 32) + warp) * 32 * Q + lane
        for k in range(Q):
            i = first + k * 32
            np.add.at(hits, (slice(None), i[i < N]), 1)
    return hits


def _op_by_op(xyz1, xyz2):
    """The three smallest (dist, index) pairs of op-by-op squared distances,
    by a stable argsort, (+inf, 0) where M < 3."""
    d = xyz1[:, :, None, :] - xyz2[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    order = np.argsort(d2, axis=-1, kind="stable")[..., :3]
    dist = np.full(xyz1.shape[:2] + (3,), np.inf, np.float32)
    idx = np.zeros(xyz1.shape[:2] + (3,), np.int32)
    k = order.shape[-1]
    dist[..., :k] = np.take_along_axis(d2, order, -1)
    idx[..., :k] = order
    return dist, idx


def _grid(n, shift=0.0):
    g = np.stack(np.meshgrid(*[np.arange(float(n))] * 3, indexing="ij"), -1)
    return (g.reshape(1, n ** 3, 3) + shift).astype(np.float32)


def _case(name: str):
    """(xyz1 unknown, xyz2 known) for one named case, from a seed."""
    rs = np.random.RandomState(len(name))
    if name.startswith("M="):  # fewer points than slots, and the edges
        m = int(name[2:])
        return rs.rand(2, 37, 3), rs.rand(2, m, 3)
    if name == "N ragged":  # not a multiple of a block's unknown points
        return rs.rand(3, BLOCK * Q_WIDE + 3, 3), rs.rand(3, 130, 3)
    if name == "N=1":
        return rs.rand(2, 1, 3), rs.rand(2, 90, 3)
    if name == "far from the origin":  # the bit lets many more points in
        return 1000 + rs.rand(2, 40, 3), 1000 + rs.rand(2, 300, 3)
    if name == "tiny coordinates":  # |q|^2 near the bit's 2^-100 term
        return 1e-15 * rs.rand(2, 40, 3), 1e-15 * rs.rand(2, 300, 3)
    if name == "grid ties":  # every distance an exact small integer
        return _grid(3, 0.5), _grid(4)
    if name == "repeated known points":  # equal distances j, j+9, j+18
        known = rs.rand(1, 9, 3)
        return rs.rand(1, 41, 3), np.concatenate([known] * 3, 1)
    if name == "repeated across batches":  # j, j+13, j+26: over kBatch
        known = rs.rand(2, 13, 3)
        return rs.rand(2, 60, 3), np.concatenate([known] * 20, 1)
    if name == "integer cloud":  # coordinates in {0..3}: many ties, dist 0
        return (np.floor(rs.rand(2, 50, 3) * 4),
                np.floor(rs.rand(2, 300, 3) * 4))
    raise KeyError(name)


CASES = ["M=1", "M=2", "M=3", "M=4", "M=5", f"M={BATCH - 1}",
         f"M={BATCH}", f"M={BATCH + 1}", f"M={DIRECT}", f"M={DIRECT + 1}",
         f"M={TILE - 1}", f"M={TILE}", f"M={TILE + 1}", f"M={2 * TILE + 1}",
         "N ragged", "N=1", "far from the origin", "tiny coordinates",
         "grid ties", "repeated known points", "repeated across batches",
         "integer cloud"]
TIES = ["grid ties", "repeated known points", "repeated across batches",
        "integer cloud"]
WALKS = ["bits", "direct"]


@functools.lru_cache(maxsize=None)
def _inputs(name: str):
    xyz1, xyz2 = (np.ascontiguousarray(a, np.float32) for a in _case(name))
    d, i = interpolate.three_nn_plain(torch.from_numpy(xyz1),
                                      torch.from_numpy(xyz2))
    return xyz1, xyz2, d.numpy(), i.numpy()


def test_constants_read_from_the_source():
    assert Q_WIDE >= 1 and TILE % BATCH == 0 and DIRECT <= TILE
    assert BATCH % UNROLL == 0
    assert BATCH <= 32  # one bit a point


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("case", CASES)
def test_split_walk_is_bit_identical_to_plain(case, walk):
    """Both walks, every case: the plain version's dist bits and indices,
    and the op-by-op stable reference's."""
    xyz1, xyz2, wd, wi = _inputs(case)
    dist, idx = emulate(xyz1, xyz2, walk)
    np.testing.assert_array_equal(idx, wi)
    np.testing.assert_array_equal(dist.view(np.int32), wd.view(np.int32))
    rd, ri = _op_by_op(xyz1, xyz2)
    np.testing.assert_array_equal(idx, ri)
    np.testing.assert_array_equal(dist.view(np.int32), rd.view(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_launch_split_matches_jax_pallas(case):
    """The walk the launch takes at this M: JAX's three_nn_pallas indices
    bit for bit, its distances within 2^-21 (XLA:CPU contracts them), the
    slots past M at (+inf, 0) in both."""
    xyz1, xyz2, _, _ = _inputs(case)
    dist, idx = emulate(xyz1, xyz2, launch_walk(xyz2.shape[1]))
    jd, ji = (np.asarray(a) for a in jops.three_nn(
        jnp.asarray(xyz1), jnp.asarray(xyz2), impl="pallas"))
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(dist[fin], jd[fin], rtol=2.0 ** -21, atol=0)


# (B, N, M) of every FP layer at B=16: sem_seg FP4-FP1, part_seg FP3-FP1
FP_SHAPES = [(16, 8192, 1024), (16, 1024, 256), (16, 256, 64), (16, 64, 16),
             (16, 2048, 512), (16, 512, 128), (16, 128, 1)]


@pytest.mark.parametrize("B,N,M", FP_SHAPES + [(2, BLOCK * Q_WIDE + 3, 130),
                                              (40, BLOCK * Q_WIDE * 7 + 5, 9),
                                              (1, 1, 1)])
def test_every_unknown_point_written_once(B, N, M):
    """The launch's map (blocks of kBlock * Q unknown points, point k of
    lane l of a warp at k * 32 + l) writes every unknown point exactly
    once, at the FP layers' shapes and at a ragged N, with the launch's Q
    and with the other."""
    assert (writers(B, N, queries_a_thread(B, N)) == 1).all()
    for q in (1, Q_WIDE):
        assert (writers(1, N, q) == 1).all()


def test_shapes_of_the_fp_layers():
    """kQWide unknown points a thread only where they fill the card
    (sem_seg FP4); the direct walk at sem_seg FP1-FP2 and part_seg FP1,
    the bits elsewhere."""
    q = {shape: queries_a_thread(*shape[:2]) for shape in FP_SHAPES}
    assert q.pop((16, 8192, 1024)) == Q_WIDE and set(q.values()) == {1}
    walks = {shape: launch_walk(shape[2]) for shape in FP_SHAPES}
    assert [s for s, w in walks.items() if w == "direct"] == [
        (16, 256, 64), (16, 64, 16), (16, 128, 1)]


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("case", TIES)
def test_ties_displacing_fails_on_ties(case, walk):
    """The tie inputs hold equal distances at different indices (within a
    batch and across batches): an insertion that let a later equal
    distance take an earlier one's place gives other indices, so the card
    test on these inputs can fail."""
    xyz1, xyz2, _, wi = _inputs(case)
    assert not np.array_equal(emulate(xyz1, xyz2, walk, True)[1], wi)


def test_ties_cross_batches():
    """"repeated across batches" ties an unknown point's nearest copies at
    j, j + 13, j + 26, some of them in different batches of kBatch."""
    xyz1, xyz2, wd, wi = _inputs("repeated across batches")
    tie = wd[..., 0] == wd[..., 2]
    assert tie.all()
    assert (wi[..., 0] // BATCH != wi[..., 2] // BATCH).any()


@pytest.mark.parametrize("centre,scale", [(0.0, 1.0), (0.0, 1e-3),
                                          (100.0, 1.0), (-3e4, 10.0),
                                          (0.0, 3e-20), (0.0, 1e-22),
                                          (1e19, 1e18)])
def test_the_bit_holds_every_point_that_enters(centre, scale):
    """The bit's bound on random pairs, near and far from the origin,
    subnormal, and past 2^120: with the third best just above sq_dist's e
    (the tightest d2 that lets the point enter), f never passes t. Without
    the margin (t = d2 - |q|^2, f from |p|^2 itself), some pairs near the
    origin would lose their bit, so the margin is needed."""
    rs = np.random.RandomState(10)
    q = (centre + rs.rand(20000, 1, 3) * scale).astype(np.float32)
    p = (centre + rs.rand(20000, 1, 3) * scale).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        e = _norm2(q - p)[:, 0]
        d2 = np.nextafter(e, np.float32(np.inf))
        t = _fma(d2, np.float32(1 + MARGIN), query_term(q)[:, 0])
        f = bit_f(q, p)[:, 0, 0]
        assert not (f > t).any()
        if (centre, scale) == (0.0, 1.0):
            a = np.float32(-2) * q[:, 0]
            bare = _fma(a[:, 0], p[:, 0, 0], _fma(a[:, 1], p[:, 0, 1], _fma(
                a[:, 2], p[:, 0, 2], _norm2(p)[:, 0])))
            assert (bare > d2 - _norm2(q)[:, 0]).any()
