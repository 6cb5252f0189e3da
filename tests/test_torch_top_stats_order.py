"""The pick of row 13's CUDA kernel (csrc/fused_mlp.cu
fused_top_stats_kernel), emulated on the CPU.

The kernel deals a group's rows over the 32 / tx lanes that share a channel
vector (lane ty takes rows ty, ty + lanes, ...), each lane keeps the first
largest z of its rows, and the lanes combine by xor shuffles under
top_better: a NaN beats any number, of two NaNs or two equal numbers the
lower row wins. The emulation below follows that dealing and combine and
must give torch.argmax's first occurrence. On the card test's inputs
(chip_smoke.first_occurrence_case) a combine that prefers the later row,
or a scan that keeps the last tied row, moves T2 past `sum_ok`, so the
card test can fail; and the plain version agrees with JAX's `_top_stats`
(interpret mode) on those inputs.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import chain_terms, first_occurrence_case, sum_ok
from pointnet2_tpu.ops.pallas import fused_mlp as jfm
from pointnet2_tpu_torch.ops import fused_mlp as tfm

VEC = {torch.bfloat16: 8, torch.float32: 4}  # kTopVec: 16 bytes a thread
SRC = (Path(__file__).resolve().parent.parent / "pointnet2_tpu_torch"
       / "csrc" / "fused_mlp.cu").read_text()
TX = int(re.search(r"constexpr int kTopTx = (\d+);", SRC).group(1))
NO_ROW = 2 ** 31 - 1
# the card test's shapes (tests/test_torch_cuda.py)
CARD = [(64, 32, 128), (50, 13, 40), (16, 64, 16)]


def row_lanes(C: int, dtype) -> int:
    """32 / tx: the lanes that split a group's rows (launch_top_stats)."""
    vecs, tx = -(-C // VEC[dtype]), 1
    while tx < vecs and tx < TX:
        tx *= 2
    return 32 // tx


def _z(y, p):
    return torch.relu(y.float() * p[0] + p[1]).to(y.dtype).float()


def better(z, row, m, am, later=False):
    """top_better elementwise; `later` prefers the higher row on ties."""
    tie_row = row > am if later else row < am
    return torch.where(z.isnan(), ~m.isnan() | (m.isnan() & tie_row),
                       ~m.isnan() & ((z > m) | ((z == m) & tie_row)))


def emulate_picks(y, p, lanes: int, later: bool = False,
                  last: bool = False):
    """The kernel's argmax rows (G, C): each lane's ascending scan of its
    rows (`last`: keeping the last tied row), then the xor butterfly over
    the lanes (`later`: preferring the later row on ties)."""
    G, S, C = y.shape
    z = _z(y, p)
    m = torch.full((G, lanes, C), -float("inf"))
    am = torch.full((G, lanes, C), NO_ROW, dtype=torch.int64)
    for row in range(S):
        ty = row % lanes
        zr, mt = z[:, row], m[:, ty]
        keep = zr >= mt if last else zr > mt
        take = keep | (zr.isnan() & ~mt.isnan())
        m[:, ty] = torch.where(take, zr, mt)
        am[:, ty] = torch.where(take, torch.full_like(am[:, ty], row),
                                am[:, ty])
    off = 1
    while off < lanes:
        partner = torch.arange(lanes) ^ off
        zo, ro = m[:, partner], am[:, partner]
        take = better(zo, ro, m, am, later)
        m, am = torch.where(take, zo, m), torch.where(take, ro, am)
        off *= 2
    assert bool((am == am[:, :1]).all())  # every lane ends with the winner
    return am[:, 0]


def totals_of(y, g, p, picks):
    """(T1, T2) in float64 from the f32 terms at the picked rows."""
    yv = y.float().gather(1, picks[:, None]).squeeze(1)
    dout = g.float() * ((yv * p[0] + p[1]) > 0)
    yhat = (yv - p[2]) * p[3]
    return dout.double().sum(0), (dout * yhat).double().sum(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("G,S,C", CARD + [(8, 33, 3), (5, 7, 300)])
def test_emulated_pick_is_first_occurrence(dtype, nan, G, S, C):
    y, _, p = first_occurrence_case(torch, G, S, C, dtype, 7, nan)
    z = _z(y, p)
    got = emulate_picks(y, p, row_lanes(C, dtype))
    assert torch.equal(got, z.argmax(1))
    if nan:  # torch.argmax takes the first NaN, as the kernel does
        first_nan = z.isnan().float().argmax(1)
        has = z.isnan().any(1)
        assert bool(has.any()) and torch.equal(got[has], first_nan[has])


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_emulated_pick_on_integer_bf16_ties(lanes):
    """bf16 y of a few integer values, a = 1, b = 0: most groups' max is
    tied over several rows, some rows negative (z = 0 ties too)."""
    rng = np.random.default_rng(lanes)
    y = torch.from_numpy(rng.integers(-2, 4, (40, 37, 6)).astype(
        np.float32)).bfloat16()
    y[3, 5, 2] = float("nan")
    y[7, 36, 1] = float("nan")
    p = torch.zeros((7, 6))
    p[0] = 1.0
    got = emulate_picks(y, p, lanes)
    assert torch.equal(got, _z(y, p).argmax(1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,S,C", CARD)
def test_wrong_picks_fail_the_card_check(dtype, G, S, C):
    """The first-occurrence pick passes `sum_ok` against the exact sums of
    the plain version's terms; the last tied row fails it, and so does a
    combine that prefers the other lanes' later row wherever lanes > 1."""
    y, g, p = first_occurrence_case(torch, G, S, C, dtype, 7)
    (e1, e2), (a1, a2) = chain_terms(torch, y, g, p, True)
    lanes = row_lanes(C, dtype)

    def passes(picks):
        t1, t2 = totals_of(y, g, p, picks)
        return sum_ok(t1, e1, a1) and sum_ok(t2, e2, a2)

    assert passes(emulate_picks(y, p, lanes))
    assert not passes(emulate_picks(y, p, lanes, last=True))
    if lanes > 1:
        assert not passes(emulate_picks(y, p, lanes, later=True))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("G,S,C", [(64, 32, 128), (16, 64, 16)])
def test_plain_matches_pallas_on_tie_inputs(dtype, nan, G, S, C):
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    y, g, p = first_occurrence_case(torch, G, S, C, td, 7, nan)
    w1, w2 = jax.jit(lambda *v: jfm._top_stats(*v, pool=True))(
        jnp.asarray(y.float().numpy(), jd), jnp.asarray(g.float().numpy(),
                                                        jd),
        jnp.asarray(p.numpy()))
    w1, w2 = (torch.from_numpy(np.array(w, np.float32)).reshape(-1)
              for w in (w1, w2))
    t1, t2 = tfm.top_stats(y, g, p, True)
    assert torch.equal(t1.isnan(), w1.isnan())
    assert torch.equal(t2.isnan(), w2.isnan())
    assert bool(t2.isnan().any()) == nan
    (e1, e2), (a1, a2) = chain_terms(torch, y, g, p, True)
    fin = ~e2.isnan()
    for got in ((t1, t2), (w1, w2)):
        assert sum_ok(got[0], e1, a1)
        assert sum_ok(got[1][fin], e2[fin], a2[fin])
