"""The map of row 15's CUDA kernel (csrc/fused_mlp.cu fused_first_bwd_kernel),
emulated in numpy on the CPU.

A thread owns one 16-byte channel vector (kTopVec: 8 bf16 or 4 f32) at a
channel offset fixed for the launch: tx = min(vectors a row, kFirstThreads)
lanes span a row, the block's kFirstThreads / tx row lanes take neighbouring
rows, blockIdx.y tiles wider rows, and the grid (at most kFirstBlocks row
blocks) strides over rows kFirstRows at a time. The emulation reads those
constants from the source and must touch every element of (R, C) exactly
once, for C in {3, 40, 64, 128, 131}, storage offsets 0 and 1 and R ragged
against the unroll, with every 16-byte access on a 16-byte boundary where
the launch takes them (kVec). The emulated dx (each thread's pack values
held per channel) equals ``first_bwd_plain`` bit for bit, and
``first_bwd_plain`` equals JAX's ``_first_bwd`` (interpret mode), as
tests/test_torch_fused_train.py holds it: f32 within 1e-5 of the largest
magnitude (XLA:CPU may contract a multiply-add), bf16 within one bf16 ulp.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pointnet2_tpu.ops.pallas import fused_mlp as jfm
from pointnet2_tpu_torch.ops import fused_mlp as tfm
from tests.test_torch_fused_mlp import DT, _j, _t
from tests.test_torch_fused_train import _elementwise_close, _pack

SRC = (Path(__file__).resolve().parent.parent / "pointnet2_tpu_torch"
       / "csrc" / "fused_mlp.cu").read_text()


def _const(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", SRC).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


THREADS, ROWS, BLOCKS = (_const(n) for n in ("kFirstThreads", "kFirstRows",
                                             "kFirstBlocks"))
ISZ = {"f32": 4, "bf16": 2}


def launch(R: int, C: int, isz: int, offset: int,
           blocks: int = BLOCKS) -> dict:
    """The launch's grid and route (csrc/fused_mlp.cu launch_first_bwd),
    for x and g `offset` elements into 16-byte aligned storage, with at
    most `blocks` row blocks."""
    V = 16 // isz
    vecs = -(-C // V)
    tx = min(vecs, THREADS)
    per = THREADS // tx * ROWS
    return {"V": V, "tx": tx, "gx": min(-(-R // per), blocks),
            "gy": -(-vecs // tx), "vec": C % V == 0 and offset * isz % 16 == 0}


def walk(R: int, C: int, isz: int, offset: int, blocks: int = BLOCKS):
    """Every (row, first channel, valid channels) a thread of the launch
    handles, in its loop's order, as flat arrays; asserts that each
    16-byte access of the kVec route is aligned."""
    L = launch(R, C, isz, offset, blocks)
    V, tx_lanes, gx = L["V"], L["tx"], L["gx"]
    ty_lanes = THREADS // tx_lanes
    tid = np.arange(THREADS)
    tx, ty = tid % tx_lanes, tid // tx_lanes
    step = gx * ty_lanes
    rows, cols, valids = [], [], []
    for by in range(L["gy"]):
        col = (by * tx_lanes + tx) * V
        valid = np.minimum(V, C - col)
        live = (ty < ty_lanes) & (valid > 0)
        for bx in range(gx):
            r0 = bx * ty_lanes + ty
            it = 0
            while True:
                base = r0 + it * ROWS * step
                if not (live & (base < R)).any():
                    break
                for j in range(ROWS):
                    row = base + j * step
                    ok = live & (row < R)
                    rows.append(row[ok])
                    cols.append(col[ok])
                    valids.append(valid[ok])
                it += 1
    rows, cols, valids = (np.concatenate(a) for a in (rows, cols, valids))
    if L["vec"]:
        assert (valids == V).all()
        addr = (offset + rows.astype(np.int64) * C + cols) * isz
        assert (addr % 16 == 0).all()
    return rows, cols, valids, V


def coverage(R: int, C: int, isz: int, offset: int,
             blocks: int = BLOCKS) -> np.ndarray:
    rows, cols, valids, V = walk(R, C, isz, offset, blocks)
    flat = [rows.astype(np.int64) * C + cols + e for e in range(V)]
    keep = [valids > e for e in range(V)]
    idx = np.concatenate([f[k] for f, k in zip(flat, keep)])
    return np.bincount(idx, minlength=R * C).reshape(R, C)


def emulate(x: torch.Tensor, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """dx of the kernel's walk: each thread's seven pack values, read once
    for its channels, applied op by op in f32 to each of its rows."""
    R, C = x.shape
    isz = x.element_size()
    rows, cols, valids, V = walk(R, C, isz, 0)
    xf, gf, pf = x.float().numpy(), g.float().numpy(), p.numpy()
    out = np.full((R, C), np.nan, np.float32)
    for e in range(V):
        k = valids > e
        r, ch = rows[k], cols[k] + e
        pk = pf[:, ch]  # the thread's registers for channel e
        v, dz = xf[r, ch], gf[r, ch]
        o = v * pk[0] + pk[1]
        dout = dz * np.where(o > 0, np.float32(1), np.float32(0))
        yhat = (v - pk[2]) * pk[3]
        out[r, ch] = pk[4] * ((dout - pk[5]) - yhat * pk[6])
    return torch.from_numpy(out).to(x.dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("C", [3, 40, 64, 128, 131])
@pytest.mark.parametrize("R", [1, 4 * ROWS + 3, 1001])
def test_every_element_once(R, C, offset, dtype):
    assert (coverage(R, C, ISZ[dtype], offset) == 1).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R,C", [(5000, 64), (1001, 131)])
@pytest.mark.parametrize("blocks", [1, 3])
def test_every_element_once_with_a_grid_stride(R, C, blocks, dtype):
    """More rows than the row blocks take in one pass: the grid strides
    (the cap lowered from kFirstBlocks so the stride runs at a small R)."""
    assert launch(R, C, ISZ[dtype], 0, blocks)["gx"] == blocks
    assert (coverage(R, C, ISZ[dtype], 0, blocks) == 1).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_every_element_once_in_channel_tiles(dtype):
    """Rows wider than kFirstThreads vectors: blockIdx.y tiles them."""
    C = 2 * THREADS * 16 // ISZ[dtype] + 5
    assert launch(3, C, ISZ[dtype], 0)["gy"] == 3
    assert (coverage(3, C, ISZ[dtype], 0) == 1).all()


def test_vector_route_only_where_every_row_is_aligned():
    assert launch(64, 64, 2, 0)["vec"] and launch(64, 64, 4, 0)["vec"]
    assert not launch(64, 64, 2, 1)["vec"] and not launch(64, 40, 4, 1)["vec"]
    assert launch(64, 40, 2, 8)["vec"] and not launch(64, 131, 4, 0)["vec"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R,C", [(1, 8), (4 * ROWS + 3, 40), (96, 131),
                                 (256, 64)])
def test_emulated_dx_is_first_bwd_plain(rng, dtype, R, C):
    td, _ = DT[dtype]
    x = _t(rng.randn(R, C), td)
    g = _t(rng.randn(R, C), td)
    p, _ = _pack(rng, C)
    got = emulate(x, g, p)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(tfm.first_bwd_plain(x, g, p)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R,C", [(37, 3), (16, 40), (64, 64), (8, 131)])
def test_first_bwd_plain_matches_pallas(rng, dtype, R, C):
    td, jd = DT[dtype]
    x = _t(rng.randn(R, C), td).float().numpy()
    g = _t(rng.randn(R, C), td).float().numpy()
    p, _ = _pack(rng, C)
    want = jax.jit(jfm._first_bwd)(_j(x, jd), _j(g, jd), _j(p.numpy()))
    got = tfm.first_bwd_plain(_t(x, td), _t(g, td), p)
    assert got.dtype == td and got.shape == (R, C)
    _elementwise_close(got, want, dtype)
