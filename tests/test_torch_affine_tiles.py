"""The map of row 12's CUDA kernel (csrc/fused_mlp.cu fused_affine_kernel),
emulated in numpy on the CPU.

Rows 12 and 15 share one walk (``channel_walk``) and one launch
(``launch_channel_pass``), so the emulated map of
tests/test_torch_first_bwd_tiles.py (``launch``, ``walk``, ``coverage``,
its constants read from the source) is row 12's too; this file checks that
both launchers go through them. The map must touch every element of (R, C)
exactly once, for C in {3, 40, 64, 128, 131, 256}, storage offsets 0 and 1,
R ragged against kFirstRows and a grid that strides, with every 16-byte
access aligned where the launch takes the vector route. The emulated
output (each thread's a and b held for its channels, y*a + b rounded
twice, the ReLU, the cast to T) equals ``affine_fwd_plain`` bit for bit,
and ``affine_fwd_plain`` equals JAX's ``_affine_fwd`` (interpret mode) as
tests/test_torch_fused_mlp.py holds it: f32 within 1e-5 relative (XLA:CPU
may contract a multiply-add), bf16 within one bf16 ulp.
"""

import re

import jax
import numpy as np
import pytest
import torch

from pointnet2_tpu.ops.pallas import fused_mlp as jfm
from pointnet2_tpu_torch.ops import fused_mlp as tfm
from tests.test_torch_first_bwd_tiles import (BLOCKS, ISZ, ROWS, SRC, THREADS,
                                              _bits, coverage, launch, walk)
from tests.test_torch_fused_mlp import DT, _affine, _assert_step_close, _j, _t


def emulate(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            offset: int = 0) -> torch.Tensor:
    """out of the kernel's walk: each thread's a and b, read once for its
    channels, applied op by op in f32 to each of its rows, then cast."""
    R, C = y.shape
    rows, cols, valids, V = walk(R, C, y.element_size(), offset)
    yf, af, bf = y.float().numpy(), a.numpy(), b.numpy()
    out = np.full((R, C), np.nan, np.float32)
    for e in range(V):
        k = valids > e
        r, ch = rows[k], cols[k] + e
        o = yf[r, ch] * af[ch] + bf[ch]  # two roundings, as the kernel
        out[r, ch] = np.where(o < 0, np.float32(0), o)  # keeps NaN, -0.0
    return torch.from_numpy(out).to(y.dtype)


def _launcher(entry: str) -> str:
    """The body of the C launcher `entry` (up to its closing brace)."""
    start = SRC.index(entry)
    return SRC[start:SRC.index("\n}\n", start)]


def test_rows_12_and_15_share_the_walk_and_the_launch():
    """The emulated map is the kernel's for both rows: each kernel body is
    the one walk, each launcher the one launch."""
    for kernel in ("fused_affine_kernel", "fused_first_bwd_kernel"):
        body = re.search(rf"{kernel}\(const ChannelPass.*?\n}}\n", SRC,
                         re.S).group(0)
        assert "channel_walk<T, kVec>(" in body
    for launcher in ("cudaError_t launch_affine(",
                     "cudaError_t launch_first_bwd("):
        assert "launch_channel_pass(" in _launcher(launcher)
    assert "t % c" not in SRC and "% c)" not in SRC


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("C", [3, 40, 64, 128, 131, 256])
@pytest.mark.parametrize("R", [1, 4 * ROWS + 3, 1001])
def test_every_element_once(R, C, offset, dtype):
    assert (coverage(R, C, ISZ[dtype], offset) == 1).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R,C", [(5000, 3), (3001, 256)])
def test_every_element_once_with_a_grid_stride(R, C, dtype):
    """More rows than the row blocks take in one pass (the cap lowered
    from kFirstBlocks so the stride runs at a small R)."""
    assert launch(R, C, ISZ[dtype], 0, 2)["gx"] == 2 < BLOCKS
    assert (coverage(R, C, ISZ[dtype], 0, 2) == 1).all()


def test_vector_route_only_where_every_row_is_aligned():
    """16-byte pieces only where C is a multiple of the vector and the
    base is on a 16-byte boundary; the cls_ssg shapes take them."""
    assert launch(262144, 128, 2, 0)["vec"]
    assert launch(131072, 256, 4, 0)["vec"]
    assert not launch(64, 256, 2, 1)["vec"]
    assert not launch(64, 131, 2, 0)["vec"]
    assert not launch(64, 3, 4, 0)["vec"] and launch(64, 40, 2, 8)["vec"]
    assert launch(8, 2 * THREADS * 8, 2, 0)["gy"] == 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("R,C", [(1, 8), (4 * ROWS + 3, 40), (96, 131),
                                 (256, 64), (33, 256)])
def test_emulated_out_is_affine_fwd_plain(rng, dtype, offset, R, C):
    td, _ = DT[dtype]
    y = rng.randn(R, C).astype(np.float32)
    y.flat[::23] = np.inf
    y.flat[1::23] = -np.inf
    y.flat[2::29] = np.nan
    y = _t(y, td)
    a, b = (_t(v) for v in _affine(rng, C))
    got, want = emulate(y, a, b, offset), tfm.affine_fwd_plain(y, a, b)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan) and nan.any()
    np.testing.assert_array_equal(_bits(got)[~nan.numpy()],
                                  _bits(want)[~nan.numpy()])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R,C", [(37, 3), (16, 40), (64, 64), (8, 131),
                                 (5, 256)])
def test_affine_fwd_plain_matches_pallas(rng, dtype, R, C):
    td, jd = DT[dtype]
    y = _t(rng.randn(R, C), td).float().numpy()
    a, b = _affine(rng, C)
    want = jax.jit(jfm._affine_fwd)(_j(y, jd), _j(a), _j(b))
    got = tfm.affine_fwd_plain(_t(y, td), _t(a), _t(b))
    assert got.dtype == td and got.shape == (R, C)
    _assert_step_close(got, want, dtype)
