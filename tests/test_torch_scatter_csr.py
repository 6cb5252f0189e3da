"""The CSR layout of the port's scatter-add (csrc/scatter.cu) on the CPU.

The kernel sorts each cloud's indices by destination row into CSR (row
offsets, then each row's k in ascending order) and sums each row's terms
one after another. Its plain counterparts in ops/grouping.py,
`scatter_csr_plain` (a stable argsort and a bincount) and
`scatter_rows_csr_plain` (the segmented sum over that CSR), are held here
to the layout's invariants, bit for bit to `scatter_rows_plain`
(Tensor.index_add_, which adds in the same order), and to the JAX package's
Pallas scatter-add in interpret mode within test_torch_ops.py's tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu.ops.pallas import group as jgroup
from pointnet2_tpu_torch.ops import grouping

# (B, K, n, C, kind): kind picks the indices
CASES = {
    "duplicates": (2, 300, 64, 64, "dups"),
    "C=3": (2, 300, 64, 3, "dups"),
    "C=5": (2, 300, 64, 5, "dups"),
    "hot row": (2, 300, 64, 8, "hot"),
    "K=0": (2, 0, 64, 4, "dups"),
    "all out of range": (2, 100, 16, 4, "oob"),
    "n=1": (3, 77, 1, 6, "dups"),
}


def _case(rng, B, K, n, C, kind):
    """g (B, K, C) f32 and idx (B, K) int32. dups: indices from a quarter
    of the rows with a hot row and out-of-range -1 and n sprinkled in (as
    test_torch_ops.py's scatter case); hot: every index on row 7 but a few
    out of range; oob: every index outside [0, n)."""
    g = rng.randn(B, K, C).astype(np.float32)
    if kind == "oob":
        idx = rng.choice([-5, -1, n, n + 3], (B, K))
    elif kind == "hot":
        idx = np.full((B, K), 7)
        idx[:, 4::31] = n
    else:
        idx = rng.randint(0, max(n // 4, 1), (B, K))
        idx[:, ::7] = min(1, n - 1)
        idx[:, 3::11] = -1
        idx[:, 5::13] = n
    return torch.from_numpy(g), torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_csr_sum_equals_plain_scatter_bitwise(rng, case, dtype):
    B, K, n, C, kind = CASES[case]
    g, idx = _case(rng, B, K, n, C, kind)
    g = g.to(dtype)
    off, perm = grouping.scatter_csr_plain(idx, n)
    got = grouping.scatter_rows_csr_plain(g, off, perm, n)
    want = grouping.scatter_rows_plain(g, idx, n)
    assert got.dtype == dtype and got.shape == (B, n, C)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))


@pytest.mark.parametrize("case", list(CASES))
def test_csr_layout(rng, case):
    """Offsets start at 0 and never fall; row j's span of perm holds
    exactly the k with idx == j, ascending; the tail holds the
    out-of-range k, ascending; perm is a permutation of range(K)."""
    B, K, n, C, kind = CASES[case]
    _, idx = _case(rng, B, K, n, C, kind)
    off, perm = grouping.scatter_csr_plain(idx, n)
    assert off.dtype == perm.dtype == torch.int32
    assert off.shape == (B, n + 1) and perm.shape == (B, K)
    for b in range(B):
        o, p, ix = off[b].tolist(), perm[b].tolist(), idx[b].tolist()
        assert o[0] == 0 and all(x <= y for x, y in zip(o, o[1:]))
        assert sorted(p) == list(range(K))
        for j in range(n):
            assert p[o[j]:o[j + 1]] == [k for k in range(K) if ix[k] == j]
        assert p[o[n]:] == [k for k in range(K) if not 0 <= ix[k] < n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 5, 32, 64])
def test_csr_sum_matches_pallas(rng, dtype, C):
    """The CSR sum against _scatter_rows (C > 16) and _scatter_rows_t
    (C <= 16) in interpret mode: the one-hot dot sums in another order, so
    f32 agrees to 1e-5 of the largest row sum and bf16 to one bf16 ulp
    (2^-7 relative) of it, as test_torch_ops.py holds the plain scatter."""
    B, K, n = 2, 300, 64
    g, idx = _case(rng, B, K, n, C, "dups")
    want = np.asarray(jgroup._scatter_rows(
        jnp.asarray(g.numpy()).astype(dtype), jnp.asarray(idx.numpy()), n)
    ).astype(np.float32)
    off, perm = grouping.scatter_csr_plain(idx, n)
    got = grouping.scatter_rows_csr_plain(g.to(getattr(torch, dtype)), off,
                                          perm, n)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
