"""The port's fused SA chain in train mode held against the JAX package on
the CPU: the plain versions of the backward kernels (Pallas rows 13-15 of
pointnet2_tpu/ops/pallas/fused_mlp.py, run in interpret mode off the TPU),
the rounding points of the dense backward, the chain with its gradients,
the SA and MSG layers and the cls_ssg train step with the gate on in both
packages, Trainer epochs with the gate on, and the eval chain's refusal to
be differentiated.

The same numpy inputs (from a seed) go through both packages; the port's
CPU tensors take the plain PyTorch versions of the CUDA kernels.
Tolerances:

- elementwise outputs (g_{k-1}, dx): f32 within 1e-5 of the output's
  largest magnitude (XLA:CPU may contract a multiply-add into an FMA, the
  port rounds the product and the sum apart, ROADMAP Queue 3), bf16 within
  one bf16 ulp;
- sums (T1, T2, dW, db): the same terms added in another order, each sum
  within (n - 1) * 2^-24 * sum|terms| of the exact one; held at 1e-5 of
  sum|terms| (n <= 256 here, 2 * 256 * 2^-24 = 3e-5 is the worst case,
  1e-5 leaves room for the contracted terms), and at 2^-7 of it in bf16,
  where a g_{k-1} one bf16 ulp off changes a term by up to 2^-8 of itself;
- gradients of the chain: JAX's test_chain_grads_match_unfused rule, 2e-4
  of the largest gradient of each group (x, the denses, the scales, the
  biases).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import config as jax_config
from pointnet2_tpu import nn as jnn
from pointnet2_tpu.ops.pallas import fused_mlp as jfm
from pointnet2_tpu_torch import config, flax_to_torch
from pointnet2_tpu_torch import nn as tnn
from pointnet2_tpu_torch import ops as tops
from pointnet2_tpu_torch.ops import fused_mlp as tfm
from pointnet2_tpu_torch.ops.pooling import max_pool
from tests.test_torch_fused_mlp import (
    BF16_TOL,
    DT,
    _bf16_ulp,
    _j,
    _make_chain,
    _t,
)
from tests.test_torch_model import F32_TOL, _jax_init, _randomize
from tests.test_torch_train import (
    _compared,
    _port_train_step,
    _rel,
    jax_step_setup,
)

EPS = 1e-3
B = 2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _elementwise_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def _sum_close(got, want, abs_sum, dtype):
    """A sum held to its terms' magnitude (see the module docstring)."""
    got, want = _np(got).reshape(-1), _np(want).reshape(-1)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert (np.abs(got - want) <= tol * _np(abs_sum).reshape(-1)
            + 1e-30).all(), np.abs(got - want).max()


def _pack(rng, c, m=True):
    """A random BN pack, the same f32 values for both packages: the port's
    bn_pack on numpy draws (held to JAX's _bn_pack below)."""
    scale = rng.uniform(-1.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    mean = (0.3 * rng.randn(c)).astype(np.float32)
    var = rng.uniform(0.3, 2.0, c).astype(np.float32)
    ms = [(0.1 * rng.randn(c)).astype(np.float32) for _ in range(2)] \
        if m else [None, None]
    p = tfm.bn_pack(*map(_t, (scale, bias, mean, var)), EPS,
                    *[None if v is None else _t(v) for v in ms])
    return p, (scale, bias, mean, var, *ms)


# ---------------------------------------------------------------------------
# the backward steps against the Pallas kernels
# ---------------------------------------------------------------------------


def test_bn_pack_matches_jax(rng):
    for m in (True, False):
        got, args = _pack(rng, 12, m)
        want = jfm._bn_pack(*[None if v is None else _j(v) for v in args[:4]],
                            EPS, *[None if v is None else _j(v)
                                   for v in args[4:]])
        assert got.shape == (7, 12) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert not got[5:].any()


def _cotangent_inputs(rng, pool, dtype, C=16):
    td, _ = DT[dtype]
    G, S = 8, 16
    shape = (G, S, C) if pool else (G * S, C)
    y = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*((G, C) if pool else shape)).astype(np.float32)
    if dtype == "bf16":  # the values both packages get
        y = _t(y, td).float().numpy()
        g = _t(g, td).float().numpy()
    return y, g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False])
def test_top_stats_matches_pallas(rng, pool, dtype):
    td, jd = DT[dtype]
    y, g = _cotangent_inputs(rng, pool, dtype)
    p, _ = _pack(rng, y.shape[-1], m=False)
    w1, w2 = jax.jit(lambda *v: jfm._top_stats(*v, pool=pool))(
        _j(y, jd), _j(g, jd), jnp.asarray(p.numpy()))
    t1, t2 = tfm.top_stats(_t(y, td), _t(g, td), p, pool)
    assert t1.shape == t2.shape == (y.shape[-1],)
    assert t1.dtype == t2.dtype == torch.float32
    # |terms| bounded by |g| and |g * yhat| (with the pool, at the largest
    # |yhat| over S, wherever the argmax falls)
    ag = torch.from_numpy(np.abs(g))
    ayhat = ((torch.from_numpy(y) - p[2]) * p[3]).abs()
    abs1 = ag.sum(0)
    abs2 = (ag * (ayhat.amax(1) if pool else ayhat)).sum(0)
    _sum_close(t1, w1, abs1, "f32")
    _sum_close(t2, w2, abs2, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("top_pool", [True, False])
def test_dense_bwd_matches_pallas(rng, top_pool, dtype):
    td, jd = DT[dtype]
    ck, cp = 16, 12
    yk, g = _cotangent_inputs(rng, top_pool, dtype, C=ck)
    R = yk.size // ck
    yp = rng.randn(R, cp).astype(np.float32)
    w = (rng.randn(ck, cp) / np.sqrt(cp)).astype(np.float32)  # nn.Linear's
    pk, _ = _pack(rng, ck)
    pp, _ = _pack(rng, cp, m=False)
    want = jax.jit(lambda *v: jfm._dense_bwd(*v, top_pool=top_pool))(
        _j(yk, jd), _j(yp, jd), _j(g, jd), jnp.asarray(pk.numpy()),
        jnp.asarray(pp.numpy()), _j(w.T))
    wg, wdw, wdb, wt1, wt2 = want
    gp, dw, db, t1, t2 = tfm.dense_bwd(_t(yk, td), _t(yp, td), _t(g, td),
                                       pk, pp, _t(w), top_pool)
    assert gp.shape == (R, cp) and gp.dtype == td
    assert dw.shape == (ck, cp) and db.shape == (ck,)
    assert t1.shape == t2.shape == (cp,)
    _elementwise_close(gp, wg, dtype)
    # |terms| from the port's own rounded operands
    ykt = _t(yk, td)
    dyc = _dy(ykt, _t(g, td), pk, top_pool)
    zp = tfm.affine_fwd_plain(_t(yp, td), pp[0], pp[1]).float()
    _sum_close(dw, np.asarray(wdw).T, dyc.abs().t() @ zp.abs(), "f32")
    _sum_close(db, np.asarray(wdb)[0], dyc.abs().sum(0), "f32")
    gpf = gp.float()
    yhatp = (_t(yp, td).float() - pp[2]) * pp[3]
    _sum_close(t1, np.asarray(wt1)[0], gpf.abs().sum(0), dtype)
    _sum_close(t2, np.asarray(wt2)[0], (gpf * yhatp).abs().sum(0), dtype)


def _dy(yk, g, pk, top_pool):
    """dy of the plain version's first step, f32, as (rows, Ck)."""
    if top_pool:
        dz = tfm._pooled_cotangent(yk, g, pk).reshape(-1, yk.shape[-1])
        yk = yk.reshape(-1, yk.shape[-1])
    else:
        dz = g.float()
    dout, yhat = tfm._bn_bwd_terms(yk, dz, pk)
    return tfm._bn_dy(dout, yhat, pk)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_first_bwd_matches_pallas(rng, dtype):
    td, jd = DT[dtype]
    x, g = _cotangent_inputs(rng, False, dtype, C=8)
    p, _ = _pack(rng, 8)
    want = jax.jit(jfm._first_bwd)(_j(x, jd), _j(g, jd),
                                   jnp.asarray(p.numpy()))
    got = tfm.first_bwd(_t(x, td), _t(g, td), p)
    assert got.dtype == td and got.shape == x.shape
    _elementwise_close(got, want, dtype)


def test_dense_bwd_plain_rounds_where_the_kernel_does():
    """bf16, one row, one channel each side, top_pool off: (1) dy is rounded
    to bf16 before both products, (2) db sums the unrounded dy, (3) T1/T2
    come from the rounded g_{k-1}."""
    bf = torch.bfloat16
    # BN_k's pack: a = 1, b = 0, mean 0, r = 1, gr = 1, m1 = m2 = 0, so dy
    # = g where y > 0; BN_{k-1}'s the same, so z_{k-1} = y_{k-1} for y > 0
    unit = torch.tensor([[1.0], [0.0], [0.0], [1.0], [1.0], [0.0], [0.0]])
    # g = 1 + 2^-8 in f32 is not a bf16: the cotangent arrives in bf16, so
    # take dy = gr * g with gr = 1 + 2^-8: dy = 1 + 2^-8 exactly in f32,
    # bf16(dy) = 1 (a tie, to even)
    pk = unit.clone()
    pk[4] = 1 + 2 ** -8
    yk = torch.tensor([[1.0]], dtype=bf)
    g = torch.tensor([[1.0]], dtype=bf)
    yp = torch.tensor([[1.0]], dtype=bf)
    w = torch.tensor([[1.0 + 2 ** -7]])  # a bf16 value
    gp, dw, db, t1, t2 = tfm.dense_bwd_plain(yk, yp, g, pk, unit, w, False)
    assert db.item() == 1 + 2 ** -8  # (2): the unrounded dy
    assert dw.item() == 1.0  # (1): bf16(dy) * z = 1 * 1, not 1 + 2^-8
    # (1) again: g = bf16(bf16(dy) * w) = 1 + 2^-7; an unrounded dy gives
    # (1 + 2^-8)(1 + 2^-7) = 1 + 3 * 2^-8 + 2^-15, which rounds to 1 + 2^-6
    assert gp.item() == 1 + 2 ** -7
    # (3): T1 is the rounded g; T2 = g * yhat with yhat = 1
    assert t1.item() == t2.item() == 1 + 2 ** -7
    # and where the cast rounds g itself: w = 1 + 3 * 2^-8 is no bf16 value,
    # it is rounded to 1 + 2^-6 (a tie) before the product
    gp, _, _, t1, _ = tfm.dense_bwd_plain(yk, yp, g, unit, unit,
                                          torch.tensor([[1 + 3 * 2 ** -8]]),
                                          False)
    assert gp.item() == t1.item() == 1 + 2 ** -6


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


def _chain_args(rng, feats, pool, dtype):
    td, jd = DT[dtype]
    Bc, M, S, C0 = 2, 4, 16, 8
    x = rng.randn(Bc, M, S, C0).astype(np.float32)
    denses, scales, biases, _ = _make_chain(rng, C0, feats)
    shape = (Bc, M, feats[-1]) if pool else (Bc, M, S, feats[-1])
    tgt = rng.randn(*shape).astype(np.float32)
    return x, denses, scales, biases, tgt


def _port_leaves(x, denses, scales, biases, td):
    xt = _t(x, td).requires_grad_()
    dts = [(torch.from_numpy(w.T.copy()).requires_grad_(),
            torch.from_numpy(b.copy()).requires_grad_()) for w, b in denses]
    st = [torch.from_numpy(s.copy()).requires_grad_() for s in scales]
    bt = [torch.from_numpy(b.copy()).requires_grad_() for b in biases]
    return xt, dts, st, bt


def _group_close(got, want):
    """JAX test_chain_grads_match_unfused's rule: every leaf of a group
    within 2e-4 of the group's largest reference gradient."""
    scale = max(np.abs(w).max() for w in want) + 1e-6
    for g, w in zip(got, want):
        assert np.abs(g - w).max() / scale < 2e-4, (np.abs(g - w).max(),
                                                     scale)


def _port_grads(xt, dts, st, bt):
    return ([_np(xt.grad)],
            [v for w, b in dts for v in (_np(w.grad).T, _np(b.grad))],
            [_np(s.grad) for s in st], [_np(b.grad) for b in bt])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("feats", [[8, 16], [16, 8, 12]])
def test_fused_chain_train_matches_jax(rng, feats, pool, dtype):
    """Output, statistics and every gradient of the port's
    fused_chain_train against JAX fused_chain_train (interpret mode), with
    the loss sum((out - tgt)^2) of JAX's own gradient test."""
    td, jd = DT[dtype]
    x, denses, scales, biases, tgt = _chain_args(rng, feats, pool, dtype)
    cfg = jfm.ChainConfig(eps=EPS, axis_name=None, pool=pool)

    def loss(x, d, s, b):
        out, st = jfm.fused_chain_train(cfg, x, d, s, b)
        return jnp.sum((out.astype(jnp.float32) - tgt) ** 2), (out, st)

    (_, (wout, wstats)), wgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
            _j(x, jd), tuple((_j(w), _j(b)) for w, b in denses),
            tuple(map(_j, scales)), tuple(map(_j, biases)))

    xt, dts, st, bt = _port_leaves(x, denses, scales, biases, td)
    out, stats = tfm.fused_chain_train(tfm.ChainConfig(EPS, pool), xt, dts,
                                       st, bt)
    assert out.dtype == td and out.shape == tgt.shape
    assert len(stats) == len(feats) + 1
    assert all(not m.requires_grad and not v.requires_grad for m, v in stats)
    ((out.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
    _elementwise_close(out, wout, dtype)
    for (m, v), (wm, wv) in zip(stats, wstats):
        np.testing.assert_allclose(_np(m), _np(wm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(v), _np(wv), rtol=1e-5, atol=1e-6)
    want = ([_np(wgrads[0])],
            [v for w, b in wgrads[1] for v in (_np(w), _np(b))],
            [_np(s) for s in wgrads[2]], [_np(b) for b in wgrads[3]])
    for got, ref in zip(_port_grads(xt, dts, st, bt), want):
        _group_close(got, ref)


def _unfused_chain(x, denses, scales, biases, pool):
    """The chain as separate PyTorch ops (JAX's test _unfused): batch
    statistics, BN, ReLU, dense, first-occurrence max-pool."""
    stats = []

    def bn(y, j):
        yf = y.float()
        dims = tuple(range(y.dim() - 1))
        mean, meansq = yf.mean(dims), yf.square().mean(dims)
        var = torch.clamp_min(meansq - mean.square(), 0.0)
        stats.append((mean, var))
        out = (yf - mean) * torch.rsqrt(var + EPS) * scales[j] + biases[j]
        return torch.relu(out).to(y.dtype)

    cur = bn(x, 0)
    for k, (w, b) in enumerate(denses):
        cur = bn(torch.nn.functional.linear(cur, w, b), k + 1)
    return (max_pool(cur, 2) if pool else cur), stats


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("feats", [[8, 16], [16, 8, 12]])
def test_fused_chain_train_matches_unfused(rng, feats, pool):
    """f32: the fused chain against the port's own unfused ops, output,
    statistics (1e-5) and gradients (2e-4 of each group's largest)."""
    x, denses, scales, biases, tgt = _chain_args(rng, feats, pool, "f32")
    runs = []
    for fn in (lambda *a: tfm.fused_chain_train(
            tfm.ChainConfig(EPS, pool), *a), lambda *a: _unfused_chain(
                *a, pool)):
        leaves = _port_leaves(x, denses, scales, biases, torch.float32)
        out, stats = fn(*leaves)
        ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
        runs.append((out, stats, _port_grads(*leaves)))
    (out, stats, grads), (uout, ustats, ugrads) = runs
    np.testing.assert_allclose(_np(out), _np(uout), rtol=1e-5,
                               atol=1e-5 * np.abs(_np(uout)).max())
    for (m, v), (um, uv) in zip(stats, ustats):
        np.testing.assert_allclose(_np(m), _np(um), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(v), _np(uv), rtol=1e-5, atol=1e-6)
    for got, ref in zip(grads, ugrads):
        _group_close(got, ref)


# ---------------------------------------------------------------------------
# layers, the train step and the Trainer with the gate on
# ---------------------------------------------------------------------------


@pytest.fixture
def count_chains(monkeypatch):
    """Counts the train-mode fused chains each package runs."""
    counts = {"jax": 0, "torch": 0}

    def spy(pkg, real):
        def wrapped(*args, **kw):
            counts[pkg] += 1
            return real(*args, **kw)
        return wrapped

    monkeypatch.setattr(jfm, "fused_chain_train",
                        spy("jax", jfm.fused_chain_train))
    monkeypatch.setattr(tfm, "fused_chain_train",
                        spy("torch", tfm.fused_chain_train))
    return counts


def _train_pair(jmod, tmod, args, seed, momentum=0.7):
    """Randomised Flax variables of jmod, converted into tmod; one
    train-mode call of each with the gate on in both packages, and one of a
    copy of tmod with the gate off. Returns the port's outputs and buffers,
    JAX's outputs and new batch_stats, and the port's unfused outputs."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    variables = _randomize(_jax_init(jmod, *jargs), seed=seed)
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    unfused = copy.deepcopy(tmod).train()(*targs, momentum)
    with jax_config.fused_mlp(True), config.fused_mlp(True):
        want, upd = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, bn_momentum=momentum,
            mutable=["batch_stats"]))(variables, *jargs)
        got = tmod.train()(*targs, momentum)
    new = flax_to_torch({"params": variables["params"],
                         "batch_stats": upd["batch_stats"]}, tmod)
    return got, dict(tmod.named_buffers()), want, new, unfused


def _close(got, want, unfused, dtype):
    """f32: the fused layer within F32_TOL of JAX's fused layer. bf16: the
    two packages' grouped inputs round apart, and in train mode the batch
    statistics magnify that where a channel's spread is small (the xyz-only
    lift, C=0: the unfused layers of the two packages differ by 8% of the
    range there too), so in bf16 the port's fused layer is held to its own
    unfused layer (same inputs; the BN affine reassociates), 2% of the
    range."""
    got, want, unfused = _np(got), _np(want), _np(unfused)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(got, unfused, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert np.abs(got - unfused).max() <= BF16_TOL * np.abs(
            unfused).max()


def _buffers_close(bufs, new, dtype):
    """Running statistics after one momentum-0.7 update. f32: the batch
    statistics of both packages agree to summation order (1e-5). bf16: the
    chain's input, the lifted dense gathered, is rounded to bf16 after
    products each package orders its own way, so its statistics agree to
    bf16's 2^-8 relative rounding; held at 2^-7 of each tensor's largest
    value."""
    assert bufs
    for k, b in bufs.items():
        want = new[k].numpy()
        tol = 1e-5 if dtype == "f32" else 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(b.numpy(), want, rtol=1e-5, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [0, 5])
def test_set_abstraction_train_fused_matches_jax(rng, count_chains, C,
                                                 dtype):
    xyz = rng.rand(B, 96, 3).astype(np.float32)
    pts = rng.randn(B, 96, C).astype(np.float32) if C else None
    td, jd = (None, None) if dtype == "f32" else DT[dtype]
    (_, npts, idx), bufs, (_, wpts, widx), new, un = _train_pair(
        jnn.SetAbstraction(24, 0.3, 8, (16, 12, 32), dtype=jd),
        tnn.SetAbstraction(24, 0.3, 8, C, (16, 12, 32), dtype=td),
        (xyz, pts), 70 + C)
    assert count_chains == {"jax": 1, "torch": 1}
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    assert npts.shape == (B, 24, 32) and npts.requires_grad
    _close(npts, wpts, un[1], dtype)
    _buffers_close(bufs, new, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_set_abstraction_msg_train_fused_matches_jax(rng, count_chains,
                                                     dtype):
    xyz = rng.rand(B, 128, 3).astype(np.float32)
    pts = rng.randn(B, 128, 5).astype(np.float32)
    td, jd = (None, None) if dtype == "f32" else DT[dtype]
    mlps = ((16, 32), (16, 12, 24), (8,))  # the last has no dense to fuse
    (_, npts), bufs, (_, wpts), new, un = _train_pair(
        jnn.SetAbstractionMSG(32, (0.2, 0.4, 0.3), (8, 16, 4), mlps,
                              dtype=jd),
        tnn.SetAbstractionMSG(32, (0.2, 0.4, 0.3), (8, 16, 4), 5, mlps,
                              dtype=td), (xyz, pts), 75)
    assert count_chains == {"jax": 2, "torch": 2}
    assert npts.shape == (B, 32, 32 + 24 + 8)
    _close(npts, wpts, un[1], dtype)
    _buffers_close(bufs, new, dtype)


@pytest.fixture(scope="module")
def fused_step():
    """JAX's cls_ssg train step (tests/test_torch_train.py's setup) with the
    gate on, counting JAX's train-mode chains as it traces."""
    calls = []
    real = jfm.fused_chain_train

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    jfm.fused_chain_train = spy
    try:
        setup = jax_step_setup(fused=True)
    finally:
        jfm.fused_chain_train = real
    return setup, len(calls)


def test_cls_ssg_train_step_fused_matches_jax(fused_step, count_chains):
    """One full-width pointnet2_cls_ssg train step with the gate on in both
    packages, on the same weights, batch and dropout masks; both held to
    the port's float64 unfused run as test_cls_ssg_train_step_matches_jax
    holds the unfused steps: the port's loss within 1e-5 and gradients
    within 1e-3 of their norm, JAX's within 1e-4 and 5e-2; the running
    statistics within 1e-4 (port) and 1e-3 (JAX) of each tensor's scale.
    Each package runs SA1's and SA2's chains."""
    setup, jax_chains = fused_step
    assert jax_chains == 2
    with config.fused_mlp(True):
        state, metrics = _port_train_step(setup)
    assert count_chains["torch"] == 2
    loss64 = setup["loss64"]
    assert abs(float(metrics["loss"]) - loss64) <= 1e-5 * loss64
    assert abs(setup["loss"] - loss64) <= 1e-4 * loss64
    params = dict(state.model.named_parameters())
    compared = _compared(setup)
    assert len(compared) >= 30
    for k in compared:
        ref = setup["grads64"][k]
        assert _rel(params[k].grad.numpy(), ref) <= 1e-3, k
        assert _rel(setup["grads"][k].numpy(), ref) <= 5e-2, k
    for k, b in state.model.named_buffers():
        ref = setup["buffers64"][k]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(b.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(setup["new"][k].numpy(), ref, rtol=0,
                                   atol=1e-3 * scale, err_msg=k)


@pytest.mark.parametrize("name,chains", [("pointnet2_cls_ssg", 2),
                                         ("pointnet2_cls_msg", 6),
                                         ("pointnet_cls_basic", 0)])
def test_trainer_fit_with_the_gate_on(tmp_path, monkeypatch, count_chains,
                                      name, chains):
    """Trainer.fit on the CPU with the gate on: every train step runs the
    model's train-mode chains (one per fuse_first SA layer or MSG scale;
    the PointNet baseline has none), the eval forwards the eval chains, and
    the loss is finite."""
    import json

    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(model=name, batch_size=2, num_point=64, max_epoch=2,
                      log_dir=str(tmp_path))
    data = SyntheticClassification(num_classes=4, samples_per_class=1,
                                   npoints=64, batch_size=2, seed=0)
    evals = []
    real = tfm.fused_chain_eval

    def spy(*args, **kw):
        evals.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tfm, "fused_chain_eval", spy)
    with config.fused_mlp(True), Trainer(cfg, device="cpu") as tr:
        state = tr.fit(data, eval_dataset=data)
    assert state.step == 2 * data.num_batches()
    assert count_chains["torch"] == chains * state.step
    assert len(evals) == chains * 2 * data.num_batches()
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if r["split"] == "train"]
    assert len(losses) == 2 and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the eval chain has no gradient; the kernel wrappers on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_grad", [False, True])
def test_eval_chain_backward_raises(rng, x_grad):
    """An eval-mode SA layer with the gate on: the forward is the fused eval
    chain, and a backward through it raises (the JAX package's eval chain
    is not differentiable), whether the gradient is asked of the layer's
    parameters or of its input."""
    sa = tnn.SetAbstraction(16, 0.3, 8, 5, (8, 16)).eval()
    xyz = torch.from_numpy(rng.rand(B, 64, 3).astype(np.float32))
    pts = torch.from_numpy(rng.randn(B, 64, 5).astype(np.float32))
    if x_grad:
        sa.requires_grad_(False)
        pts.requires_grad_()
    with config.fused_mlp(True):
        _, out, _ = sa(xyz, pts)
    assert out.grad_fn is not None
    with pytest.raises(RuntimeError, match="not differentiable"):
        out.sum().backward()
    with torch.inference_mode(), config.fused_mlp(True):
        _, again, _ = sa(xyz, pts)
    assert torch.equal(again, out.detach())


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    y = torch.zeros(16, 4)
    p = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["fused_top_stats"](y, y, p, False)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["fused_dense_bwd"](y, y, y, p, p, torch.zeros(4, 4),
                                        False)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["fused_first_bwd"](y, y, p)
    # the plain versions are what the CPU runs, and launch nothing
    before = {k: w.launches for k, w in tops.KERNELS.items()}
    tfm.top_stats(y.reshape(4, 4, 4), y[:4], p, True)
    tfm.dense_bwd(y, y, y, p, p, torch.zeros(4, 4), False)
    tfm.first_bwd(y, y, p)
    assert {k: w.launches for k, w in tops.KERNELS.items()} == before
