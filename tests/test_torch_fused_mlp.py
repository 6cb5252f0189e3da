"""The port's fused SA chain (forward, eval) held against the JAX package on
the CPU: the three steps of the chain against the Pallas kernels
(pointnet2_tpu/ops/pallas/fused_mlp.py, run in interpret mode off the TPU),
the chain, the SA and MSG layers and two models with the gate on in both
packages, and the route rule (which layers take the fused chain, in eval
and in train mode). The train-mode chain and its backward are held against
JAX in tests/test_torch_fused_train.py.

The same numpy inputs (from a seed) go through both packages; the port's
CPU tensors take the plain PyTorch versions of the CUDA kernels. Tolerances:
f32 steps within 1e-5 relative (XLA:CPU may contract x*a + b into an FMA,
ROADMAP Queue 3; the port rounds the product and the sum apart), bf16 steps
within one bf16 ulp; layers at test_torch_model's F32_TOL and 2% of the
range in bf16 (test_torch_seg's BF16_TOL). The JAX classifiers have fixed
widths, so the models run at full width on N = 128 points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import config as jax_config
from pointnet2_tpu import nn as jnn
from pointnet2_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pointnet2_tpu.ops.pallas import fused_mlp as jfm
from pointnet2_tpu_torch import MODEL_REGISTRY, config, flax_to_torch
from pointnet2_tpu_torch import nn as tnn
from pointnet2_tpu_torch import ops as tops
from pointnet2_tpu_torch.ops import fused_mlp as tfm
from tests.test_torch_model import F32_TOL, _jax_init, _randomize

BF16_TOL = 0.02  # of the output's range (test_torch_seg.py:37-40)
EPS = 1e-3
B = 2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _assert_step_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                    jnp.bfloat16)}


def _affine(rng, c):
    return (rng.uniform(-1.5, 1.5, c).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32))


# ---------------------------------------------------------------------------
# the three steps against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_fwd_matches_pallas(rng, dtype, want_stats):
    td, jd = DT[dtype]
    R, cin, cout = 64, 8, 16
    x = rng.randn(R, cin).astype(np.float32)
    a, b = _affine(rng, cin)
    w = (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32)  # Flax
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    wy, ws, wss = jax.jit(lambda *v: jfm._dense_fwd(
        *v, want_stats=want_stats))(_j(x, jd), _j(a), _j(b), _j(w), _j(bias))
    y, s, ss = tfm.dense_fwd(_t(x, td), _t(a), _t(b), _t(w.T), _t(bias),
                             want_stats)
    assert y.dtype == td and y.shape == (R, cout)
    _assert_step_close(y, wy, dtype)
    if not want_stats:
        assert s is None and ss is None
        return
    # sums of the rounded y, f32: the port's y (within the step tolerance
    # of JAX's) summed in another order
    assert s.dtype == ss.dtype == torch.float32
    yf = y.float().numpy()
    np.testing.assert_allclose(s.numpy(), yf.sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ss.numpy(), (yf * yf).sum(0), rtol=1e-5)
    scale = np.abs(np.asarray(wy).astype(np.float32)).sum(0)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert (np.abs(s.numpy() - np.asarray(ws)[0]) <= tol * scale).all()
    assert (np.abs(ss.numpy() - np.asarray(wss)[0])
            <= 2 * tol * np.asarray(wss)[0] + 1e-6).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pool_fwd_matches_pallas(rng, dtype):
    td, jd = DT[dtype]
    G, S, C = 8, 16, 16
    y = rng.randn(G, S, C).astype(np.float32)
    a, b = _affine(rng, C)
    want = jax.jit(jfm._pool_fwd)(_j(y, jd), _j(a), _j(b))
    got = tfm.pool_fwd(_t(y, td), _t(a), _t(b))
    assert got.dtype == td
    _assert_step_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_affine_fwd_matches_pallas(rng, dtype):
    td, jd = DT[dtype]
    R, C = 64, 16
    y = rng.randn(R, C).astype(np.float32)
    a, b = _affine(rng, C)
    want = jax.jit(jfm._affine_fwd)(_j(y, jd), _j(a), _j(b))
    got = tfm.affine_fwd(_t(y, td), _t(a), _t(b))
    assert got.dtype == td
    _assert_step_close(got, want, dtype)


def test_plain_steps_round_where_the_kernels_do():
    """bf16: z is rounded before the matmul, acc is not rounded before the
    bias, and y*a + b rounds the product and the sum apart (no FMA)."""
    bf = torch.bfloat16
    one, zero = torch.tensor([1.0]), torch.tensor([0.0])
    # z = bf16(1 + 2^-9) = 1; y = bf16(1 + 2^-8), a tie, = 1 (an unrounded
    # z would give bf16(1 + 3 * 2^-9) = 1 + 2^-7)
    y, _, _ = tfm.dense_fwd_plain(torch.tensor([[1.0]], dtype=bf),
                                  torch.tensor([1 + 2 ** -9]), zero,
                                  torch.tensor([[1.0]]),
                                  torch.tensor([2.0 ** -8]))
    assert y.item() == 1.0
    # acc = 1 + 2^-8 in f32, + 2^-8 = 1 + 2^-7 (rounding acc to bf16 first,
    # a tie, would give 1, and 1 again after the bias)
    y, _, _ = tfm.dense_fwd_plain(torch.tensor([[1.0, 2 ** -8]], dtype=bf),
                                  one.expand(2), zero.expand(2),
                                  torch.tensor([[1.0, 1.0]]),
                                  torch.tensor([2.0 ** -8]))
    assert y.item() == 1 + 2 ** -7
    # (1 + e)(1 + 3e) - 1 with e = 2^-23: 2^-21 after two roundings, 2^-21 +
    # 2^-44 from a fused multiply-add
    got = tfm.affine_fwd_plain(torch.tensor([[1 + 2 ** -23]]),
                               torch.tensor([1 + 3 * 2 ** -23]),
                               torch.tensor([-1.0]))
    assert got.item() == 2.0 ** -21


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


def _make_chain(rng, c0, feats):
    """tests/test_ops_fused_mlp.py's chain parameters, as numpy; dense
    kernels in Flax's (Cin, Cout) layout."""
    denses, scales, biases, running = [], [], [], []
    cin = c0
    for c in [c0] + feats:
        scales.append(rng.rand(c).astype(np.float32) + 0.5)
        biases.append((rng.randn(c) * 0.1).astype(np.float32))
        running.append(((rng.randn(c) * 0.1).astype(np.float32),
                        rng.rand(c).astype(np.float32) + 0.5))
    for f in feats:
        denses.append(((rng.randn(cin, f) / np.sqrt(cin)).astype(np.float32),
                       (rng.randn(f) * 0.1).astype(np.float32)))
        cin = f
    return denses, scales, biases, running


@pytest.mark.parametrize("feats", [[12, 16], [16, 8, 12]])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_chain_eval_matches_jax(rng, dtype, pool, feats):
    td, jd = DT[dtype]
    Bc, M, S, C0 = 2, 4, 16, 8
    x = rng.randn(Bc, M, S, C0).astype(np.float32)
    denses, scales, biases, running = _make_chain(rng, C0, feats)
    assert tfm.fused_chain_eligible(x.shape, td, len(denses))
    assert jfm.fused_chain_eligible(x.shape, jd, len(denses))
    want = jax.jit(lambda x: jfm.fused_chain_eval(
        jfm.ChainConfig(eps=EPS, axis_name=None, pool=pool), x,
        tuple((_j(w), _j(b)) for w, b in denses), tuple(map(_j, scales)),
        tuple(map(_j, biases)),
        tuple((_j(m), _j(v)) for m, v in running)))(_j(x, jd))
    got = tfm.fused_chain_eval(
        tfm.ChainConfig(eps=EPS, pool=pool), _t(x, td),
        [(_t(w.T), _t(b)) for w, b in denses], list(map(_t, scales)),
        list(map(_t, biases)), [(_t(m), _t(v)) for m, v in running])
    shape = (Bc, M, feats[-1]) if pool else (Bc, M, S, feats[-1])
    assert got.shape == shape and got.dtype == td
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL,
                                   atol=F32_TOL * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# layers and models with the gate on in both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def count_chains(monkeypatch):
    """Counts the fused chains each package runs (its fused_chain_eval and
    fused_chain_train)."""
    counts = {"jax": 0, "torch": 0}

    def spy(pkg, real):
        def wrapped(*args, **kw):
            counts[pkg] += 1
            return real(*args, **kw)
        return wrapped

    for name in ("fused_chain_eval", "fused_chain_train"):
        monkeypatch.setattr(jfm, name, spy("jax", getattr(jfm, name)))
        monkeypatch.setattr(tfm, name, spy("torch", getattr(tfm, name)))
    return counts


def _pair(jmod, tmod, args, seed, fused=True):
    """Randomised Flax variables of jmod, converted strictly into tmod;
    both eval outputs on the same numpy inputs with the gate at `fused` in
    both packages."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    variables = _randomize(_jax_init(jmod, *jargs), seed=seed)
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    with jax_config.fused_mlp(fused), config.fused_mlp(fused):
        want = jax.jit(lambda v, *a: jmod.apply(v, *a))(variables, *jargs)
        with torch.inference_mode():
            got = tmod.eval()(*[None if a is None else torch.from_numpy(a)
                                for a in args])
    return got, want


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [0, 5])
def test_set_abstraction_fused_matches_jax(rng, count_chains, C, dtype):
    xyz = rng.rand(B, 96, 3).astype(np.float32)
    pts = rng.randn(B, 96, C).astype(np.float32) if C else None
    td, jd = (None, None) if dtype == "f32" else DT[dtype]
    (nxyz, npts, idx), (wxyz, wpts, widx) = _pair(
        jnn.SetAbstraction(24, 0.3, 8, (16, 12, 32), dtype=jd),
        tnn.SetAbstraction(24, 0.3, 8, C, (16, 12, 32), dtype=td),
        (xyz, pts), 40 + C)
    assert count_chains == {"jax": 1, "torch": 1}
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    assert npts.shape == (B, 24, 32)
    _close(npts, wpts, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_set_abstraction_msg_fused_matches_jax(rng, count_chains, dtype):
    xyz = rng.rand(B, 128, 3).astype(np.float32)
    pts = rng.randn(B, 128, 5).astype(np.float32)
    td, jd = (None, None) if dtype == "f32" else DT[dtype]
    mlps = ((16, 32), (16, 12, 24), (8,))  # the last has no dense to fuse
    (nxyz, npts), (wxyz, wpts) = _pair(
        jnn.SetAbstractionMSG(32, (0.2, 0.4, 0.3), (8, 16, 4), mlps,
                              dtype=jd),
        tnn.SetAbstractionMSG(32, (0.2, 0.4, 0.3), (8, 16, 4), 5, mlps,
                              dtype=td), (xyz, pts), 45)
    assert count_chains == {"jax": 2, "torch": 2}
    np.testing.assert_array_equal(nxyz.numpy(), np.asarray(wxyz))
    assert npts.shape == (B, 32, 32 + 24 + 8)
    _close(npts, wpts, dtype)


@pytest.fixture(scope="module")
def model_runs():
    """cls_ssg and cls_msg at N = 128: randomised Flax variables and JAX's
    eval logits with the gate on, f32 and bf16."""
    rs = np.random.RandomState(11)
    pc = rs.rand(B, 128, 3).astype(np.float32)
    out = {}
    for seed, name in enumerate(("pointnet2_cls_ssg", "pointnet2_cls_msg")):
        cls = JAX_REGISTRY[name].cls
        variables = _randomize(_jax_init(cls(), jnp.asarray(pc), train=False),
                               seed=50 + seed)
        logits = {}
        with jax_config.fused_mlp(True):
            for tag, dt in (("f32", None), ("bf16", jnp.bfloat16)):
                model = cls(dtype=dt)
                got, _ = jax.jit(lambda v, p: model.apply(v, p, train=False))(
                    variables, jnp.asarray(pc))
                logits[tag] = np.asarray(got)
        out[name] = (variables, logits)
    return pc, out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,chains", [("pointnet2_cls_ssg", 2),
                                         ("pointnet2_cls_msg", 6)])
def test_model_fused_matches_jax(model_runs, count_chains, name, chains,
                                 dtype):
    """The slice as a whole: a classifier with the gate on in both
    packages, on the same weights; the port's fused route also against its
    own unfused route (f32 within F32_TOL: only the BN affine
    reassociates)."""
    pc, runs = model_runs
    variables, logits = runs[name]
    model = MODEL_REGISTRY[name].cls(
        dtype=torch.bfloat16 if dtype == "bf16" else None, device="cpu")
    model.load_state_dict(flax_to_torch(variables, model), strict=True)
    model.eval()
    with torch.inference_mode():
        with config.fused_mlp(True):
            got = model(torch.from_numpy(pc)).numpy()
        assert count_chains["torch"] == chains
        unfused = model(torch.from_numpy(pc)).numpy()
    assert count_chains["torch"] == chains
    assert got.shape == (B, 40)
    _close(torch.from_numpy(got), logits[dtype], dtype)
    _close(torch.from_numpy(got), unfused, dtype)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


def test_gate_defaults_off_and_restores():
    assert not config.fused_mlp_enabled()
    with config.fused_mlp(True):
        assert config.fused_mlp_enabled()
        with config.fused_mlp(False):
            assert not config.fused_mlp_enabled()
        assert config.fused_mlp_enabled()
    assert not config.fused_mlp_enabled()
    config.set_fused_mlp(True)
    config.set_fused_mlp(False)
    assert not config.fused_mlp_enabled()


def test_gate_off_runs_no_fused_code(rng, monkeypatch):
    def boom(*args, **kw):
        raise AssertionError("fused code ran with the gate off")

    for fn in ("fused_chain_eval", "dense_fwd", "pool_fwd", "affine_fwd"):
        monkeypatch.setattr(tfm, fn, boom)
    model = MODEL_REGISTRY["pointnet2_cls_msg"].cls(device="cpu").eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(rng.rand(B, 128, 3).astype(np.float32)))
    assert out.shape == (B, 40)


# (name, JAX layer, port layer, inputs): layers that never take the fused
# chain, in either package, with the gate on
_NEVER = [
    ("sa fuse_first=False",
     lambda: jnn.SetAbstraction(16, 0.3, 8, (8, 16), fuse_first=False),
     lambda: tnn.SetAbstraction(16, 0.3, 8, 5, (8, 16), fuse_first=False),
     "sa"),
    ("sa group_all",
     lambda: jnn.SetAbstraction(None, None, None, (8, 16), group_all=True),
     lambda: tnn.SetAbstraction(None, None, None, 5, (8, 16),
                                group_all=True), "sa"),
    ("sa avg pooling",
     lambda: jnn.SetAbstraction(16, 0.3, 8, (8, 16), pooling="avg"),
     lambda: tnn.SetAbstraction(16, 0.3, 8, 5, (8, 16), pooling="avg"),
     "sa"),
    ("msg fuse_first=False",
     lambda: jnn.SetAbstractionMSG(16, (0.2, 0.4), (8, 8), ((8, 16),) * 2,
                                   fuse_first=False),
     lambda: tnn.SetAbstractionMSG(16, (0.2, 0.4), (8, 8), 5,
                                   ((8, 16),) * 2, fuse_first=False), "sa"),
    ("sa ineligible rows",  # 1 * 3 * 5 rows: no power-of-two tile >= 16
     lambda: jnn.SetAbstraction(3, 0.3, 5, (8, 16)),
     lambda: tnn.SetAbstraction(3, 0.3, 5, 5, (8, 16)), "sa1"),
    ("sa single layer",
     lambda: jnn.SetAbstraction(16, 0.3, 8, (16,)),
     lambda: tnn.SetAbstraction(16, 0.3, 8, 5, (16,)), "sa"),
    ("sa bn=False",
     lambda: jnn.SetAbstraction(16, 0.3, 8, (8, 16), bn=False),
     lambda: tnn.SetAbstraction(16, 0.3, 8, 5, (8, 16), bn=False), "sa"),
    ("feature propagation",
     lambda: jnn.FeaturePropagation((8, 16)),
     lambda: tnn.FeaturePropagation(5, 4, (8, 16)), "fp"),
]


def _never_inputs(rng, kind):
    if kind == "fp":
        return (rng.rand(B, 64, 3).astype(np.float32),
                rng.rand(B, 16, 3).astype(np.float32),
                rng.randn(B, 64, 4).astype(np.float32),
                rng.randn(B, 16, 5).astype(np.float32))
    b = 1 if kind == "sa1" else B
    return (rng.rand(b, 64, 3).astype(np.float32),
            rng.randn(b, 64, 5).astype(np.float32))


@pytest.mark.parametrize("case", _NEVER, ids=[c[0] for c in _NEVER])
def test_layers_that_never_take_the_fused_chain(rng, count_chains, case):
    """With the gate on, these layers run no fused chain in either package,
    and the port's output is the gate-off output bit for bit."""
    _, jmake, tmake, kind = case
    args = _never_inputs(rng, kind)
    tmod = tmake()
    got, want = _pair(jmake(), tmod, args, 60)
    assert count_chains == {"jax": 0, "torch": 0}
    with torch.inference_mode():
        off = tmod(*[torch.from_numpy(a) for a in args])
    got, off = (got[1], off[1]) if isinstance(got, tuple) else (got, off)
    want = want[1] if isinstance(want, tuple) else want
    assert torch.equal(got, off)
    _close(got, want, "f32")


def test_train_mode_with_the_gate_on_runs_the_fused_chain(rng, count_chains):
    """A train-mode SA or MSG layer with the gate on runs the train-mode
    fused chain (it used to raise NotImplementedError), and is
    differentiable; the same layer in eval mode runs the eval chain, and a
    backward through that raises, as in the JAX package."""
    sa = tnn.SetAbstraction(16, 0.3, 8, 0, (8, 16)).train()
    xyz = torch.from_numpy(rng.rand(B, 64, 3).astype(np.float32))
    with config.fused_mlp(True):
        _, out, _ = sa(xyz, None)
    assert count_chains["torch"] == 1
    out.square().sum().backward()
    assert all(p.grad is not None for p in sa.parameters())
    msg = tnn.SetAbstractionMSG(16, (0.2,), (8,), 0, ((8, 16),)).train()
    with config.fused_mlp(True):
        msg(xyz, None)
    assert count_chains["torch"] == 2
    sa.eval()
    with config.fused_mlp(True):
        _, out, _ = sa(xyz, None)
    assert count_chains["torch"] == 3
    with pytest.raises(RuntimeError, match="not differentiable"):
        out.sum().backward()
    sa.train()(xyz, None)  # the gate off: the unfused train-mode forward
    assert count_chains["torch"] == 3


def test_trainer_epoch_with_the_gate_on_trains_fused(tmp_path, count_chains):
    """A Trainer epoch of pointnet2_cls_ssg with the gate on trains through
    the fused chain, two chains a step (it used to raise
    NotImplementedError), and leaves finite weights."""
    from pointnet2_tpu_torch.data import SyntheticClassification
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(batch_size=2, num_point=64, max_epoch=1,
                      log_dir=str(tmp_path))
    data = SyntheticClassification(num_classes=4, samples_per_class=1,
                                   npoints=64, batch_size=2, seed=0)
    with Trainer(cfg, device="cpu") as tr:
        state = tr.init_state()
        with config.fused_mlp(True):
            state = tr.train_epoch(state, data, 0)
    assert state.step == data.num_batches()
    assert count_chains["torch"] == 2 * state.step
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


@pytest.mark.parametrize("name", ["pointnet2_sem_seg", "pointnet2_part_seg",
                                  "pointnet2_part_seg_msg_one_hot"])
def test_segmenters_fused_match_unfused(rng, count_chains, name):
    """The port's fused route against its own unfused route, f32, on the
    seg models (whose FP layers stay unfused)."""
    chans = {"pointnet2_sem_seg": 9}.get(name, 6)
    model = MODEL_REGISTRY[name].cls(device="cpu").eval()
    args = [torch.from_numpy(rng.rand(B, 128, chans).astype(np.float32))]
    if name.endswith("one_hot"):
        args.append(torch.tensor([1, 5], dtype=torch.int32))
    with torch.inference_mode():
        want = model(*args)
        with config.fused_mlp(True):
            got = model(*args)
    assert count_chains["torch"] == {"pointnet2_sem_seg": 4,
                                     "pointnet2_part_seg": 2}.get(name, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL * np.abs(want.numpy()).max())


# ---------------------------------------------------------------------------
# the kernel wrappers on the CPU
# ---------------------------------------------------------------------------


def test_fused_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(16, 4)
    a = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["fused_dense"](x, a, a, torch.zeros(3, 4),
                                    torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["fused_pool"](x.reshape(4, 4, 4)[..., :4], a, a)
    with pytest.raises(ValueError, match="CUDA"):
        tops.KERNELS["fused_affine"](x, a, a)
    # the plain versions are what the CPU runs, and launch nothing
    before = {k: w.launches for k, w in tops.KERNELS.items()}
    tfm.dense_fwd(x, a, a, torch.zeros(3, 4), torch.zeros(3), True)
    tfm.pool_fwd(x.reshape(4, 4, 4), a, a)
    tfm.affine_fwd(x, a, a)
    assert {k: w.launches for k, w in tops.KERNELS.items()} == before


def test_eligibility_is_the_jax_rule():
    shapes = [(2, 4, 16, 8), (1, 3, 5, 8), (1, 1, 16, 8), (1, 1, 15, 8),
              (3, 8, 2, 4), (2, 3, 8, 4), (0, 4, 16, 8), (2, 16, 8)]
    for shape in shapes:
        for td, jd in DT.values():
            for n_dense in (0, 1, 2):
                assert (tfm.fused_chain_eligible(shape, td, n_dense)
                        == jfm.fused_chain_eligible(shape, jd, n_dense)), (
                    shape, td, n_dense)
    assert not tfm.fused_chain_eligible((2, 4, 16, 8), torch.float64, 1)
