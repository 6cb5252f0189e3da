"""The port's profiling helpers (``utils/profiling.py``) and its three demos
(``pointnet2_tpu_torch.examples``), on the CPU at reduced sizes.

- ``time_fn`` and ``time_op_loop`` time what they are given, beside the
  H100 peaks the module names; ``trace`` writes a Chrome trace naming the
  ops it saw (its spans: tests/test_torch_tracing.py).
- The mesh demo's reduced cloud is the farthest-point subset of its dense
  one, all on the icosahedron's surface; the interpolation demo's colours
  equal JAX's three_nn + three_interpolate on the same points within 1e-5;
  the scene demo labels every point of a generated room and writes its
  PNG.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pointnet2_tpu.ops import three_interpolate as j_interp
from pointnet2_tpu.ops import three_nn as j_three_nn
from pointnet2_tpu_torch.examples import (
    interpolation_demo,
    mesh_sampling_demo,
    scene_inference_demo,
)
from pointnet2_tpu_torch.ops import farthest_point_sample
from pointnet2_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_time_fn_and_op_loop():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.003)
        return x + 1

    x = torch.zeros(4)
    s = profiling.time_fn(fn, x, warmup=2, iters=3)
    assert len(calls) == 5 and 0.003 <= s < 0.5
    per = profiling.time_op_loop(lambda t: t @ t, torch.ones(64, 64),
                                 iters=10, repeats=3)
    assert 0 < per < 0.5
    assert profiling.H100_BF16_TFLOPS == 989.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            x = torch.mm(x, x).tanh()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(a.key == "aten::tanh" for a in prof.key_averages())


# ---------------------------------------------------------------------------
# the demos
# ---------------------------------------------------------------------------


def _on_icosahedron(pts, tris):
    """Every point lies in the plane of some face, within its corners."""
    a, b, c = tris[0, :, 0], tris[0, :, 1], tris[0, :, 2]
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    dist = np.abs(np.einsum("fk,pfk->pf", n, pts[:, None] - a[None]))
    return bool((dist.min(axis=1) < 1e-5).all())


def test_mesh_sampling_demo(tmp_path):
    out = mesh_sampling_demo.main([
        "--out", str(tmp_path), "--oversample", "2048", "--npoint", "256",
        "--canvas", "128", "--device", "cpu"])
    dense, reduced = out["dense"], out["reduced"]
    assert dense.shape == (1, 2048, 3) and reduced.shape == (1, 256, 3)
    idx = farthest_point_sample(torch.from_numpy(dense), 256).numpy()
    np.testing.assert_array_equal(reduced[0], dense[0, idx[0]])
    assert _on_icosahedron(dense[0], mesh_sampling_demo.icosahedron())
    for p in out["paths"]:
        assert np.asarray(Image.open(p)).shape == (128, 128, 3)


def test_interpolation_demo_equals_jax(tmp_path):
    out = interpolation_demo.main(["--out", str(tmp_path), "--dense", "512",
                                   "--canvas", "96", "--device", "cpu"])
    dist, idx = j_three_nn(jnp.asarray(out["dense_xyz"]),
                           jnp.asarray(out["sparse_xyz"]))
    dist = jnp.maximum(dist, 1e-10)
    inv = 1.0 / dist
    weight = inv / jnp.sum(inv, axis=2, keepdims=True)
    want = np.asarray(j_interp(jnp.asarray(out["sparse_color"]), idx,
                               weight))
    assert out["dense_color"].shape == (1, 512, 3)
    np.testing.assert_allclose(out["dense_color"], want, atol=1e-5)
    assert sorted(os.path.basename(p) for p in out["paths"]) == [
        "dense_interpolated.png", "sparse.png"]


def test_scene_inference_demo(tmp_path):
    png = str(tmp_path / "scene.png")
    out = scene_inference_demo.main([
        "--min_points", "3000", "--max_points", "4000", "--npoints", "1024",
        "--out", png, "--device", "cpu"])
    n = len(out["points"])
    assert 3000 <= n < 4000
    pred = out["pred"]
    assert pred["labels"].shape == (n,) and pred["votes"].min() >= 1
    assert 0.0 <= out["accuracy"] <= 1.0
    assert np.asarray(Image.open(png)).shape == (600, 1200, 3)
