"""The port's viewers and plots against the JAX package's, on the same
numpy inputs: the rest of ``utils/pc_util.py`` (volumes, images, the
three-view renderer: bit for bit; PLY IO: ascii and binary round trips
through the port's own reader), the ball renderer (the port's native
library bit for bit JAX's native library, the numpy fallbacks bit for
bit each other), the standard-library PNG writer and reader (against PIL),
``cli.visualize`` on the CPU (the PNGs as PIL decodes them equal to the
arrays rendered) and ``cli.plot_metrics`` (``load_metrics`` equal to
JAX's on a port run directory, the PNG written).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pointnet2_tpu.cli import plot_metrics as jplot
from pointnet2_tpu.utils import pc_util as jpc
from pointnet2_tpu.viz import viewer as jviewer
from pointnet2_tpu_torch.cli import plot_metrics, visualize
from pointnet2_tpu_torch.utils import pc_util as tpc
from pointnet2_tpu_torch.utils import png
from pointnet2_tpu_torch.viz import viewer


@pytest.fixture(autouse=True)
def one_thread():
    """Small models: one intra-op thread leaves the cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=300, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# pc_util: volumes, images, three views
# ---------------------------------------------------------------------------


def test_volumes_bit_for_bit():
    pts = np.random.default_rng(1).uniform(-0.95, 0.95, (400, 3)).astype(
        np.float32)
    vol = tpc.point_cloud_to_volume(pts, 8)
    np.testing.assert_array_equal(vol, jpc.point_cloud_to_volume(pts, 8))
    np.testing.assert_array_equal(tpc.volume_to_point_cloud(vol),
                                  jpc.volume_to_point_cloud(vol))
    for flatten in (True, False):
        np.testing.assert_array_equal(
            tpc.point_cloud_to_volume_batch(pts[None].repeat(2, 0), 6,
                                            flatten=flatten),
            jpc.point_cloud_to_volume_batch(pts[None].repeat(2, 0), 6,
                                            flatten=flatten))
    # the per-voxel samples draw from numpy's global stream: same seed
    np.random.seed(3)
    got = tpc.point_cloud_to_volume_v2_batch(pts[None], 4, num_sample=16)
    np.random.seed(3)
    want = jpc.point_cloud_to_volume_v2_batch(pts[None], 4, num_sample=16)
    np.testing.assert_array_equal(got, want)


def test_images_bit_for_bit():
    pts = np.random.default_rng(2).uniform(-0.95, 0.95, (500, 3)).astype(
        np.float32)
    for size, ns in ((4, 8), (8, 64)):
        np.random.seed(5)
        got = tpc.point_cloud_to_image_batch(pts[None], size, num_sample=ns)
        np.random.seed(5)
        want = jpc.point_cloud_to_image_batch(pts[None], size, num_sample=ns)
        np.testing.assert_array_equal(got, want)


def test_three_views_bit_for_bit():
    pts = _cloud(200)
    img = tpc.point_cloud_three_views(pts)
    assert img.shape == (500, 1500) and img.max() == 1.0
    np.testing.assert_array_equal(img, jpc.point_cloud_three_views(pts))
    np.testing.assert_array_equal(
        tpc.draw_point_cloud(pts, canvasSize=120, space=40, diameter=7,
                             switch_xyz=(2, 0, 1), yrot=0.3),
        jpc.draw_point_cloud(pts, canvasSize=120, space=40, diameter=7,
                             switch_xyz=(2, 0, 1), yrot=0.3))
    assert not tpc.draw_point_cloud(np.zeros((0, 3))).any()


# ---------------------------------------------------------------------------
# PLY IO
# ---------------------------------------------------------------------------


def test_ply_ascii_round_trip_and_jax_bytes(tmp_path):
    pts = _cloud(50)
    ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    tpc.write_ply(pts, ours)
    jpc.write_ply(pts, theirs)  # no plyfile here: JAX's ascii writer
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(tpc.read_ply(ours), jpc.read_ply(theirs))
    np.testing.assert_allclose(tpc.read_ply_xyz(ours), pts, atol=1e-6)


def test_ply_binary_round_trip(tmp_path):
    pts = _cloud(70, seed=4)
    path = str(tmp_path / "b.ply")
    tpc.write_ply(pts, path, text=False)
    assert b"format binary_little_endian 1.0" in open(path, "rb").read(100)
    got = tpc.read_ply(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pts)


def _scannet_like_ply(path, xyz, rgb, fmt):
    """A ScanNet _vh_clean_2.ply-like file: a comment, vertices with
    x y z red green blue alpha, then a face element of vertex lists."""
    n = len(xyz)
    header = (f"ply\nformat {fmt} 1.0\ncomment made by a test\n"
              f"element vertex {n}\nproperty float x\nproperty float y\n"
              "property float z\nproperty uchar red\nproperty uchar green\n"
              "property uchar blue\nproperty uchar alpha\n"
              "element face 2\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    order = "<" if fmt == "binary_little_endian" else ">"
    dt = np.dtype([("x", order + "f4"), ("y", order + "f4"),
                   ("z", order + "f4"), ("red", "u1"), ("green", "u1"),
                   ("blue", "u1"), ("alpha", "u1")])
    v = np.empty(n, dt)
    v["x"], v["y"], v["z"] = xyz.T
    v["red"], v["green"], v["blue"] = rgb.T
    v["alpha"] = 255
    with open(path, "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            for row in v:
                f.write((" ".join(repr(float(x)) if i < 3 else str(int(x))
                                  for i, x in enumerate(row)) + "\n")
                        .encode())
            f.write(b"3 0 1 2\n3 1 2 3\n")
        else:
            f.write(v.tobytes())
            f.write(np.array([3], "u1").tobytes()
                    + np.array([0, 1, 2], order + "i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
def test_read_ply_xyzrgb_formats(tmp_path, fmt):
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    path = str(tmp_path / "s.ply")
    _scannet_like_ply(path, xyz, rgb, fmt)
    got = tpc.read_ply_xyzrgb(path)
    assert got.shape == (40, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :3], xyz)
    np.testing.assert_array_equal(got[:, 3:], rgb)


def test_read_ply_skips_elements_before_the_vertices(tmp_path):
    path = tmp_path / "c.ply"
    path.write_text("ply\nformat ascii 1.0\nelement camera 1\n"
                    "property float fov\nelement vertex 2\n"
                    "property double x\nproperty double y\n"
                    "property double z\nend_header\n0.5\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(tpc.read_ply(str(path)),
                                  [[1, 2, 3], [4, 5, 6]])
    (tmp_path / "bad.ply").write_text("not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tpc.read_ply(str(tmp_path / "bad.ply"))


def test_colored_ply_writers_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.random((20, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 20)
    colors = rng.integers(0, 300, (20, 3))
    for fn, arg in (("write_ply_color", labels), ("write_ply_rgb", colors)):
        a, b = str(tmp_path / f"{fn}_a.ply"), str(tmp_path / f"{fn}_b.ply")
        getattr(tpc, fn)(pts, arg, a)
        getattr(jpc, fn)(pts, arg, b)
        assert open(a, "rb").read() == open(b, "rb").read()
        back = tpc.read_ply_xyzrgb(a)
        np.testing.assert_allclose(back[:, :3], pts, atol=1e-6)


# ---------------------------------------------------------------------------
# the ball renderer and PNG files
# ---------------------------------------------------------------------------


def test_native_renderer_bit_for_bit_jax():
    assert viewer.native_library() is not None, viewer.build_error()
    assert os.path.basename(viewer.native_library()).startswith(
        "librender_balls-")
    assert "_build" in viewer.native_library()
    pts = _cloud(400, seed=8)
    colors = np.random.default_rng(9).integers(0, 256, (400, 3)).astype(
        np.uint8)
    rot = jviewer._rotmat(0.3, -0.7)
    for kw in ({}, {"colors": colors, "ballradius": 4, "rot": rot},
               {"colors": colors[0], "background": (10, 20, 30),
                "normalize": False}):
        got = viewer.render(pts, canvas=160, **kw)
        want = jviewer.render(pts, canvas=160, **kw)
        assert got.shape == (160, 160, 3) and got.any()
        np.testing.assert_array_equal(got, want)


def test_numpy_fallback_bit_for_bit_jax():
    pts = _cloud(60, seed=10)
    proj = pts.copy()
    proj[:, :2] = proj[:, :2] * 20 + 64
    colors = np.random.default_rng(11).integers(0, 256, (60, 3)).astype(
        np.uint8)
    radii = np.full(60, 3.0, np.float32)
    got = viewer._render_numpy(128, 128, proj, colors, radii)
    want = jviewer._render_numpy(128, 128, proj, colors, radii)
    assert got.any()
    np.testing.assert_array_equal(got, want)


def test_render_falls_back_without_the_library(monkeypatch):
    pts = _cloud(50, seed=12)
    native = viewer.render(pts, canvas=96, ballradius=3)
    monkeypatch.setattr(viewer, "_lib", False)
    fallback = viewer.render(pts, canvas=96, ballradius=3)
    # same geometry: the two differ only where a pixel's shade rounds
    assert fallback.any()
    assert np.mean(np.abs(native.astype(int) - fallback) > 1) < 0.01


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (4, 4, 4)])
def test_png_writer_decoded_by_pil(tmp_path, shape):
    img = np.random.default_rng(13).integers(0, 256, shape).astype(np.uint8)
    path = png.write_png(img, str(tmp_path / "x.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    gray = np.linspace(0, 1.2, 30).reshape(5, 6)
    path = png.write_png(gray, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(path)),
        (np.clip(gray, 0, 1) * 255).astype(np.uint8))


def test_png_reader_reads_pil_files(tmp_path):
    """PIL's encoder picks its own row filters: the reader undoes each."""
    rng = np.random.default_rng(14)
    ramp = (np.arange(64 * 48 * 3).reshape(64, 48, 3) % 251).astype(np.uint8)
    for img in (ramp, ramp[..., 0], rng.integers(0, 256, (33, 17, 3),
                                                   dtype=np.uint8)):
        path = str(tmp_path / "p.png")
        Image.fromarray(img).save(path, optimize=True)
        np.testing.assert_array_equal(png.read_png(path), img)


# ---------------------------------------------------------------------------
# cli.visualize and cli.plot_metrics
# ---------------------------------------------------------------------------


def test_visualize_cloud(tmp_path):
    pts = _cloud(200, seed=15)
    ply = str(tmp_path / "c.ply")
    tpc.write_ply(pts, ply)
    out = str(tmp_path / "viz")
    written = visualize.main(["--cloud", ply, "--out", out, "--canvas",
                              "128", "--ballradius", "3"])
    assert sorted(os.path.basename(p) for p in written) == [
        "cloud.png", "cloud_three_views.png"]
    want = viewer.render(tpc.read_ply(ply), canvas=128, ballradius=3)
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(out, "cloud.png"))), want)
    views = tpc.point_cloud_three_views(tpc.read_ply(ply))
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(out, "cloud_three_views.png"))),
        (np.clip(views, 0, 1) * 255).astype(np.uint8))
    txt = str(tmp_path / "c.txt")
    np.savetxt(txt, np.concatenate([pts, pts], 1), delimiter=",")
    visualize.main(["--cloud", txt, "--out", out, "--canvas", "128",
                    "--ballradius", "3"])
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(out, "cloud.png"))),
        viewer.render(np.loadtxt(txt, delimiter=",")[:, :3], canvas=128,
                      ballradius=3))


@pytest.fixture(scope="module")
def cls_run(tmp_path_factory):
    """A one-epoch run of the port's cli.train on the CPU (the PointNet
    baseline: the point ops' plain versions make the PointNet++ models
    seconds a step here)."""
    from pointnet2_tpu_torch.cli import train as cli_train

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        log_dir = str(tmp_path_factory.mktemp("cls_run"))
        cli_train.main(["--model", "pointnet_cls_basic", "--synthetic",
                        "--synthetic_size", "1", "--num_point", "128",
                        "--batch_size", "8", "--max_epoch", "1",
                        "--log_dir", log_dir, "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    return log_dir


def test_visualize_classifier_checkpoint(cls_run, tmp_path):
    out = str(tmp_path / "viz")
    written = visualize.main([
        "--model", "pointnet_cls_basic", "--synthetic", "--synthetic_size",
        "1", "--num_point", "128", "--log_dir", cls_run, "--num_samples",
        "2", "--canvas", "96", "--out", out, "--device", "cpu"])
    assert len(written) == 2
    assert all(os.path.basename(p).startswith(f"sample{i}_pred")
               for i, p in enumerate(written))
    with open(os.path.join(cls_run, "log_train.txt")) as f:
        assert "restored ckpt at step" in f.read()
    for p in written:
        img = np.asarray(Image.open(p))
        assert img.shape == (96, 96, 3) and img.any()
        np.testing.assert_array_equal(png.read_png(p), img)


def test_visualize_part_segmenter_untrained(tmp_path):
    out = str(tmp_path / "viz")
    log_dir = str(tmp_path / "log")
    written = visualize.main([
        "--model", "pointnet2_part_seg", "--synthetic",
        "--num_point", "128", "--log_dir", log_dir, "--num_samples", "1",
        "--canvas", "96", "--out", out, "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in written) == [
        "sample0_gt.png", "sample0_seg.png"]
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        assert "no checkpoint found" in f.read()
    gt = np.asarray(Image.open(written[0]))
    assert gt.shape == (96, 96, 3) and len(np.unique(gt.reshape(-1, 3),
                                                     axis=0)) > 2


def test_plot_metrics_on_a_port_run(cls_run, tmp_path):
    ours = plot_metrics.load_metrics(cls_run)
    assert ours == jplot.load_metrics(cls_run)
    assert ("train", "loss") in ours and ("eval", "accuracy") in ours
    out = str(tmp_path / "curves.png")
    plot_metrics.main([cls_run, "--out", out])
    img = np.asarray(Image.open(out))
    assert img.ndim == 3 and img.shape[0] > 100


def test_plot_metrics_torn_line(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rows = [{"epoch": 0, "split": "train", "loss": 2.0, "step": 10},
            {"epoch": 1, "split": "train", "loss": 1.0, "step": 20},
            {"split": "eval", "accuracy": 0.3}]
    with open(run / "metrics.jsonl", "w") as fp:
        for r in rows:
            fp.write(json.dumps(r) + "\n")
        fp.write('{"torn line\n')
    got = plot_metrics.load_metrics(str(run))
    assert got == jplot.load_metrics(str(run))
    assert got == {("train", "loss"): [(0.0, 2.0), (1.0, 1.0)]}
