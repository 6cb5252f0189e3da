"""Point-cloud viewer: the native C++ ball rasterizer and the interactive
loop.

Port of pointnet2_tpu/viz/viewer.py (the reference viewer's capabilities,
utils/show3d_balls.py:25-157): z-buffered shaded-ball rendering,
per-point colors and ball size, rotation and zoom. Headless use,
``render(points, ...) -> (H, W, 3) uint8``, works everywhere; the
interactive ``showpoints`` needs OpenCV and a display.

The rasterizer (``render_balls.cpp``, beside this file) is a host renderer,
not a device kernel. It is built with ``g++ -O3 -shared -fPIC`` at its
first use into the port's git-ignored ``_build/`` directory, named by a
hash of the source and the flags (an edited source rebuilds), never next to
the source, and loaded with ctypes. Where no compiler is found, or the
build fails, ``render`` takes the numpy fallback, as the JAX package does;
``native_library()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("render_balls.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None  # None: not tried yet; False: the numpy fallback
_build_error = ""


def _target() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"librender_balls-{h.hexdigest()[:12]}.so"


def _build(target: Path) -> None:
    """g++ into a temporary name, then an atomic rename (several
    processes may build at once)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def _load_lib():
    """The loaded library, or False for the numpy fallback."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        target = _target()
        try:
            if not target.is_file():
                _build(target)
            lib = ctypes.CDLL(str(target))
            lib.render_balls.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.render_balls.restype = None
            lib.path = str(target)
            _lib = lib
        except subprocess.CalledProcessError as e:
            _build_error = f"g++ failed: {e.stderr.strip()[-2000:]}"
            _lib = False
        except OSError as e:  # no g++, or the library does not load
            _build_error = f"{type(e).__name__}: {e}"
            _lib = False
        return _lib


def native_library() -> str | None:
    """Path of the loaded native renderer, or None when ``render`` runs
    the numpy fallback (``build_error()`` says why)."""
    lib = _load_lib()
    return lib.path if lib else None


def build_error() -> str:
    """Why the native renderer did not load ('' when it did)."""
    _load_lib()
    return _build_error


def _render_numpy(h, w, xyz, colors, radii, image=None):
    """Vectorized fallback: nearest-point-wins per pixel, flat shading.
    `image` (background-initialized) is drawn into when given."""
    if image is None:
        image = np.zeros((h, w, 3), np.uint8)
    zbuf = np.full((h, w), -np.inf, np.float32)
    order = np.argsort(xyz[:, 2])  # far-to-near painter with z test
    for i in order:
        xf, yf, z = xyz[i]
        r = int(max(radii[i], 1))
        x, y = int(round(xf)), int(round(yf))
        x0, x1 = max(x - r, 0), min(x + r + 1, h)
        y0, y1 = max(y - r, 0), min(y + r + 1, w)
        if x0 >= x1 or y0 >= y1:
            continue
        gx, gy = np.mgrid[x0:x1, y0:y1]
        # exact float centers, matching the C++ rasterizer's geometry
        d2 = (gx - xf) ** 2 + (gy - yf) ** 2
        inside = d2 <= r * r
        dz = np.sqrt(np.maximum(r * r - d2, 0))
        zs = z + dz
        upd = inside & (zs > zbuf[x0:x1, y0:y1])
        zbuf[x0:x1, y0:y1][upd] = zs[upd]
        shade = (0.35 + 0.65 * dz / max(r, 1))[upd]
        image[x0:x1, y0:y1][upd] = (colors[i] * shade[:, None]).astype(np.uint8)
    return image


def render(points: np.ndarray, colors: np.ndarray | None = None,
           canvas: int = 800, ballradius: int = 10, background=(0, 0, 0),
           normalize: bool = True, rot: np.ndarray | None = None) -> np.ndarray:
    """Render (N, 3) points to a (canvas, canvas, 3) uint8 image."""
    pts = np.asarray(points, np.float32).copy()
    n = len(pts)
    if colors is None:
        colors = np.full((n, 3), 255, np.uint8)
    else:
        colors = np.asarray(colors, np.uint8)
        if colors.ndim == 1:
            colors = np.broadcast_to(colors, (n, 3)).copy()
    if normalize and n:
        pts -= pts.mean(axis=0)
        scale = np.max(np.linalg.norm(pts, axis=1)) or 1.0
        pts /= scale
    if rot is not None:
        pts = pts @ np.asarray(rot, np.float32).T
    proj = np.empty_like(pts)
    proj[:, 0] = pts[:, 1] * canvas * 0.35 + canvas / 2  # row
    proj[:, 1] = pts[:, 0] * canvas * 0.35 + canvas / 2  # col
    proj[:, 2] = pts[:, 2]
    radii = np.full(n, float(ballradius), np.float32)

    lib = _load_lib()
    image = np.zeros((canvas, canvas, 3), np.uint8)
    image[:] = background
    if lib:
        # Bind the marshalled arrays to locals: the pointer of an
        # unreferenced temporary (astype(...).ctypes.data) may be reused
        # by the allocator while the C call runs.
        proj32 = np.ascontiguousarray(proj, np.float32)
        colors8 = np.ascontiguousarray(colors, np.uint8)
        lib.render_balls(canvas, canvas, image.ctypes.data, n,
                         proj32.ctypes.data, colors8.ctypes.data,
                         radii.ctypes.data)
    else:
        image = _render_numpy(canvas, canvas, proj, colors, radii,
                              image=image)
    return image


def _rotmat(xangle: float, yangle: float) -> np.ndarray:
    cy, sy = np.cos(yangle), np.sin(yangle)
    cx, sx = np.cos(xangle), np.sin(xangle)
    Ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]])
    return Rx @ Ry


def showpoints(points, colors=None, ballradius=10, canvas=800,
               background=(0, 0, 0)):
    """Interactive viewer (needs OpenCV and a display). Keys: q quit, n/m
    ball size, drag to rotate: the reference viewer's interaction model."""
    import cv2  # imported at the call: an optional dependency

    state = {"x": 0.0, "y": 0.0, "down": None, "r": ballradius}

    def on_mouse(event, x, y, flags, param):
        if event == cv2.EVENT_LBUTTONDOWN:
            state["down"] = (x, y, state["x"], state["y"])
        elif event == cv2.EVENT_LBUTTONUP:
            state["down"] = None
        elif event == cv2.EVENT_MOUSEMOVE and state["down"]:
            x0, y0, ax, ay = state["down"]
            state["y"] = ay + (x - x0) * 0.01
            state["x"] = ax + (y - y0) * 0.01

    cv2.namedWindow("pointnet2_tpu_torch viewer")
    cv2.setMouseCallback("pointnet2_tpu_torch viewer", on_mouse)
    while True:
        img = render(points, colors, canvas=canvas, ballradius=state["r"],
                     background=background,
                     rot=_rotmat(state["x"], state["y"]))
        cv2.imshow("pointnet2_tpu_torch viewer", img[:, :, ::-1])
        key = cv2.waitKey(16) & 0xFF
        if key == ord("q"):
            break
        if key == ord("n"):
            state["r"] = max(1, state["r"] - 1)
        if key == ord("m"):
            state["r"] += 1
    cv2.destroyAllWindows()
