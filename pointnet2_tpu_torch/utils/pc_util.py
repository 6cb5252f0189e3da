"""Point-cloud conversion, IO and rendering utilities.

The port's copy of pointnet2_tpu/utils/pc_util.py (the reference's
utils/pc_util.py and scannet/pc_util.py), numpy throughout:

- surface-voxel label voting of the ScanNet voxel-accuracy protocol
  (exact majority and the first-point variant, scannet/pc_util.py:23-51);
- point cloud <-> occupancy volume and per-voxel / per-pixel samples;
- PLY IO. The port reads PLY itself (no ``plyfile``, which the JAX package
  prefers when installed): the header is parsed and the vertex element
  read as a numpy structured array, in ``ascii``, ``binary_little_endian``
  or ``binary_big_endian`` (ScanNet's ``_vh_clean_2.ply`` is binary);
  ``write_ply`` writes ascii, as the JAX package without ``plyfile`` does,
  or ``binary_little_endian`` with ``text=False``;
- the z-buffered Gaussian-disk renderer and the canonical three views
  (utils/pc_util.py:176-315), bit for bit the JAX package's;
- the pyplot dumps, whose matplotlib import waits for the call.
"""

from __future__ import annotations

import numpy as np


def _voxel_index(point_cloud, res):
    """Per-point voxel index and the grid's extent in voxels.

    The per-axis index can reach nvox (the max-coordinate point) while nvox
    is also the stride, so voxel (nvox0, y, z) aliases (0, y+1, z). The
    reference has the same formula; it is kept bit for bit, since the
    protocol's voxel accuracy depends on it."""
    coordmin = point_cloud.min(axis=0)
    nvox = np.ceil((point_cloud.max(axis=0) - coordmin) / res)
    vidx = np.ceil((point_cloud - coordmin) / res)
    vidx = vidx[:, 0] + vidx[:, 1] * nvox[0] + vidx[:, 2] * nvox[0] * nvox[1]
    return vidx, nvox


def point_cloud_label_to_surface_voxel_label(point_cloud, label, res=0.0484):
    """Majority label per occupied voxel. label: (N,) or (N, K).
    Returns (voxel ids, their labels, nvox)."""
    vidx, nvox = _voxel_index(point_cloud, res)
    uvidx, inverse = np.unique(vidx, return_inverse=True)
    label2d = label[:, None] if label.ndim == 1 else label
    uvlabel = np.zeros((len(uvidx), label2d.shape[1]), label2d.dtype)
    for k in range(label2d.shape[1]):
        # majority vote by a 2-D bincount over (voxel, class)
        ncls = int(label2d[:, k].max()) + 1
        counts = np.zeros((len(uvidx), ncls), np.int64)
        np.add.at(counts, (inverse, label2d[:, k].astype(np.int64)), 1)
        uvlabel[:, k] = counts.argmax(axis=1)
    return uvidx, (uvlabel[:, 0] if label.ndim == 1 else uvlabel), nvox


def point_cloud_label_to_surface_voxel_label_fast(point_cloud, label,
                                                  res=0.0484):
    """First point's label per occupied voxel (the variant behind the
    reference's ScanNet voxel accuracy). Returns (voxel ids, labels,
    nvox)."""
    vidx, nvox = _voxel_index(point_cloud, res)
    uvidx, vpidx = np.unique(vidx, return_index=True)
    uvlabel = label[vpidx] if label.ndim == 1 else label[vpidx, :]
    return uvidx, uvlabel, nvox


# ----------------------------------------------------------------------
# Point cloud <-> volume
# ----------------------------------------------------------------------

def point_cloud_to_volume(points, vsize, radius=1.0):
    """(N,3) in [-radius, radius] -> binary occupancy (vsize^3)."""
    vol = np.zeros((vsize, vsize, vsize), np.float32)
    voxel = 2 * radius / float(vsize)
    loc = ((points + radius) / voxel).astype(int)
    keep = ((loc >= 0) & (loc < vsize)).all(axis=1)
    loc = loc[keep]
    vol[loc[:, 0], loc[:, 1], loc[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds, vsize=12, radius=1.0,
                                flatten=True):
    vols = [point_cloud_to_volume(pc, vsize, radius) for pc in point_clouds]
    if flatten:
        return np.stack([v.reshape(-1) for v in vols])
    return np.stack(vols)[..., None]


def volume_to_point_cloud(vol):
    """Occupancy grid -> (N,3) voxel coordinates."""
    return np.argwhere(vol == 1).astype(np.float64)


def _cell_groups(flat):
    """(start, end) of each run of equal cell ids in the sorted ``flat``."""
    starts = np.searchsorted(flat, np.unique(flat))
    bounds = np.append(starts, len(flat))
    return zip(bounds[:-1], bounds[1:])


def _fixed_count(pc, num_sample):
    """``num_sample`` rows of ``pc``: a random subset (the global numpy
    stream, as the JAX package draws) or edge padding."""
    if pc.shape[0] > num_sample:
        pc = pc[np.random.choice(pc.shape[0], num_sample, replace=False)]
    elif pc.shape[0] < num_sample:
        pc = np.pad(pc, ((0, num_sample - pc.shape[0]), (0, 0)), "edge")
    return pc


def point_cloud_to_volume_v2(points, vsize, radius=1.0, num_sample=128):
    """(N,3) -> (vsize,vsize,vsize,num_sample,3): num_sample points per
    voxel (random subsample / edge-pad), centered and scaled per voxel."""
    vol = np.zeros((vsize, vsize, vsize, num_sample, 3), np.float32)
    voxel = 2 * radius / float(vsize)
    loc = ((points + radius) / voxel).astype(int)
    keep = ((loc >= 0) & (loc < vsize)).all(axis=1)
    points, loc = points[keep], loc[keep]
    flat = loc[:, 0] * vsize * vsize + loc[:, 1] * vsize + loc[:, 2]
    order = np.argsort(flat, kind="stable")
    flat, points, loc = flat[order], points[order], loc[order]
    for s, e in _cell_groups(flat):
        i, j, k = loc[s]
        pc = _fixed_count(points[s:e], num_sample)
        center = (np.array([i, j, k]) + 0.5) * voxel - radius
        vol[i, j, k] = (pc - center) / voxel
    return vol


def point_cloud_to_volume_v2_batch(point_clouds, vsize=12, radius=1.0,
                                   num_sample=128):
    return np.stack([point_cloud_to_volume_v2(pc, vsize, radius, num_sample)
                     for pc in point_clouds])


def point_cloud_to_image(points, imgsize, radius=1.0, num_sample=128):
    """(N,3) -> (imgsize,imgsize,num_sample,3) xy-pixel binned samples."""
    img = np.zeros((imgsize, imgsize, num_sample, 3), np.float32)
    pixel = 2 * radius / float(imgsize)
    loc = ((points[:, 0:2] + radius) / pixel).astype(int)
    keep = ((loc >= 0) & (loc < imgsize)).all(axis=1)
    points, loc = points[keep], loc[keep]
    flat = loc[:, 0] * imgsize + loc[:, 1]
    order = np.argsort(flat, kind="stable")
    flat, points, loc = flat[order], points[order], loc[order]
    for s, e in _cell_groups(flat):
        i, j = loc[s]
        pc = _fixed_count(points[s:e].copy(), num_sample)
        center = (np.array([i, j]) + 0.5) * pixel - radius
        pc[:, 0:2] = (pc[:, 0:2] - center) / pixel
        img[i, j] = pc
    return img


def point_cloud_to_image_batch(point_clouds, imgsize, radius=1.0,
                               num_sample=128):
    return np.stack([point_cloud_to_image(pc, imgsize, radius, num_sample)
                     for pc in point_clouds])


# ----------------------------------------------------------------------
# PLY IO
# ----------------------------------------------------------------------

_PLY_TYPES = {"char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
              "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
              "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
              "float": "f4", "float32": "f4", "double": "f8",
              "float64": "f8"}
_PLY_FORMATS = {"ascii": None, "binary_little_endian": "<",
                "binary_big_endian": ">"}


def _ply_header(f):
    """Parse a PLY header from binary file ``f`` (left at the body):
    (format, [(element name, count, [(property, type or ("list", count
    type, item type))])])."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("PLY header has no end_header")
        words = line.decode("ascii", "replace").split()
        if not words or words[0] in ("comment", "obj_info"):
            continue
        if words[0] == "end_header":
            break
        if words[0] == "format":
            fmt = words[1]
            if fmt not in _PLY_FORMATS:
                raise ValueError(f"unknown PLY format {fmt}")
        elif words[0] == "element":
            elements.append((words[1], int(words[2]), []))
        elif words[0] == "property":
            if words[1] == "list":
                elements[-1][2].append((words[4], ("list", words[2],
                                                   words[3])))
            else:
                elements[-1][2].append((words[2], words[1]))
    if fmt is None:
        raise ValueError("PLY header has no format line")
    return fmt, elements


def read_ply_vertices(filename) -> np.ndarray:
    """A PLY file's vertex element as a numpy structured array (fields
    named as its properties: x, y, z, red, ...). Elements before the
    vertex element are skipped; in a binary file they may not hold list
    properties."""
    with open(filename, "rb") as f:
        fmt, elements = _ply_header(f)
        order = _PLY_FORMATS[fmt]
        for name, count, props in elements:
            if any(isinstance(t, tuple) for _, t in props):
                if name == "vertex":
                    raise ValueError("list properties in the vertex "
                                     "element are not read")
                if order is not None:
                    raise ValueError(f"cannot skip binary element {name} "
                                     "with list properties")
            if order is None:
                dtype = np.dtype([(p, _PLY_TYPES[t]) for p, t in props]
                                 if name == "vertex" else [])
            else:
                dtype = np.dtype([(p, order + _PLY_TYPES[t])
                                  for p, t in props])
            if name != "vertex":
                if order is None:
                    for _ in range(count):
                        f.readline()
                else:
                    f.seek(count * dtype.itemsize, 1)
                continue
            if order is not None:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype,
                                     count)
                return data.astype(dtype.newbyteorder("="))
            # each value through float64, as np.loadtxt reads it
            rows = [f.readline().split() for _ in range(count)]
            if any(len(r) != len(props) for r in rows):
                raise ValueError(f"{filename}: a vertex line does not hold "
                                 f"{len(props)} values")
            cols = np.array(rows, np.float64).reshape(count, len(props))
            out = np.empty(count, dtype)
            for i, (p, _) in enumerate(props):
                out[p] = cols[:, i]
            return out
    raise ValueError(f"{filename}: no vertex element")


def read_ply(filename):
    """Read an xyz point cloud from a PLY file -> (N,3)."""
    v = read_ply_vertices(filename)
    return np.stack([v["x"], v["y"], v["z"]], axis=-1)


_XYZ_HEADER = ("property float x\nproperty float y\nproperty float z\n")
_RGB_HEADER = ("property uchar red\nproperty uchar green\n"
               "property uchar blue\n")


def write_ply(points, filename, text=True):
    """Write (N,3) points to a PLY file: ascii (``%.6f``), or
    binary_little_endian float32 with ``text=False``."""
    pts = np.asarray(points)[:, :3]
    fmt = "ascii" if text else "binary_little_endian"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {len(pts)}\n"
              + _XYZ_HEADER + "end_header\n")
    if text:
        with open(filename, "w") as f:
            f.write(header)
            np.savetxt(f, pts, fmt="%.6f")
        return
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(pts, "<f4").tobytes())


def _write_colored(points, colors, filename):
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\n"
                + _XYZ_HEADER + _RGB_HEADER + "end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def write_ply_color(points, labels, filename, num_classes=None):
    """Colored PLY by per-point label (scannet/pc_util.py capability)."""
    labels = labels.astype(int)
    num_classes = num_classes or int(labels.max()) + 1
    rng = np.random.default_rng(0)
    colors = (rng.random((num_classes, 3)) * 255).astype(np.uint8)
    _write_colored(points, colors[labels], filename)


def write_ply_rgb(points, colors, filename):
    """Per-point RGB PLY (scannet/pc_util.py:371, used by the ScanNet
    preprocessing demo to dump colored scenes)."""
    colors = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
    _write_colored(points, colors, filename)


def read_ply_xyz(filename):
    """Alias for read_ply (scannet/pc_util.py:212 capability)."""
    return read_ply(filename)


def read_ply_xyzrgb(filename):
    """Read xyz + rgb from a PLY file -> (N, 6) (scannet/pc_util.py:224;
    also data/scannet_preprocessing.py), stacked as the JAX package stacks
    plyfile's columns: float32 for float32 coordinates and uchar colours."""
    v = read_ply_vertices(filename)
    return np.stack([v["x"], v["y"], v["z"],
                     v["red"], v["green"], v["blue"]], axis=-1)


# ----------------------------------------------------------------------
# Renderers
# ----------------------------------------------------------------------

def _euler2mat(z=0.0, y=0.0, x=0.0):
    """Rotation matrix from z-y-x Euler angles (replaces the reference's
    missing `eulerangles` import, utils/pc_util.py:13)."""
    Ms = []
    if z:
        c, s = np.cos(z), np.sin(z)
        Ms.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    if y:
        c, s = np.cos(y), np.sin(y)
        Ms.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    if x:
        c, s = np.cos(x), np.sin(x)
        Ms.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    M = np.eye(3)
    for m in Ms:
        M = M @ m
    return M


def draw_point_cloud(input_points, canvasSize=500, space=200, diameter=25,
                     xrot=0.0, yrot=0.0, zrot=0.0, switch_xyz=(0, 1, 2),
                     normalize=True):
    """Render points to a gray z-buffered Gaussian-splat image."""
    image = np.zeros((canvasSize, canvasSize))
    if input_points is None or input_points.shape[0] == 0:
        return image
    points = input_points[:, list(switch_xyz)]
    points = (_euler2mat(zrot, yrot, xrot) @ points.T).T
    if normalize:
        points = points - points.mean(axis=0)
        points /= np.max(np.sqrt(np.sum(points ** 2, axis=-1)))

    radius = (diameter - 1) / 2.0
    ii, jj = np.mgrid[0:diameter, 0:diameter]
    disk = np.where((ii - radius) ** 2 + (jj - radius) ** 2 <= radius ** 2,
                    np.exp((-(ii - radius) ** 2 - (jj - radius) ** 2)
                           / radius ** 2), 0.0)
    mask = np.argwhere(disk > 0)
    dx, dy = mask[:, 0], mask[:, 1]
    dv = disk[disk > 0]

    zorder = np.argsort(points[:, 2])
    points = points[zorder]
    zmin, zmax = points[:, 2].min(), points[:, 2].max()
    depth = (points[:, 2] - zmin) / max(zmax - zmin, 1e-12)
    max_depth = depth.max()

    for j in range(points.shape[0] - 1, -1, -1):
        xc = int(round(canvasSize / 2 + points[j, 0] * space))
        yc = int(round(canvasSize / 2 + points[j, 1] * space))
        px, py = dx + xc, dy + yc
        ok = (px >= 0) & (px < canvasSize) & (py >= 0) & (py < canvasSize)
        image[px[ok], py[ok]] = (image[px[ok], py[ok]] * 0.7
                                 + dv[ok] * (max_depth - depth[j]) * 0.3)
    m = image.max()
    return image / m if m > 0 else image


def point_cloud_three_views(points):
    """(N,3) with +y up -> (500, 1500) gray image of three canonical views."""
    img1 = draw_point_cloud(points, zrot=110 / 180.0 * np.pi,
                            xrot=45 / 180.0 * np.pi)
    img2 = draw_point_cloud(points, zrot=70 / 180.0 * np.pi,
                            xrot=135 / 180.0 * np.pi)
    img3 = draw_point_cloud(points, zrot=np.pi, xrot=90 / 180.0 * np.pi)
    return np.concatenate([img1, img2, img3], axis=1)


def point_cloud_three_views_demo(ply_path, out_path="point_cloud_demo.png"):
    """Render a PLY to a three-view gray PNG (utils/pc_util.py:269
    capability), written by the standard library (utils/png.py)."""
    from pointnet2_tpu_torch.utils.png import write_png

    return write_png(point_cloud_three_views(read_ply(ply_path)), out_path)


# ----------------------------------------------------------------------
# Matplotlib wrappers (utils/pc_util.py:281-298), imported at the call
# ----------------------------------------------------------------------

def pyplot_draw_point_cloud(points, output_filename):
    """3D scatter of (N,3) points to an image file (matplotlib required)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=2)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.savefig(output_filename)
    plt.close(fig)


def pyplot_draw_volume(vol, output_filename):
    """Occupancy volume -> 3D scatter image (utils/pc_util.py:292)."""
    pyplot_draw_point_cloud(volume_to_point_cloud(vol), output_filename)
