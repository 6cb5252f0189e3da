"""Inputs of the data kind ``procedural_scannet``: blocks of ScanNet-like
rooms. The rooms are drawn from the seed by the port's procedural ScanNet
stand-in (``data/procedural_scannet.make_scene``, 60-180k points a room;
``portbench/tests/test_portbench_inputs.py`` holds it to frozen
readings), and tiled here as the port's ``predict_scene`` tiles a room:
columns of ``block_size_m`` grown by ``block_overlap_m`` on every side
(the same members as ``data/scannet.block_members``, a test holds them
equal), each column's points shuffled and cut into chunks of ``npoints``,
a short last chunk filled with points drawn again from its column.

``blocks(cfg, count, npoints, seed)``: the first ``count`` blocks, in the
order the rooms and their columns are drawn, as one (count, npoints, 3)
float32 array; its shape does not depend on the seed.
"""

from __future__ import annotations

import numpy as np


def tile_room(pts: np.ndarray, size: float, overlap: float, npoints: int,
              rng: np.random.Generator) -> list[np.ndarray]:
    """Blocks of ``npoints`` points of one room (module docstring)."""
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    nx = int(np.ceil((hi[0] - lo[0]) / size)) or 1
    ny = int(np.ceil((hi[1] - lo[1]) / size)) or 1
    xy = pts[:, :2] - lo[:2]
    blocks = []
    for bx in range(nx):
        for by in range(ny):
            x0, y0 = bx * size - overlap, by * size - overlap
            inside = ((xy[:, 0] >= x0)
                      & (xy[:, 0] < x0 + size + 2 * overlap)
                      & (xy[:, 1] >= y0)
                      & (xy[:, 1] < y0 + size + 2 * overlap))
            member = np.flatnonzero(inside)
            if len(member) == 0:
                continue
            rng.shuffle(member)
            for off in range(0, len(member), npoints):
                chunk = member[off:off + npoints]
                if len(chunk) < npoints:
                    extra = member[rng.integers(len(member),
                                                size=npoints - len(chunk))]
                    chunk = np.concatenate([chunk, extra])
                blocks.append(pts[chunk])
    return blocks


def blocks(cfg: dict, count: int, npoints: int, seed: int) -> np.ndarray:
    from pointnet2_tpu_torch.data.procedural_scannet import make_scene

    d = cfg["data"]
    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    while len(out) < count:
        room, _ = make_scene(rng, d["min_points"], d["max_points"])
        out += tile_room(room, cfg["block_size_m"], cfg["block_overlap_m"],
                         npoints, rng)
    return np.stack(out[:count]).astype(np.float32)
