"""PNG files from the standard library alone (``zlib`` + ``struct``).

The port's image writers (the visualize CLI, the demos, the three-view
renderer) write through here, so a machine without PIL or matplotlib still
writes images. ``write_png`` takes what the JAX package hands to PIL's
``Image.fromarray``: (H, W) or (H, W, 3) uint8 arrays; a float gray image
is scaled from [0, 1] first, as pointnet2_tpu/cli/visualize.py:37-42 does.
``read_png`` decodes 8-bit gray, gray+alpha, RGB and RGBA images, not
interlaced, with any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(image: np.ndarray) -> np.ndarray:
    """uint8 as given; a float image clipped to [0, 1] and scaled to 255
    (truncated, as ``(np.clip(x, 0, 1) * 255).astype(np.uint8)``)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return image


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB image -> PNG bytes (filter 0)."""
    image = to_uint8(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] in (3, 4):
        color = 2 if image.shape[2] == 3 else 6
    else:
        raise ValueError(f"want (H, W), (H, W, 3) or (H, W, 4), got "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(image: np.ndarray, path: str) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(image))
    return path


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up = prev[x]
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, prev[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H, W) or (H, W, C) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced gray/RGB(A) "
                         f"images are read (depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    ch = _CHANNELS[color]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return rows.reshape(h, w) if ch == 1 else rows.reshape(h, w, ch)
