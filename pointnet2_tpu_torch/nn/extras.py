"""General conv/pool layer zoo: Conv1D/2D/3D, Conv2DTranspose and the
max and average pools.

Port of pointnet2_tpu/nn/extras.py (the reference's utils/tf_util.py:
52-326,366-466). The PointNet++ models use only 1x1 convs (the ``Dense``
of nn/layers.py); these layers complete the layer library with the JAX
package's defaults: Xavier-uniform kernels, zero bias, optional BN with the
scheduled momentum (``nn.layers.BatchNorm``), ReLU.

The API is channels-last, as Flax's: (B, L, C), (B, H, W, C) and
(B, D, H, W, C); the layout is permuted around ``torch.nn.functional``'s
channels-first convolutions and pools inside. Parity notes:

- The children carry Flax's auto-generated scope names (``Conv_0``,
  ``ConvTranspose_0``, ``BatchNorm_0``), so ``convert.flax_to_torch`` maps
  a Flax layer's variables onto the port's. A conv weight is held in
  torch's layout, (Cout, Cin, k...); a transposed conv's as torch's
  (Cin, Cout, k...) with its spatial axes flipped, because Flax's
  ``ConvTranspose`` (``transpose_kernel=False``) correlates the dilated
  input with the kernel as stored, where ``conv_transpose`` flips it.
- ``SAME`` follows TF's rule, which pads asymmetrically with stride > 1:
  total = max((ceil(n/s) - 1) * s + k - n, 0), before = total // 2. The
  input is padded explicitly (zeros for a conv and for the average pool,
  which counts the padded zeros as Flax's does; -inf for the max pool).
- A transposed conv's output is ``lax.conv_transpose``'s: the full
  ``conv_transpose`` output cropped to start at k - 1 - pad_a and zero
  extended to the length its padding rule gives.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointnet2_tpu_torch.nn.layers import BatchNorm

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> list[tuple[int, int]]:
    """TF's ``SAME`` padding (before, after) of each spatial axis."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad the spatial axes of a channels-first tensor by (before, after)
    pairs given first axis first (F.pad wants the last axis first)."""
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def transpose_pads(k: int, s: int, padding: str) -> tuple[int, int]:
    """``lax.conv_transpose``'s (before, after) padding of the dilated
    input for one axis (jax/_src/lax/convolution.py,
    ``_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return pad_a, pad_len - pad_a


class _ConvNd(nn.Module):
    """A channels-last convolution (or transposed convolution) over ``nd``
    spatial axes, then optional BN, then the activation."""

    nd = 2
    transpose = False

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] | None = None,
                 padding: str = "SAME", bn: bool = False,
                 activation: Callable | None = torch.relu, dtype=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size = tuple(kernel_size)
        if len(self.kernel_size) != self.nd:
            raise ValueError(f"kernel_size {self.kernel_size} for a "
                             f"{self.nd}-d convolution")
        self.strides = tuple(strides) if strides else (1,) * self.nd
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        conv = nn.Module()
        shape = ((in_features, features) if self.transpose
                 else (features, in_features))
        conv.weight = nn.Parameter(torch.empty(*shape, *self.kernel_size))
        conv.bias = nn.Parameter(torch.zeros(features))
        self.add_module(self._conv_scope(), conv)
        if bn:
            self.BatchNorm_0 = BatchNorm(features, dtype=dtype)
        self.bn = bn
        self.reset_parameters()

    @classmethod
    def _conv_scope(cls) -> str:
        return "ConvTranspose_0" if cls.transpose else "Conv_0"

    @property
    def conv(self) -> nn.Module:
        """The child holding the kernel (``weight``) and ``bias``."""
        return getattr(self, self._conv_scope())

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Xavier-uniform kernel, zero bias (tf_util.py:41-49)."""
        nn.init.xavier_uniform_(self.conv.weight, generator=generator)
        nn.init.zeros_(self.conv.bias)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        w = self.conv.weight.to(dt)
        xc = _channels_first(x.to(dt))
        if not self.transpose:
            if self.padding == "SAME":
                xc = _pad(xc, same_pads(xc.shape[2:], self.kernel_size,
                                        self.strides))
            y = _CONV[self.nd](xc, w, stride=self.strides)
        else:
            y = _CONV_T[self.nd](xc, w, stride=self.strides)
            for axis, (n, k, s) in enumerate(zip(xc.shape[2:],
                                                 self.kernel_size,
                                                 self.strides)):
                pad_a, pad_b = transpose_pads(k, s, self.padding)
                length = (n - 1) * s + 1 + pad_a + pad_b - k + 1
                start = k - 1 - pad_a
                y = y.narrow(axis + 2, start,
                             min(length, y.shape[axis + 2] - start))
                short = length - y.shape[axis + 2]
                if short:
                    pads = [(0, 0)] * self.nd
                    pads[axis] = (0, short)
                    y = _pad(y, pads)
        y = _channels_last(y)
        return y + self.conv.bias.to(dt)

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        """Channels-last x -> channels-last y; BN in train or eval mode as
        the module is (``module.train()``)."""
        y = self._conv(x)
        if self.bn:
            y = self.BatchNorm_0(y, bn_momentum)
        if self.activation is not None:
            y = self.activation(y)
        return y


class Conv1D(_ConvNd):
    """(B, L, C) convolution (tf_util.conv1d with kernel_size > 1)."""

    nd = 1


class Conv2D(_ConvNd):
    """(B, H, W, C) convolution (tf_util.conv2d)."""

    nd = 2


class Conv3D(_ConvNd):
    """(B, D, H, W, C) convolution (tf_util.conv3d)."""

    nd = 3


class Conv2DTranspose(_ConvNd):
    """(B, H, W, C) transposed convolution (tf_util.conv2d_transpose)."""

    nd = 2
    transpose = True


def _pool(x, kernel_size, stride, padding, nd: int, kind: str):
    kernel_size, stride = tuple(kernel_size), tuple(stride)
    xc = _channels_first(x)
    if padding == "SAME":
        xc = _pad(xc, same_pads(xc.shape[2:], kernel_size, stride),
                  -math.inf if kind == "max" else 0.0)
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if kind == "max":
        y = _MAX[nd](xc, kernel_size, stride)
    else:
        y = _AVG[nd](xc, kernel_size, stride, count_include_pad=True)
    return _channels_last(y)


def max_pool2d(x, kernel_size, stride=(2, 2), padding="VALID"):
    """(B, H, W, C) max pooling (tf_util.max_pool2d)."""
    return _pool(x, kernel_size, stride, padding, 2, "max")


def avg_pool2d(x, kernel_size, stride=(2, 2), padding="VALID"):
    """(B, H, W, C) average pooling; ``SAME`` counts the padded zeros."""
    return _pool(x, kernel_size, stride, padding, 2, "avg")


def max_pool3d(x, kernel_size, stride=(2, 2, 2), padding="VALID"):
    """(B, D, H, W, C) max pooling."""
    return _pool(x, kernel_size, stride, padding, 3, "max")


def avg_pool3d(x, kernel_size, stride=(2, 2, 2), padding="VALID"):
    """(B, D, H, W, C) average pooling; ``SAME`` counts the padded
    zeros."""
    return _pool(x, kernel_size, stride, padding, 3, "avg")
