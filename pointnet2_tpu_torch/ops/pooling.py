"""Max pooling over a tensor axis, with a first-occurrence gradient.

Port of pointnet2_tpu/ops/pooling.py. The JAX package never compares
floats in the pool's backward: the forward saves the integer argmax and the
backward routes the whole cotangent to the first maximal index. ``amax``'s
own gradient instead splits it evenly among exact ties, which are frequent
in bf16. ``torch.argmax`` is documented to return the first maximal index;
``torch.max(dim)``'s index is unspecified on CUDA, so it is not used.

Where no gradient is recorded (``torch.no_grad``, inference, or an input
that needs none) the pool is a plain ``amax``: serving pays for no argmax.
"""

from __future__ import annotations

import torch


class MaxPool(torch.autograd.Function):
    """``x.amax(dim)`` whose backward writes the cotangent at the saved
    first-occurrence argmax and zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, dim: int):
        dim = dim % x.dim()
        if x.device.type == "cpu":
            # the CPU's argmax over an inner axis runs ~8x slower than a
            # copy plus an argmax over the last axis; same first index
            idx = x.movedim(dim, -1).contiguous().argmax(-1).unsqueeze(dim)
        else:
            idx = torch.argmax(x, dim=dim, keepdim=True)
        ctx.save_for_backward(idx)
        ctx.dim = dim
        ctx.shape = x.shape
        return torch.gather(x, dim, idx).squeeze(dim)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        gx = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        return gx.scatter_(ctx.dim, idx, grad.unsqueeze(ctx.dim)), None


def max_pool(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amax(dim)``; with autograd recording, the gradient goes to the
    first occurrence of the maximum."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool.apply(x, dim)
    return torch.amax(x, dim=dim)
