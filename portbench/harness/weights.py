"""Weights of a configuration drawn from a seed on the device, in a few
large calls, as a state dict under the port's parameter names (the same
names the reference reads): the program and the reference are handed the
same tensors. Which tensors a configuration has is its reference's
``layout(cfg)`` (``configs/<config>.ref.py``).

Dense weights Xavier-uniform, dense biases N(0, 0.05^2); batch norm scale
U(0.8, 1.2), shift and running mean N(0, 0.1^2), running variance
U(0.5, 1.5).
"""

from __future__ import annotations

import math

from portbench.harness import spec


def make(torch, cfg: dict, seed: int, device) -> dict:
    """The state dict of ``cfg`` drawn from ``seed`` on ``device``
    (float32)."""
    lay = spec.reference(cfg["name"]).layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    by_kind: dict[str, list] = {}
    for name, shape, kind in lay:
        by_kind.setdefault(kind, []).append((name, shape))
    out = {}
    for kind in ("weight", "bias", "scale", "shift", "var"):
        items = by_kind.get(kind, [])
        sizes = [math.prod(s) for _, s in items]
        if kind in ("bias", "shift"):
            flat = torch.randn(sum(sizes), generator=gen, device=device)
            flat *= 0.05 if kind == "bias" else 0.1
        else:
            flat = torch.rand(sum(sizes), generator=gen, device=device)
        for (name, shape), part in zip(items, flat.split(sizes)):
            t = part.reshape(shape)
            if kind == "weight":
                limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                t = (t * 2.0 - 1.0) * limit
            elif kind == "scale":
                t = 0.8 + 0.4 * t
            elif kind == "var":
                t = 0.5 + t
            out[name] = t.contiguous()
    return {name: out[name] for name, _, _ in lay}
