"""Carry weights from the JAX package to the port.

``flax_to_torch`` turns a Flax variables tree, ``{"params": ...,
"batch_stats": ...}`` as nested dicts of arrays, into a ``state_dict`` of the
port's modules, whose children carry the Flax scope names (``sa1.mlp_mod
.conv0.dense``, ``fc3.dense``, ...):

- a Dense ``kernel`` (in, out) becomes the ``nn.Linear`` weight (out, in);
- a Dense ``bias`` stays ``bias``;
- a BatchNorm ``scale`` / ``bias`` become ``weight`` / ``bias`` (the
  ``norm`` scope of the point layers, and Flax's auto-named
  ``BatchNorm_0`` of the conv layers of ``nn.extras``);
- a ``Conv_0`` ``kernel`` (k..., Cin, Cout) becomes torch's conv weight
  (Cout, Cin, k...);
- a ``ConvTranspose_0`` ``kernel`` (k..., Cin, Cout) becomes torch's
  transposed-conv weight (Cin, Cout, k...) with its spatial axes flipped:
  Flax's ``ConvTranspose`` does not flip its kernel, ``conv_transpose``
  does;
- ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` /
  ``running_var``.

The conversion is strict: every leaf maps to exactly one tensor, and a leaf
it does not know raises. Given the target ``model``, a key left over on
either side, or a shape that differs, raises as well.
"""

from __future__ import annotations

import numpy as np
import torch


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _conv_kernel(a: np.ndarray) -> np.ndarray:
    """(k..., Cin, Cout) -> (Cout, Cin, k...)."""
    d = a.ndim - 2
    return np.transpose(a, (d + 1, d, *range(d)))


def _conv_transpose_kernel(a: np.ndarray) -> np.ndarray:
    """(k..., Cin, Cout) -> (Cin, Cout, k...), spatial axes flipped."""
    d = a.ndim - 2
    return np.transpose(np.flip(a, tuple(range(d))), (d, d + 1, *range(d)))


# (collection, parent scope, leaf) -> (torch name, layout transform)
_LEAVES = {
    ("params", "dense", "kernel"): ("weight", np.transpose),
    ("params", "dense", "bias"): ("bias", _same),
    ("params", "Conv_0", "kernel"): ("weight", _conv_kernel),
    ("params", "Conv_0", "bias"): ("bias", _same),
    ("params", "ConvTranspose_0", "kernel"): ("weight",
                                              _conv_transpose_kernel),
    ("params", "ConvTranspose_0", "bias"): ("bias", _same),
}
for _scope in ("norm", "BatchNorm_0"):
    _LEAVES.update({
        ("params", _scope, "scale"): ("weight", _same),
        ("params", _scope, "bias"): ("bias", _same),
        ("batch_stats", _scope, "mean"): ("running_mean", _same),
        ("batch_stats", _scope, "var"): ("running_var", _same),
    })


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (str(key),))
    else:
        yield path, tree


def flax_to_torch(variables, model: torch.nn.Module | None = None) -> dict:
    """Flax ``{"params", "batch_stats"}`` tree -> the port's state_dict of
    float32 CPU tensors. With ``model``, the keys and shapes must match its
    ``state_dict()`` exactly."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unexpected variable collections: {sorted(extra)}")
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables):
        collection, scopes, name = path[0], path[1:-1], path[-1]
        rule = _LEAVES.get((collection, scopes[-1] if scopes else "", name))
        if rule is None:
            raise ValueError(f"no conversion rule for leaf {'/'.join(path)}")
        torch_name, layout = rule
        key = ".".join((*scopes, torch_name))
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        arr = np.asarray(leaf, np.float32)
        out[key] = torch.tensor(np.ascontiguousarray(layout(arr)))
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(out))
        unexpected = sorted(set(out) - set(want))
        if missing or unexpected:
            raise ValueError(f"variables do not match the model: missing "
                             f"{missing}, unexpected {unexpected}")
        for key, t in out.items():
            if tuple(t.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} from the "
                                 f"variables, {tuple(want[key].shape)} in "
                                 "the model")
    return out
