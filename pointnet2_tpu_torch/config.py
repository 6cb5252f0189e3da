"""Kernel dispatch for the port's point ops, the device check of its entry
points, the fused SA-chain gate and the pool-before-affine gate.

Counterpart of pointnet2_tpu/config.py:22-62,81-141. Each point op with a
hand-written CUDA kernel (FPS, ball query, row gather) also has a plain
PyTorch version with the same semantics, in the same module. Which one runs
is decided by the device of the tensor it is given:

- a CPU tensor takes the plain version;
- a CUDA tensor launches the kernel, and the kernel's wrapper raises on
  anything the kernel does not take. There is no fallback.

``default_impl("torch")`` is a test switch: it sends CUDA tensors to the
plain versions as well, so that a run on the card can be held against the
same run without the kernels.
"""

from __future__ import annotations

import contextlib

import torch

_VALID = ("auto", "torch")
_DEFAULT_IMPL = "auto"


def set_default_impl(impl: str) -> None:
    global _DEFAULT_IMPL
    if impl not in _VALID:
        raise ValueError(f"impl must be one of {_VALID}, got {impl!r}")
    _DEFAULT_IMPL = impl


def get_default_impl() -> str:
    return _DEFAULT_IMPL


@contextlib.contextmanager
def default_impl(impl: str):
    """Temporarily force an implementation (``"torch"``: plain versions
    everywhere, the card included)."""
    prev = _DEFAULT_IMPL
    set_default_impl(impl)
    try:
        yield
    finally:
        set_default_impl(prev)


def use_kernel(t: torch.Tensor) -> bool:
    """Whether an op given ``t`` launches its CUDA kernel (True) or runs its
    plain PyTorch version (False). Devices other than CPU and CUDA raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return _DEFAULT_IMPL == "auto"
    raise ValueError(f"unsupported device {t.device}: the port runs on "
                     "CUDA, or on the CPU through its plain versions")


def check_device(device) -> torch.device:
    """Resolve an entry point's ``device`` argument. CUDA is the default of
    every entry point; asking for it without a card raises instead of
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on an NVIDIA GPU. Pass "
            "device='cpu' explicitly to run the plain PyTorch versions.")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32. The lifted
    first dense is followed by a centre-term subtraction that amplifies its
    rounding (pointnet2_tpu/nn/layers.py:223-234), and TF32 keeps only ten
    mantissa bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- fused SA-chain dispatch -------------------------------------------------
#
# The set-abstraction MLP chains (dense+BN+ReLU stacks + max-pool) can run as
# fused CUDA kernels (ops/fused_mlp.py, csrc/fused_mlp.cu) instead of
# discrete PyTorch ops. Default: OFF, as in the reference
# (pointnet2_tpu/config.py:81-112); H100 numbers in PERF.md.

_FUSED_MLP = False


def fused_mlp_enabled() -> bool:
    return _FUSED_MLP


def set_fused_mlp(enabled: bool) -> None:
    global _FUSED_MLP
    _FUSED_MLP = bool(enabled)


@contextlib.contextmanager
def fused_mlp(enabled: bool):
    """Context manager to temporarily toggle the fused SA-chain kernels."""
    prev = _FUSED_MLP
    set_fused_mlp(enabled)
    try:
        yield
    finally:
        set_fused_mlp(prev)


# --- pool-before-affine max-pooling ------------------------------------------
#
# max_S relu(y*a+b) == relu(extremum_S(y)*a+b) exactly (per-channel monotone
# affine), so the SA stacks pool the pre-BN dense output and skip the widest
# tensor's normalize pass (ConvBN.post_pooled_max). On by default; the gate
# exists for A/B comparisons.

_POOLED_MAX = True


def pooled_max_enabled() -> bool:
    return _POOLED_MAX


def set_pooled_max(enabled: bool) -> None:
    global _POOLED_MAX
    _POOLED_MAX = bool(enabled)


@contextlib.contextmanager
def pooled_max(enabled: bool):
    prev = _POOLED_MAX
    set_pooled_max(enabled)
    try:
        yield
    finally:
        set_pooled_max(prev)
