"""Training state and the optimizers, with optax's semantics.

Port of pointnet2_tpu/train/state.py:12-26. The JAX package's TrainState
holds (step, params, batch_stats, opt_state); here the model module holds
the parameters and the BN running statistics, and the optimizer its own
moments, so the state is (step, model, optimizer).

The optimizers follow optax's update, in its order of float32 operations
(written out here rather than through ``torch.optim``, whose Adam orders
the bias correction differently):

- ``adam`` (optax.adam): mu = 0.1*g + 0.9*mu, nu = 0.001*g^2 + 0.999*nu,
  bias-corrected by 1 - b^t with the count t counted from 1, update
  mu_hat / (sqrt(nu_hat) + 1e-8), eps outside the sqrt;
- ``momentum`` (optax.sgd with momentum): trace = g + 0.9*trace, no
  dampening, no Nesterov;
- both scale by -lr with lr = ``schedule(count)``, the count of earlier
  updates (optax's ``count``, 0 at the first step), then add to the
  parameters.

They run on every parameter tensor at once through ``torch._foreach_*``
(the multi-tensor kernels ``torch.optim`` itself uses), updating the
parameters and moments in place, so their addresses never change: a CUDA
graph of the step (train/steps.py) reads them where it found them. The
per-step scalars (-lr, and Adam's two bias corrections) are float32 values
computed on the host from the count, as optax computes them
(``host_scalars``), and the update reads them from a small tensor on the
parameters' device, so a graph takes each replay's values from that tensor
instead of the values it saw at capture.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_F32 = np.float32


def _c(v) -> float:
    """A python scalar as optax sees it: rounded to float32 first."""
    return float(_F32(v))


def upload_scalars(values: np.ndarray, device) -> torch.Tensor:
    """A float32 host vector on ``device``: through pinned memory and
    without waiting on the card when the device is CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Optimizer:
    MOMENTS: tuple[str, ...] = ()  # per-parameter state lists

    def __init__(self, params, lr_schedule):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.count = 0  # updates applied so far (optax's count)

    def _grads(self):
        grads = []
        for p in self.params:
            if p.grad is None:
                raise RuntimeError("a parameter has no gradient; run "
                                   "backward before the optimizer step")
            grads.append(p.grad)
        return grads

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The count and the moments (one tensor a parameter, in parameter
        order), for a checkpoint."""
        return {"count": self.count,
                **{k: list(getattr(self, k)) for k in self.MOMENTS}}

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict()``'s output onto this optimizer's
        parameters (shapes and dtypes checked), copied into the moments in
        place."""
        for k in self.MOMENTS:
            ts = sd[k]
            if len(ts) != len(self.params) or any(
                    t.shape != p.shape or t.dtype != p.dtype
                    for t, p in zip(ts, self.params)):
                raise ValueError(f"optimizer moment {k!r} does not match "
                                 "the parameters")
        with torch.no_grad():
            for k in self.MOMENTS:
                for m, t in zip(getattr(self, k), sd[k]):
                    m.copy_(t)
        self.count = int(sd["count"])

    def host_scalars(self, count: int) -> np.ndarray:
        """The float32 scalars of the update numbered ``count``: [-lr]."""
        return np.array([-_F32(self.lr_schedule(count))], _F32)

    @torch.no_grad()
    def step(self, scalars: torch.Tensor | None = None) -> None:
        """One update. ``scalars`` is ``host_scalars(count)`` already on the
        parameters' device (a view into a graph's buffer); None uploads
        it."""
        if scalars is None:
            scalars = upload_scalars(self.host_scalars(self.count),
                                     self.params[0].device)
        updates = torch._foreach_mul(self._updates(self._grads(), scalars),
                                     scalars[0])
        torch._foreach_add_(self.params, updates)
        self.count += 1


class Adam(_Optimizer):
    """optax.adam(lr_schedule) with b1 0.9, b2 0.999, eps 1e-8."""

    MOMENTS = ("mu", "nu")

    def __init__(self, params, lr_schedule, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr_schedule)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def host_scalars(self, count: int) -> np.ndarray:
        """[-lr, 1 - b1^t, 1 - b2^t] with t = count + 1, in float32."""
        t = _F32(count + 1)
        return np.array([-_F32(self.lr_schedule(count)),
                         _F32(1) - np.power(_F32(self.b1), t),
                         _F32(1) - np.power(_F32(self.b2), t)], _F32)

    def _updates(self, grads, scalars):
        b1, b2 = self.b1, self.b2
        # mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g**2: each product
        # rounded, then the sum, in place
        torch._foreach_mul_(self.mu, _c(b1))
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, _c(1 - b1)))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, _c(1 - b2))
        torch._foreach_mul_(self.nu, _c(b2))
        torch._foreach_add_(self.nu, sq)
        mu_hat = torch._foreach_div(self.mu, scalars[1])
        den = torch._foreach_div(self.nu, scalars[2])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _c(self.eps))
        torch._foreach_div_(mu_hat, den)
        return mu_hat


class Momentum(_Optimizer):
    """optax.sgd(lr_schedule, momentum=0.9): trace = g + 0.9*trace."""

    MOMENTS = ("trace",)

    def __init__(self, params, lr_schedule, momentum=0.9):
        super().__init__(params, lr_schedule)
        self.momentum = momentum
        self.trace = [torch.zeros_like(p) for p in self.params]

    def _updates(self, grads, scalars):
        torch._foreach_mul_(self.trace, _c(self.momentum))
        torch._foreach_add_(self.trace, grads)
        return self.trace


def make_optimizer(name: str, params, lr_schedule, momentum: float = 0.9):
    """adam | momentum, matching train.py:133-138 (lr is scheduled)."""
    if name == "adam":
        return Adam(params, lr_schedule)
    if name == "momentum":
        return Momentum(params, lr_schedule, momentum)
    raise ValueError(f"unknown optimizer {name!r} (want 'adam' or 'momentum')")


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: _Optimizer
