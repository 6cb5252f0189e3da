"""Learning-rate and batch-norm-momentum schedules.

Port of pointnet2_tpu/train/schedules.py:18-41 (the reference's
train.py:86-104):

- LR: exponential staircase decay on examples seen, clipped at 1e-5;
- BN momentum (the bn_decay schedule): 1 - 0.5 * 0.5^floor(examples/step),
  clipped at 0.99.

Both are functions of the optimizer step evaluated on the host in float32,
in the JAX package's order of operations, so that their values equal its
bit for bit. They return numpy float32 scalars.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _exponent(step, batch_size: int, decay_step: int):
    # int32 examples seen / decay_step in float32, then floor (as jnp)
    seen = np.int32(step) * np.int32(batch_size)
    return np.floor(_F32(seen) / _F32(decay_step))


def exponential_decay_clipped(base_lr: float, batch_size: int,
                              decay_step: int, decay_rate: float,
                              min_lr: float = 1e-5):
    """Staircase exponential decay on examples seen, clipped below."""

    def schedule(step) -> np.float32:
        exp = _exponent(step, batch_size, decay_step)
        lr = _F32(base_lr) * np.power(_F32(decay_rate), exp)
        return np.maximum(lr, _F32(min_lr))

    return schedule


def bn_momentum_schedule(batch_size: int, decay_step: int,
                         init_decay: float = 0.5, decay_rate: float = 0.5,
                         clip: float = 0.99):
    """Scheduled BN momentum: min(clip, 1 - init*rate^floor(examples/step))."""

    def schedule(step) -> np.float32:
        exp = _exponent(step, batch_size, decay_step)
        m = _F32(1.0) - _F32(init_decay) * np.power(_F32(decay_rate), exp)
        return np.minimum(m, _F32(clip))

    return schedule
