"""Lockstep batch iteration for protocol evaluation.

The port's copy of pointnet2_tpu/evaluation/lockstep.py. Processes agree on
the largest per-process batch count, and a process that runs out feeds
zero batches with nvalid=0, built from the dataset's shape metadata
(``dataset.zero_batch()``), which add nothing to the counters. With one
process the count is the dataset's own.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def _zero_like_batch(template: dict) -> dict:
    return {k: 0 if k == "nvalid" else np.zeros_like(np.asarray(v))
            for k, v in template.items()}


def lockstep_batches(dataset, multihost, **epoch_kw) -> Iterator[dict]:
    """dataset.epoch(augment=False) padded to the processes' largest batch
    count."""
    num_global = multihost.sync_num_batches(dataset.num_batches(),
                                            reduce="max")
    it = iter(dataset.epoch(augment=False, **epoch_kw))
    zero = None
    for _ in range(num_global):
        batch = next(it, None)
        if batch is None:
            if zero is None:
                zero = dataset.zero_batch()
            # fresh arrays each time: consumers may write into the batch
            batch = _zero_like_batch(zero)
        yield batch
