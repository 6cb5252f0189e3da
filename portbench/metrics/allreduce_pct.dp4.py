"""Ranks (``parallel/mesh.py``, the collectives of ``train/steps.py`` and
``nn/layers.py``): the NCCL kernels' share of card 0's device busy time in
the traced window, %."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or run.chips < 2:
        return None
    return 100.0 * t["nccl_s"] / t["busy_s"]
