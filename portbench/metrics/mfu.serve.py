"""Model (``models/``): the dense FLOPs of the window's forwards, reckoned
from the configuration's widths by its reference's ``forward_flops``
(harness/counts.py), over the window and the card's bf16 peak, %."""


def read(run):
    if not run.requests:
        return None
    blocks = run.requests * run.mix["blocks_per_request"]
    flops = run.ref.forward_flops(run.cfg) * blocks
    return 100.0 * flops / run.window_s / run.counts.PEAK_BF16_FLOPS
