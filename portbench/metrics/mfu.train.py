"""Model (``models/``): the dense FLOPs of the window's train steps,
reckoned from the configuration's widths by its reference's
``forward_flops`` (harness/counts.py: three forwards a cloud), over the
window and the card's bf16 peak, summed over the chips, %."""


def read(run):
    if not run.examples:
        return None
    flops = (run.counts.TRAIN_STEP_FORWARDS * run.ref.forward_flops(run.cfg)
             * run.examples)
    peak = run.counts.PEAK_BF16_FLOPS * run.chips
    return 100.0 * flops / run.window_s / peak
