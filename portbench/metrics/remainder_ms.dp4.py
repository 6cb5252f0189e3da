"""Step (``run_one_step``, the epoch's remainder outside the CUDA graph):
host ms an epoch in the eager remainder steps, their upload included, the
program's ``step.eager`` spans over its ``trainer.epoch`` spans
(harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("step.eager", "trainer.epoch")
