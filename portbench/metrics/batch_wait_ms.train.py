"""Host data (``utils/prefetch.Prefetcher`` under ``Trainer.train_epoch``):
ms a train step that the step waited for its host batch, the program's
``trainer.batch_wait`` spans over the ``steps`` of its ``trainer.epoch``
(harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("trainer.batch_wait", "trainer.epoch", "steps")
