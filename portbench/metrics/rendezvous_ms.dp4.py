"""Ranks (``parallel/multihost.sync_num_batches``): ms an epoch that card
0's rank spent agreeing on the batch count with the other ranks, the
program's ``trainer.sync_batches`` spans over its ``trainer.epoch`` spans
(harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("trainer.sync_batches", "trainer.epoch")
