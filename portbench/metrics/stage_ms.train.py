"""Step (``Trainer.train_epoch`` and ``TrainMultiStep``): host ms a train
step to put the K-step call's batches in the step's layout and into the
graph's buffers, the program's ``step.stage`` spans over the ``steps`` of
its ``trainer.epoch`` (harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("step.stage", "trainer.epoch", "steps")
