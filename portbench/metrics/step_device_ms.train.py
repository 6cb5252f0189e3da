"""Step (``train/steps.py`` ``TrainMultiStep``): device busy ms a train step
in the traced window, on card 0."""


def read(run):
    t = run.trace
    return 1e3 * t["busy_s"] / t["steps"] if t and t["busy_s"] > 0 else None
