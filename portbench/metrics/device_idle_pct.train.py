"""Device (one H100): the traced window less the union of card 0's kernel,
copy and memset intervals, as a share of the window, %."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
