"""Endpoint (``serving.Predictor``): device-to-host copy ms a request in the
traced window."""


def read(run):
    t = run.trace
    return 1e3 * t["dtoh_s"] / t["requests"] if t and t["dtoh_s"] > 0 else None
