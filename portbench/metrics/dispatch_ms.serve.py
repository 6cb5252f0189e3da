"""Model (``models/`` under ``Predictor``): host ms a request to dispatch
the forward, the program's ``predictor.forward`` spans over its
``predictor.request`` spans (harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("predictor.forward", "predictor.request")
