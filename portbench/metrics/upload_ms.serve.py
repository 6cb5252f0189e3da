"""Endpoint (``serving.Predictor``): host ms a request to pad its blocks and
copy them to the card, the program's ``predictor.upload`` spans over its
``predictor.request`` spans (harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("predictor.upload", "predictor.request")
