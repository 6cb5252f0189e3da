"""Endpoint (``serving.Predictor``): host ms a request from the end of the
dispatch to the logits in host memory (the wait for the card, then the
copy), the program's ``predictor.fetch`` spans over its
``predictor.request`` spans (harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("predictor.fetch", "predictor.request")
