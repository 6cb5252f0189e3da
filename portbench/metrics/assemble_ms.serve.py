"""Endpoint (``serving.Predictor``): host ms a request to put the shards'
and chunks' logits together, the program's ``predictor.assemble`` spans
over its ``predictor.request`` spans (harness/spans.py)."""

from portbench.harness.spans import ms_per


def read(run):
    return ms_per("predictor.assemble", "predictor.request")
