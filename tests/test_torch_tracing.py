"""The port's spans (``utils/profiling.py`` ``span``), on the CPU.

- With no profiler a span enters no ``record_function`` and records
  nothing; under ``profiling.trace`` spans keep their parents, their self
  time is their duration less their children's, their counts add up, and
  each lands in ``trace.json`` as a ``user_annotation``.
- ``Trainer.train_epoch`` with K=2 over 5 batches records one
  ``trainer.epoch`` of 5 steps, five waits for a batch, two K-step stages
  and one eager remainder step (and K=1 and K=5 their own), and ends bit
  for bit where an untraced epoch ends. (On the CPU the K steps run eagerly: ``step.replay`` and
  ``step.capture`` are held on the card, tests/test_torch_cuda.py.)
- ``Predictor`` records its upload, forward, fetch and assembly with the
  rows it ran, padded and in chunks, and returns the untraced logits bit
  for bit.
"""

import json
import threading

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch.data import SyntheticClassification
from pointnet2_tpu_torch.serving import Predictor
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(n)


def test_span_without_a_profiler_does_nothing(monkeypatch):
    entered = []

    def counting(name, *a, **kw):
        entered.append(name)
        return torch.autograd.profiler.record_function(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.span("outer", rows=3) as outer:
        outer.add(rows=2)
        with profiling.span("inner"):
            pass
    assert profiling.span("a") is profiling.span("b", steps=1)
    assert entered == [] and profiling.spans() == []
    assert profiling.span_stats() == {}
    with torch.profiler.profile():
        with profiling.span("recorded"):
            pass
    assert entered == ["recorded"]


def test_nested_spans_under_trace(tmp_path):
    with profiling.trace(str(tmp_path / "first")):
        with profiling.span("stale"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", rows=3) as outer:
            outer.add(rows=2, steps=1)
            for k in (1, 2):
                with profiling.span("inner", items=k):
                    torch.randn(16, 16).mm(torch.randn(16, 16))
    record = profiling.spans()
    by = {}
    for r in record:
        by.setdefault(r.name, []).append(r)
    assert sorted(by) == ["inner", "outer"]
    (o,) = by["outer"]
    assert [r.parent for r in by["inner"]] == ["outer", "outer"]
    assert o.parent is None
    assert {r.thread for r in record} == {threading.get_ident()}
    stats = profiling.span_stats()
    dur = [(r.end_ns - r.start_ns) * 1e-9 for r in by["inner"]]
    total = (o.end_ns - o.start_ns) * 1e-9
    assert stats["outer"]["total_s"] == pytest.approx(total, abs=1e-12)
    assert stats["outer"]["self_s"] == pytest.approx(total - sum(dur),
                                                     abs=1e-12)
    assert stats["inner"]["count"] == 2
    assert stats["inner"]["self_s"] == stats["inner"]["total_s"]
    assert stats["outer"]["counts"] == {"rows": 5, "steps": 1}
    assert stats["inner"]["counts"] == {"items": 3}
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    marked = [e["name"] for e in events if e.get("cat") == "user_annotation"
              and not e["name"].startswith("ProfilerStep")]
    assert sorted(marked) == ["inner", "inner", "outer"]


def _epoch(tmp_path, K: int, traced: bool):
    data = SyntheticClassification(num_classes=4, samples_per_class=5,
                                   npoints=32, batch_size=4, seed=0)
    cfg = TrainConfig(model="pointnet_cls_basic", num_point=32,
                      batch_size=4, augment="cls", steps_per_call=K,
                      log_dir=str(tmp_path / str(traced)))
    with Trainer(cfg, device="cpu") as tr:
        state = tr.init_state()
        if traced:
            with profiling.trace(str(tmp_path / "trace")):
                tr.train_epoch(state, data, 0)
        else:
            tr.train_epoch(state, data, 0)
    with open(tmp_path / str(traced) / "metrics.jsonl") as f:
        loss = json.loads(f.readline())["loss"]
    return loss, [p.detach().clone() for p in state.model.parameters()]


@pytest.mark.parametrize("K,calls,eager", [(2, 2, 1), (1, 0, 5), (5, 1, 0)])
def test_trainer_epoch_spans(tmp_path, K, calls, eager):
    """5 batches: K=2 two K-step calls and one eager remainder step; K=1
    five eager steps; K=5 one call."""
    want_loss, want = _epoch(tmp_path, K, False)
    assert profiling.spans() == []
    got_loss, got = _epoch(tmp_path, K, True)
    assert got_loss == want_loss
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    stats = profiling.span_stats()
    count = {k: v["count"] for k, v in stats.items()}
    assert count == {k: v for k, v in (
        ("trainer.epoch", 1), ("trainer.sync_batches", 1),
        ("trainer.batch_wait", 5), ("step.stage", calls),
        ("step.eager", eager), ("trainer.epoch_end", 1)) if v}
    assert stats["trainer.epoch"]["counts"] == {"steps": 5, "examples": 20}
    if calls:
        assert stats["step.stage"]["counts"] == {"batches": calls * K}
    assert 0 <= stats["trainer.batch_wait"]["counts"]["blocked"] <= 5
    assert {r.parent for r in profiling.spans()} == {None, "trainer.epoch"}


@pytest.mark.parametrize("rows,devices,padded,runs", [
    (4, 1, 4, 1),  # the largest bucket, no padding
    (5, 1, 6, 2),  # chunks of 4 and 1, the 1 padded to its bucket of 2
    (9, 1, 10, 3),  # chunks of 4, 4 and 1
    (3, 2, 4, 1),  # two shards of 2 rows, one padded row
])
def test_predictor_spans(rows, devices, padded, runs):
    pred = Predictor("pointnet_cls_basic", device="cpu", dtype=None,
                     buckets=(2, 4), num_devices=devices, num_classes=4)
    pts = np.random.RandomState(rows).rand(rows, 32, 3).astype(np.float32)
    want = pred(pts)
    assert profiling.spans() == []
    with torch.profiler.profile():
        got = pred(pts)
    np.testing.assert_array_equal(got, want)
    stats = profiling.span_stats()
    shards = runs * devices
    assert stats["predictor.request"]["count"] == 1
    assert stats["predictor.request"]["counts"] == {"rows": rows,
                                                    "padded_rows": padded}
    assert stats["predictor.upload"]["count"] == shards
    assert stats["predictor.upload"]["counts"] == {"rows": padded}
    assert stats["predictor.forward"]["count"] == shards
    assert stats["predictor.fetch"]["count"] == shards
    assert stats["predictor.assemble"]["count"] == runs + (runs > 1)
    parents = {r.name: r.parent for r in profiling.spans()}
    assert parents["predictor.request"] is None
    assert {parents[k] for k in ("predictor.upload", "predictor.forward",
                                 "predictor.fetch",
                                 "predictor.assemble")} == {
        "predictor.request"}
