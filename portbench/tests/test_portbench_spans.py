"""The readers of the program's spans (``"source": "program_span"``,
harness/spans.py): each is right on a hand-built span record and gives
None without its span; and a traced CPU run of each runner kind (the
profiler on the CPU in the card's place) records spans whose counts, the
readers' denominators, equal the harness's own count of the traced train
steps and requests, so every such reader reports in its cells."""

import types

import pytest

from portbench.harness import device as devmod, profile, spec
from portbench.tests.common import small_cell
from pointnet2_tpu_torch.utils import profiling
from pointnet2_tpu_torch.utils.profiling import SpanRecord

_NEW = {m["name"]: m for m in spec.load_benchmark()["per_layer"]
        if m["source"] == "program_span" and m["name"] != "data_ms.train"}

# each reader: the span it reads, and its value on the record below
_READS = {
    "batch_wait_ms.train": ("trainer.batch_wait", 1e3 * 0.006 / 5),
    "stage_ms.train": ("step.stage", 1e3 * 0.004 / 5),
    "rendezvous_ms.dp4": ("trainer.sync_batches", 1e3 * 0.002 / 2),
    "remainder_ms.dp4": ("step.eager", 1e3 * 0.010 / 2),
    "upload_ms.serve": ("predictor.upload", 1e3 * 0.008 / 4),
    "dispatch_ms.serve": ("predictor.forward", 1e3 * 0.012 / 4),
    "fetch_ms.serve": ("predictor.fetch", 1e3 * 0.020 / 4),
    "assemble_ms.serve": ("predictor.assemble", 1e3 * 0.004 / 4),
}


def _record(skip: str | None = None) -> list:
    """Two epochs of 2 and 3 steps and four requests as the program
    records them, each span of a fixed length; ``skip`` leaves a span
    out."""
    out, t = [], 0

    def add(name, parent, ms, **counts):
        nonlocal t
        if name != skip:
            out.append(SpanRecord(name, t, t + int(ms * 1e6), parent, 1,
                                  counts))
        t += int(ms * 1e6)

    for steps in (2, 3):
        add("trainer.sync_batches", "trainer.epoch", 1)
        for _ in range(steps):
            add("trainer.batch_wait", "trainer.epoch", 1.2)
        add("step.stage", "trainer.epoch", 2, batches=steps)
        add("step.eager", "trainer.epoch", 5)
        add("trainer.epoch", None, 40, steps=steps, examples=32 * steps)
    for _ in range(4):
        for name, ms in (("predictor.upload", 2), ("predictor.forward", 3),
                         ("predictor.fetch", 5), ("predictor.assemble", 1)):
            add(name, "predictor.request", ms, rows=64)
        add("predictor.request", None, 20, rows=64, padded_rows=64)
    return out


def test_every_span_metric_is_read_here():
    assert sorted(_NEW) == sorted(_READS)


@pytest.mark.parametrize("name", sorted(_READS))
def test_reader_on_a_hand_built_record(monkeypatch, name):
    read = spec.reader(name).read
    monkeypatch.setattr(profiling, "_RECORD", _record())
    assert read(None) == pytest.approx(_READS[name][1], rel=1e-9)
    monkeypatch.setattr(profiling, "_RECORD", _record(skip=_READS[name][0]))
    assert read(None) is None
    monkeypatch.setattr(profiling, "_RECORD", [])
    assert read(None) is None


def test_a_program_without_spans_gives_none(monkeypatch):
    monkeypatch.delattr(profiling, "span_stats")
    for name in _READS:
        assert spec.reader(name).read(None) is None


class _CpuTraced(profile.Traced):
    """The harness's traced window with the CPU in the card's place."""

    def __init__(self, torch):
        super().__init__(types.SimpleNamespace(
            ones=lambda *shape, device=None: torch.ones(*shape),
            cuda=types.SimpleNamespace(synchronize=lambda: None)))


@pytest.mark.parametrize("workload,unit", [("cls_ssg.train", "steps"),
                                           ("sem_seg.serve_blocks",
                                            "requests")])
def test_traced_run_counts_what_the_harness_counts(monkeypatch, workload,
                                                   unit):
    seen = {}

    def read_per_layer(cell, run):
        stats = profiling.span_stats()
        seen["program"] = (stats["trainer.epoch"]["counts"]["steps"]
                           if unit == "steps"
                           else stats["predictor.request"]["count"])
        seen["harness"] = run.trace[unit]
        seen["values"] = {n: spec.reader(n).read(run) for n in _READS
                          if n.endswith(".serve") == (unit == "requests")}
        return {}

    cell, cfg, mix = small_cell(workload)
    mix.update(trace_batches=5, trace_requests=3)
    runner = spec.runner(mix["kind"])
    monkeypatch.setattr(runner, "Traced", _CpuTraced)
    monkeypatch.setattr(spec, "read_per_layer", read_per_layer)
    profiling.clear_spans()
    runner.run(cell, cfg, mix, 2 ** 31 + 29, 0.2, True,
               devmod.Clock(), device_name="cpu")
    profiling.clear_spans()
    assert seen["program"] == seen["harness"] > 0
    assert all(v is not None and v >= 0 for v in seen["values"].values()), \
        seen["values"]
