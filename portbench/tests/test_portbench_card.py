"""Card-only tests of the benchmark: every cell runs once through
``portbench/run.py`` and prints a correct result line, and the control
(the reference in float8 in the program's place) fails the serving and
the training check at the cells' own sizes. Each skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench.harness import check, spec

pytestmark = pytest.mark.cuda

_CELLS = [c["name"] for c in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


@pytest.mark.parametrize("name", _CELLS)
def test_cell_runs(card, name):
    cell = spec.workload(spec.load_benchmark(), name)
    if card.cuda.device_count() < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} cards")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 123), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == cell["chips"]


def test_serving_control_fails(card):
    from portbench.harness import serve_blocks, weights
    from portbench.reference.model import fp8

    bench = spec.load_benchmark()
    cell = spec.workload(bench, "sem_seg.serve_blocks")
    cfg = spec.config(bench, cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), pool_requests=1)
    dev = card.device("cuda")
    w = weights.make(card, cfg, 2 ** 31 + 7, dev)
    pool = serve_blocks.make_pool(cfg, mix, 2 ** 31 + 7)
    kept = [(0, serve_blocks.reference_logits(card, cfg, w, pool[0], dev,
                                              linear=fp8).cpu().numpy())]
    numbers = serve_blocks.compare(card, cfg, w, pool, kept, dev)
    assert not check.verdict(numbers, spec.limits(cell["name"]))[0]


def test_training_control_fails(card):
    from portbench.harness import train_epochs, weights
    from portbench.reference.model import fp8

    bench = spec.load_benchmark()
    cell = spec.workload(bench, "cls_ssg.train")
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    singles, K = mix["setup_single_steps"], mix["steps_per_call"]
    seed, dev = 2 ** 31 + 8, card.device("cuda")
    w = weights.make(card, cfg, seed, dev)
    data = train_epochs.make_data(cfg, mix["batch_per_chip"], seed)
    batches = [b for _, b in zip(range(singles + K), data.epoch())]
    ref = train_epochs.reference_readings(card, cfg, w, batches, seed, dev,
                                          singles)
    ctrl = train_epochs.reference_readings(card, cfg, w, batches, seed, dev,
                                           singles, linear=fp8)
    numbers = check.train_numbers(ctrl, ref)
    assert not check.verdict(numbers, spec.limits(cell["name"]))[0]
