"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``portbench/configs/<config>.json`` (its file entry in
  ``BENCHMARK.json``), with its plain reference beside it,
  ``portbench/configs/<config>.ref.py``: everything that belongs to the
  model and its task (the forward, the parameters it reads, the work it
  does, and for training the recipe's augmentation and loss);
- a kind of input data (the configuration's ``data.kind``):
  ``portbench/inputs/<kind>.py``, which makes the cell's inputs from the
  seed;
- a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the general runner that reads it (``harness/<kind>.py``);
- a cell's limits of the check: ``portbench/limits/<workload>.json``;
- a per-layer metric: ``portbench/metrics/<metric>.py``, a reader with
  ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "config")
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    cfg["name"] = name
    return cfg


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def limits(workload_name: str, bench_dir: Path = BENCH) -> dict:
    with open(bench_dir / "limits" / f"{workload_name}.json") as f:
        return json.load(f)


_LOADED: dict = {}


def load_file(path: Path, name: str):
    """The module in ``path``, executed once a process."""
    if path in _LOADED:
        return _LOADED[path]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod


def runner(kind: str):
    """The general runner of a traffic kind: ``portbench.harness.<kind>``."""
    return importlib.import_module(f"portbench.harness.{kind}")


def reference(config_name: str, bench_dir: Path = BENCH):
    """The plain reference beside a configuration file."""
    return load_file(bench_dir / "configs" / f"{config_name}.ref.py",
                     f"portbench_ref_{config_name.replace('-', '_')}")


def inputs(kind: str, bench_dir: Path = BENCH):
    """The maker of a data kind's inputs: ``portbench/inputs/<kind>.py``."""
    return load_file(bench_dir / "inputs" / f"{kind}.py",
                     f"portbench_inputs_{kind}")


def reader(metric: str, bench_dir: Path = BENCH):
    return load_file(bench_dir / "metrics" / f"{metric}.py",
                     f"portbench_metric_{metric.replace('.', '_')}")


def applies(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list,
    or, without one, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        moved = _by_name(bench["end_to_end"], metric["moves"], "metric")
        return applies(moved, cell, bench)
    return True


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if applies(m, cell, bench)]


def read_per_layer(cell: dict, run) -> dict:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing to read leaves its metric out."""
    bench = load_benchmark()
    out = {}
    for m in cell_metrics(bench, cell, True):
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def plant(path: str | None) -> None:
    """Call ``module:function``: a fault a test or a calibration plants in
    the program before a run (portbench/tests/faults.py)."""
    if path:
        mod, fn = path.split(":")
        getattr(importlib.import_module(mod), fn)()
