"""Cells of the benchmark cut to sizes a CPU test run holds: the same
configuration and traffic files with fewer and smaller batches, float32,
on the CPU through the port's plain versions. The check's numbers then
read the program's arithmetic against the reference's."""

from __future__ import annotations

from portbench.harness import device as devmod, spec

TRAIN = {"cls_ssg.train": 1, "cls_ssg.train.dp4": 2}


def small_cell(workload: str, chips: int | None = None):
    bench = spec.load_benchmark()
    cell = dict(spec.workload(bench, workload))
    if chips is not None:
        cell["chips"] = chips
    cfg = spec.config(bench, cell["config"])
    cfg["dtype"] = "float32"
    mix = spec.traffic(cell["traffic"])
    if mix["kind"] == "train_epochs":
        cfg["data"]["samples_per_class"] = 1
        mix.update(batch_per_chip=8 // cell["chips"], steps_per_call=2)
    else:
        mix.update(blocks_per_request=2, points_per_block=2048,
                   pool_requests=2, sampled_requests=1)
        cfg["num_point"] = 2048
    return cell, cfg, mix


def run_small(workload: str, chips: int | None = None, plant=None,
              seed: int = 2 ** 31 + 11) -> dict:
    cell, cfg, mix = small_cell(workload, chips)
    return spec.runner(mix["kind"]).run(cell, cfg, mix, seed, 0.5, False,
                                        devmod.Clock(), device_name="cpu",
                                        plant=plant)
