"""The training kind (traffic ``"kind": "train_epochs"``): ``Trainer``
epochs back to back on data made in memory from the seed, one process a
chip.

Set-up builds one ``Trainer`` and its state, loads the benchmark's seeded
weights into it, and drives it through its first steps with the window's
own call, ``Trainer.train_epoch``: ``setup_single_steps`` epochs of one
batch each (the call's remainder path, one eager step), then one epoch of
``steps_per_call`` batches (the K-step call: the CUDA graph is captured
there and replayed). The program's readings are the losses it logs for
those epochs, the first gradient worked out from Adam's first moment
after step 1 (mu = 0.1 g), its parameters after the single steps and
after the K-step call, and the change of Adam's first moment over that
call (a weighted sum of the gradients the graph computed).
The same state then runs the window: whole epochs of the data set until
``seconds`` have passed, each ending in a synchronise (``train_epoch``
reads its losses back). ``train_examples_per_s`` is every example of the
window's epochs over the window (on several chips the global batch, the
sum over the cards).

With ``trace`` the window runs as well (``data_ms.train`` and
``mfu.train`` read it), and then ``trace_batches`` more batches run under
the profiler (harness/profile.py) on every rank.

After the window, with the program's state freed, the reference
(``configs/<config>.ref.py`` through reference/train.py) follows the same
steps from the same weights, batches and seed on chip 0, and the check
compares them (harness/check.py).
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time
import types

import numpy as np

from portbench.harness import check, counts, device as devmod, spec, weights
from portbench.harness.profile import Traced, top, traced_launches


class Recorded:
    """The data set handed to ``Trainer``: every batch it yields is timed
    (``spans``: seconds to produce each, on the loader's thread) and, while
    ``keep`` is set, kept for the reference."""

    def __init__(self, data, keep: bool = True):
        self.data = data
        self.keep = keep
        self.kept: list[dict] = []
        self.spans: list[float] = []

    def __len__(self):
        return len(self.data)

    def num_batches(self) -> int:
        return self.data.num_batches()

    def epoch(self, augment: bool = False):
        it = self.data.epoch(augment=augment)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.spans.append(time.perf_counter() - t0)
            if self.keep:
                self.kept.append({k: np.array(v, copy=True)
                                  for k, v in batch.items()})
            yield batch

    def take(self, n: int) -> "Take":
        return Take(self, n)


class Take:
    """The first ``n`` batches of a fresh epoch of ``source`` (all of them
    where it has fewer)."""

    def __init__(self, source: Recorded, n: int):
        self.source, self.n = source, n

    def num_batches(self) -> int:
        return min(self.n, self.source.num_batches())

    def epoch(self, augment: bool = False):
        for i, batch in enumerate(self.source.epoch(augment)):
            yield batch
            if i + 1 == self.n:
                return


def make_data(cfg: dict, batch: int, seed: int):
    """The data set of the configuration's data kind (``inputs/<kind>.py``
    ``train_set``)."""
    return spec.inputs(cfg["data"]["kind"]).train_set(cfg, batch, seed)


def _train_config(cfg: dict, mix: dict, chips: int, seed: int, log_dir: str):
    from pointnet2_tpu_torch.train import TrainConfig

    r = cfg["train"]
    return TrainConfig(
        model=cfg["model"], num_point=cfg["num_point"],
        batch_size=mix["batch_per_chip"] * chips, max_epoch=1,
        learning_rate=r["learning_rate"], optimizer=r["optimizer"],
        decay_step=r["decay_step"], decay_rate=r["decay_rate"],
        bn_init_decay=r["bn_init_decay"], bn_decay_rate=r["bn_decay_rate"],
        bn_decay_clip=r["bn_decay_clip"], augment=r["augment"],
        steps_per_call=mix["steps_per_call"],
        num_devices=chips if chips > 1 else None, log_dir=log_dir,
        seed=seed, compute_dtype=cfg["dtype"],
        model_kwargs={"num_classes": cfg["num_classes"]})


def _logged_losses(log_dir: str) -> list[float]:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["loss"] for r in rows if r.get("split") == "train"]


_STATS = ("running_mean", "running_var")


def _leaves(model) -> list[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def build(cfg: dict, mix: dict, chips: int, seed: int, device_name: str,
          log_dir: str):
    """The program under test: a ``Trainer`` and a fresh state holding the
    benchmark's weights for ``seed``, and the recorded data set."""
    import torch

    from pointnet2_tpu_torch import config as pconfig
    from pointnet2_tpu_torch.train import Trainer

    pconfig.set_fused_mlp(cfg["fused_mlp"])
    trainer = Trainer(_train_config(cfg, mix, chips, seed, log_dir),
                      device=device_name)
    state = trainer.init_state()
    w = weights.make(torch, cfg, seed, trainer.device)
    state.model.load_state_dict(w, strict=True)
    data = Recorded(make_data(cfg, mix["batch_per_chip"] * chips, seed))
    return trainer, state, w, data


def first_steps(trainer, state, w: dict, data: Recorded, singles: int,
                K: int, log_dir: str):
    """Drive a fresh state through its first steps with the window's own
    call: ``singles`` one-batch epochs, then one epoch of ``K`` batches.
    Returns the program's readings (on the primary rank; the losses are
    those ``Trainer`` logs; the first gradient from Adam's first moment
    after step 1, mu = 0.1 g; the parameters at the start, after the
    single steps and after the K-step call; the change of Adam's first
    moment over the K-step call, mu - b1^K mu_before, a weighted sum of the
    call's gradients; batch norm's running statistics after step 1) and
    the batches the steps took; ``data`` stops keeping batches."""
    leaves = _leaves(state.model)
    opt = state.optimizer
    grad1 = None
    for e in range(singles):
        trainer.train_epoch(state, data.take(1), e)
        if e == 0:
            grad1 = {k: (m / (1 - opt.b1)).detach().clone() for k, m in
                     zip(leaves, opt.mu)}
            stats1 = {k: b.detach().clone() for k, b in
                      state.model.named_buffers() if k.endswith(_STATS)}
    after_singles = {k: p.detach().clone() for k, p in
                     zip(leaves, opt.params)}
    mu_singles = [m.detach().clone() for m in opt.mu]
    trainer.train_epoch(state, data.take(K), singles)
    after_call = {k: p.detach().clone() for k, p in
                  zip(leaves, opt.params)}
    moment_call = {k: m.detach() - opt.b1 ** K * m0 for k, m, m0 in
                   zip(leaves, opt.mu, mu_singles)}
    losses = (_logged_losses(log_dir) if trainer.mesh.rank == 0
              else [float("nan")] * (singles + 1))
    batches = data.kept[:singles + K]
    data.keep, data.kept = False, []
    data.spans.clear()
    return ({"losses": losses[:singles + 1], "grad1": grad1,
             "stats1": stats1, "start": w, "after_singles": after_singles,
             "after_call": after_call, "moment_call": moment_call}, batches)


def rank_main(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
              trace: bool, clock_start: float, out_path: str | None,
              device_name: str = "cuda", plant: str | None = None) -> dict:
    """One rank's run; rank 0's result (also written to ``out_path``)."""
    import torch
    import torch.distributed as dist

    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.parallel import multihost

    spec.plant(plant)
    clock = devmod.Clock()
    clock.start = clock_start
    chips = cell["chips"]
    log_dir = tempfile.mkdtemp(prefix="portbench-train-")
    trainer, state, w, data = build(cfg, mix, chips, seed, device_name,
                                    log_dir)
    dev = trainer.device
    cuda = dev.type == "cuda"
    rank = trainer.mesh.rank
    group = multihost.host_group() if trainer.mesh.size > 1 else None

    singles, K = mix["setup_single_steps"], mix["steps_per_call"]
    prog, batches = first_steps(trainer, state, w, data, singles, K, log_dir)
    epoch = singles + 1
    if cuda:
        torch.cuda.synchronize(dev)
    if group is not None:
        dist.barrier(group=group)

    # the window
    setup_s = clock.now()
    epochs, t0 = 0, time.perf_counter()
    while True:
        go = [time.perf_counter() - t0 < seconds]
        if group is not None:
            dist.broadcast_object_list(go, src=0, group=group)
        if not go[0]:
            break
        trainer.train_epoch(state, data, epoch)
        epoch += 1
        epochs += 1
    window_s = time.perf_counter() - t0
    examples = epochs * len(data)
    steps = epochs * data.num_batches()
    spans = list(data.spans)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    summary, launch_check = None, None
    if trace:
        before = {k: f.launches for k, f in ops.KERNELS.items()}
        traced_data = data.take(mix["trace_batches"])
        with Traced(torch) as traced:
            with torch.profiler.record_function("portbench.train_epoch"):
                trainer.train_epoch(state, traced_data, epoch)
        summary = traced.summary
        summary["steps"] = traced_data.num_batches()
        launched = {k: f.launches - before[k] for k, f in ops.KERNELS.items()}
        launch_check = {k: [traced_launches(summary, k), n]
                        for k, n in launched.items() if n}
    ranks = [{"peak": peak, "busy_s": summary and summary["busy_s"],
              "window_s": summary and summary["window_s"],
              "banned": devmod.banned_modules()}]
    if group is not None:
        gathered = [None] * trainer.mesh.size
        dist.all_gather_object(gathered, ranks[0], group=group)
        ranks = gathered
    fps_input = None
    if trace and rank == 0:
        fps_input = torch.from_numpy(batches[0]["points"][
            :mix["batch_per_chip"]]).to(dev)

    result = None
    if rank == 0:
        run = types.SimpleNamespace(
            torch=torch, cfg=cfg, mix=mix, cell=cell, device=dev,
            trace=summary, window_s=window_s, examples=examples,
            steps=steps, spans=spans, counts=counts, fps_input=fps_input,
            chips=chips, ref=spec.reference(cfg["name"]))
        per_layer = spec.read_per_layer(cell, run) if trace else {}
        trainer.close()
        del trainer, state, run
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = check.train_numbers(prog, reference_readings(
            torch, cfg, w, batches, seed, dev, singles))
        correct, checks = check.verdict(numbers, spec.limits(cell["name"]))
        busy = [r["busy_s"] for r in ranks]
        result = {
            "end_to_end": {"train_examples_per_s": examples / window_s
                           if examples else None, "setup_s": setup_s},
            "per_layer": per_layer,
            "attempted": steps, "failed": 0,
            "memory_peak_bytes": max(r["peak"] for r in ranks),
            "busy_s": (sum(busy) / len(busy)) if trace else None,
            "window_s": summary["window_s"] if trace else None,
            "breakdown": ({"device_ops": top(summary["device_s_by_name"]),
                           "idle_gaps": top(summary["gaps_s"])}
                          if trace else None),
            "launch_check": launch_check,
            "banned": sorted({b for r in ranks for b in r["banned"]}),
            "correct": correct, "checks": checks,
            "window": {"epochs": epochs, "steps": steps,
                       "examples": examples, "window_s": window_s},
        }
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f)
    else:
        trainer.close()
    shutil.rmtree(log_dir, ignore_errors=True)
    return result


def reference_readings(torch, cfg: dict, w: dict, batches: list, seed: int,
                       dev, singles: int, linear=None,
                       half_batch: bool = False) -> dict:
    """The reference over ``batches``, read as the program is read: the
    single steps' losses and the K-step epoch's mean loss, the first
    gradient, the running statistics after step 1, the parameters at the
    start, after the single steps and after the K-step call, and the
    change of the first moment over the K-step call."""
    from portbench.reference.train import B1, train_steps

    ref = train_steps(spec.reference(cfg["name"]), cfg, w, batches, seed,
                      dev, linear=linear, half_batch=half_batch)
    rl = ref["loss"]
    K = len(batches) - singles
    tail = [float(np.mean(rl[singles:]))] if rl[singles:] else []
    mu0, mu1 = ref["mu"][singles - 1], ref["mu"][-1]
    return {"losses": rl[:singles] + tail,
            "grad1": ref["grad1"], "stats1": ref["stats1"], "start": w,
            "after_singles": ref["params"][singles - 1],
            "after_call": ref["params"][-1],
            "moment_call": {k: mu1[k] - B1 ** K * mu0[k] for k in mu1}}


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, clock: devmod.Clock, device_name: str = "cuda",
        plant: str | None = None) -> dict:
    chips = cell["chips"]
    if chips == 1:
        return rank_main(cell, cfg, mix, seed, seconds, trace, clock.start,
                         None, device_name, plant)
    from pointnet2_tpu_torch.parallel import launch

    fd, out_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        rc = launch.spawn(rank_main, chips, device=device_name,
                          args=(cell, cfg, mix, seed, seconds, trace,
                                clock.start, out_path, device_name, plant),
                          timeout=330)
        if rc:
            raise RuntimeError(f"a rank exited with {rc}")
        with open(out_path) as f:
            return json.load(f)
    finally:
        os.unlink(out_path)


def calibrate_rank(cell: dict, cfg: dict, mix: dict, seeds: list,
                   controls: int, out_path: str, plant: str | None = None):
    """One rank's calibration (``calibrate``); rank 0 writes the rows."""
    import torch
    import torch.distributed as dist

    from portbench.reference.model import fp8

    spec.plant(plant)
    singles, K = mix["setup_single_steps"], mix["steps_per_call"]
    rows = []
    for n, seed in enumerate(seeds):
        log_dir = tempfile.mkdtemp(prefix="portbench-cal-")
        trainer, state, w, data = build(cfg, mix, cell["chips"], seed,
                                        "cuda", log_dir)
        dev, rank = trainer.device, trainer.mesh.rank
        prog, batches = first_steps(trainer, state, w, data, singles, K,
                                    log_dir)
        trainer.close()
        del trainer, state, data
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(log_dir, ignore_errors=True)
        if rank == 0:
            ref = reference_readings(torch, cfg, w, batches, seed, dev,
                                     singles)
            row = {"seed": seed,
                   "program": {**check.train_numbers(prog, ref),
                               **check.train_readings(prog, ref)},
                   "look": {k: sorted(g.items(), key=lambda kv: -kv[1])[:3]
                            for k, g in check.train_gaps(prog, ref).items()}}
            if n < controls:
                for name, kw in (("control", {"linear": fp8}),
                                 ("half_batch", {"half_batch": True})):
                    other = reference_readings(torch, cfg, w, batches, seed,
                                               dev, singles, **kw)
                    row[name] = {**check.train_numbers(other, ref),
                                 **check.train_readings(other, ref)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        if dist.is_initialized():
            dist.barrier()
    if not dist.is_initialized() or dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)


def calibrate(cell: dict, cfg: dict, mix: dict, seeds: list, controls: int,
              plant: str | None = None) -> list:
    """calibrate.py's rows: for each seed the program's numbers against
    the reference over the set-up's first steps (no window), and for the
    first ``controls`` seeds the control's (the reference with its dense
    products in float8) and the fault of half the batch left out (the
    reference's loss over the first half of the rows), each in the
    program's place. A cell on several chips calibrates in one process a
    rank."""
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        if cell["chips"] == 1:
            calibrate_rank(cell, cfg, mix, seeds, controls, out, plant)
        else:
            from pointnet2_tpu_torch.parallel import launch

            rc = launch.spawn(calibrate_rank, cell["chips"],
                              args=(cell, cfg, mix, seeds, controls, out,
                                    plant))
            if rc:
                raise RuntimeError(f"a rank exited with {rc}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)
