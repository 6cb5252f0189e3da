"""The numbers the check compares, and the verdict against their limits.

Training (the program against the reference that followed the same steps
from the same weights, batches and seed):

- ``stats_err``: batch norm's running statistics after the first step
  (the means and variances the step's forward found, folded in), by the
  median buffer: |s - s_ref| / |s_ref|;
- ``grad_gap``: the first gradient as the optimizer got it (worked out
  from Adam's first moment after step 1), by the median leaf: each leaf's
  | |g| - |g_ref| | over the larger of |g_ref| of that leaf and of the
  median leaf;
- ``change_gap``: the parameters' change over the K-step call (the CUDA
  graph the window replays), by the median leaf, in the same measure;
- ``moment_gap``: the change of Adam's first moment over the K-step call,
  mu - b1^K mu_before = (1 - b1) * sum_j b1^(K-1-j) g_j, a weighted sum of
  the gradients the graph computed, by the median leaf, in the same
  measure. Adam's step divides the moment by its second moment's root, so
  an early step's size hardly depends on the gradient and
  ``change_gap`` sees a frozen state but not a wrong gradient; this sees
  the graph's gradients.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the last three (a dense bias before batch norm, a batch
norm shift whose next layer is a dense before batch norm: their gradient
is nought but for rounding, and in bfloat16 its rounding is up to 38
times the median leaf's gradient). Not compared, for the reasons PERF.md gives with
their readings: the steps' losses and the worst leaf or buffer, which
swing from seed to seed as far in bfloat16 as in float8.

Serving (program logits against the reference's on the same blocks, every
point of the sampled requests):

- ``logit_err``: the largest relative error |L - L_ref| / |L_ref| of a
  sampled request (Frobenius norms);
- ``point_err``: the largest error of one point's logits, |L_i - L_ref_i|,
  over the root-mean-square norm of a point's reference logits.
"""

from __future__ import annotations

import math


def _norm(t) -> float:
    return float(t.double().norm())


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's | |prog| - |ref| | / max(|ref|, the median leaf's
    |ref|)."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: _norm(ref[k]) for k in names}
    med = _median(list(norms.values()))
    return {k: abs(_norm(prog[k]) - norms[k]) / max(norms[k], med)
            for k in names if max(norms[k], med) > 0}


def moved_leaves(grad_ref: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: _norm(v) for k, v in grad_ref.items()}
    floor = 1e-3 * _median(list(norms.values()))
    return {k for k, v in norms.items() if v >= floor}


def _delta(r: dict, a: str, b: str, keep) -> dict:
    return {k: r[b][k].to(r[a][k].device) - r[a][k] for k in keep}


def train_gaps(prog: dict, ref: dict) -> dict:
    """Per-leaf gaps of the first gradient (every leaf, and the moved
    ones), of the change over the single steps and over the K-step call,
    and of the first moment's change over the K-step call (moved
    leaves)."""
    keep = moved_leaves(ref["grad1"])
    return {
        "grad_all": leaf_gaps(prog["grad1"], ref["grad1"]),
        "grad": leaf_gaps(prog["grad1"], ref["grad1"], keep),
        "change_singles": leaf_gaps(
            _delta(prog, "start", "after_singles", keep),
            _delta(ref, "start", "after_singles", keep)),
        "change_call": leaf_gaps(
            _delta(prog, "after_singles", "after_call", keep),
            _delta(ref, "after_singles", "after_call", keep)),
        "moment_call": leaf_gaps(prog["moment_call"], ref["moment_call"],
                                 keep),
    }


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers (module docstring) of ``prog`` against ``ref``:
    {"losses", "grad1", "stats1", "start", "after_singles", "after_call",
    "moment_call"} over the same steps (train_epochs.first_steps)."""
    gaps = train_gaps(prog, ref)
    stats = stats_errors(prog["stats1"], ref["stats1"])
    return {
        "stats_err": _median(list(stats.values())),
        "grad_gap": _median(list(gaps["grad"].values())),
        "change_gap": _median(list(gaps["change_call"].values())),
        "moment_gap": _median(list(gaps["moment_call"].values())),
    }


def stats_errors(prog: dict, ref: dict) -> dict:
    """Each batch-norm buffer's |prog - ref| / |ref|."""
    return {k: float((prog[k].to(ref[k].device).double() - ref[k].double())
                     .norm() / ref[k].double().norm()) for k in ref}


def train_readings(prog: dict, ref: dict) -> dict:
    """Numbers the check does not compare, for the record of calibration:
    the later losses, the first gradient's and the change's worst leaf."""
    gaps = train_gaps(prog, ref)
    stats = stats_errors(prog["stats1"], ref["stats1"])
    return {
        "loss_gap": abs(prog["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "stats_worst_err": max(stats.values()),
        "loss_later_gap": max(abs(p - r) / abs(r) for p, r in
                              zip(prog["losses"][1:], ref["losses"][1:])),
        "grad_worst_gap": max(gaps["grad"].values()),
        "grad_all_worst_gap": max(gaps["grad_all"].values()),
        "change_worst_gap": max(gaps["change_call"].values()),
        "moment_worst_gap": max(gaps["moment_call"].values()),
        "change_singles_gap": _median(list(gaps["change_singles"].values())),
    }


def serve_numbers(torch, prog, ref) -> dict:
    """Numbers of one request's logits, (B, N, K) tensors on one device."""
    prog, ref = prog.double(), ref.double()
    rms = float(ref.square().mean().sqrt())
    point = (prog - ref).norm(dim=-1).amax()
    return {"logit_err": float((prog - ref).norm() / ref.norm()),
            "point_err": float(point) / (rms * ref.shape[-1] ** 0.5)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
