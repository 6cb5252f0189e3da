"""Checkpoints with exact resume, in a torch format.

Port of pointnet2_tpu/train/checkpoint.py. A checkpoint ``<name>`` is the
directory ``<log_dir>/<name>/`` holding one ``torch.save`` file,
``state.pt``, with

- ``model``: the model's ``state_dict`` (parameters and BN running
  statistics);
- ``optimizer``: the optimizer's ``count`` and moments (Adam's ``mu`` and
  ``nu``, Momentum's ``trace``, in parameter order);
- ``step``;
- ``generator``: the trainer's ``torch.Generator`` state, when one is
  given. JAX's checkpoint re-seeds its PRNG on resume; keeping the
  generator makes a resumed run draw what the uninterrupted one draws, so
  2 + 2 epochs equal 4 bit for bit.

Only tensors, lists, dicts and numbers are saved, so ``torch.load`` reads
it with ``weights_only=True``. The sidecar ``<name>.meta.json`` holds
``{"step", "epoch", "score"?}``: the completed epochs, so a resume does not
derive them from the step, and the best checkpoint's selection score, so a
resumed run's first eval cannot overwrite a better best checkpoint.

On several ranks the primary writes and every rank waits at a barrier
after the write; every rank restores the same file onto its own device.
The generators of all ranks hold the same state (each draws for the global
batch), so one file resumes them all.

Overwriting is crash-safe: the new checkpoint is written to
``<name>.new``, then two renames swap it in through ``<name>.old``; a
crash between them leaves ``<name>.old``, which ``load_meta``,
``restore_checkpoint`` and the next save recover.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.train.state import TrainState

_FILE = "state.pt"


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), name)


def _meta_path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), f"{name}.meta.json")


def save_checkpoint(directory: str, state: TrainState, name: str = "ckpt",
                    epoch: int | None = None, score: float | None = None,
                    generator: torch.Generator | None = None) -> str:
    """Write ``state`` (and ``generator``'s state) as checkpoint ``name``.

    `epoch` is the number of completed epochs; `score` the best-checkpoint
    selection metric. Returns the checkpoint's directory."""
    path = _path(directory, name)
    new, old = path + ".new", path + ".old"
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    if generator is not None:
        payload["generator"] = generator.get_state()
    if multihost.is_primary():
        # a save that died between the two renames left only `.old`:
        # promote it back before `.old` is cleared as stale
        _recover_interrupted_swap(path)
        for stale in (new, old):
            shutil.rmtree(stale, ignore_errors=True)
        os.makedirs(new)
        torch.save(payload, os.path.join(new, _FILE))
        if os.path.isdir(path):
            os.rename(path, old)
        os.rename(new, path)  # the only window; `.old` recovers it
        shutil.rmtree(old, ignore_errors=True)
        meta = {"step": int(state.step), "epoch": epoch}
        if score is not None:
            meta["score"] = float(score)
        tmp = _meta_path(directory, name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, _meta_path(directory, name))
    multihost.barrier(f"ckpt_save:{name}")
    return path


def _recover_interrupted_swap(path: str) -> None:
    """A crash between save_checkpoint's two renames leaves `<name>.old`
    but no `<name>`: promote the previous generation back."""
    old = path + ".old"
    if not os.path.isdir(path) and os.path.isdir(old):
        try:
            os.rename(old, path)
        except FileNotFoundError:  # another rank promoted it first
            pass


def read_checkpoint(directory: str, name: str = "ckpt",
                    map_location="cpu") -> dict:
    """The saved dict of checkpoint ``name`` (module docstring), its
    tensors on `map_location`."""
    path = _path(directory, name)
    _recover_interrupted_swap(path)
    return torch.load(os.path.join(path, _FILE), map_location=map_location,
                      weights_only=True)


def restore_checkpoint(directory: str, state: TrainState,
                       name: str = "ckpt",
                       generator: torch.Generator | None = None
                       ) -> TrainState:
    """Load checkpoint ``name`` into ``state`` (its model and optimizer in
    place, its step) and ``generator``; returns ``state``."""
    device = next(state.model.parameters()).device
    saved = read_checkpoint(directory, name, map_location=device)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    if generator is not None:
        if "generator" not in saved:
            raise ValueError(f"checkpoint {name!r} holds no generator state")
        generator.set_state(saved["generator"].cpu())
    return state


def load_meta(directory: str, name: str = "ckpt") -> dict | None:
    """The sidecar record ({"step", "epoch", "score"?}) if the checkpoint
    exists, else None; without a readable sidecar, step and epoch are
    None."""
    path = _path(directory, name)
    _recover_interrupted_swap(path)
    if not os.path.isdir(path):
        return None
    try:
        with open(_meta_path(directory, name)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {"step": None, "epoch": None}


def latest_step(directory: str, name: str = "ckpt") -> int | None:
    meta = load_meta(directory, name)
    if meta is None:
        return None
    return meta.get("step") or 0
