"""Per-epoch checkpoints: save, find the latest, resume, load a KD teacher.

Port of ``v2x_sim_tpu/train/checkpoint.py`` with its names and its
``epoch_<n>`` naming, in a torch format: ``<dir>/epoch_<n>`` is one file
holding ``{"model": state_dict, "optimizer": state_dict, "step": int}``,
written to a temporary name and renamed into place, and read back onto
the CPU with ``torch.load(weights_only=True)`` (loading moves each tensor
to the module's device). A module is a ``DetModule`` or a ``SegModule``:
anything with ``model``, ``optimizer`` and ``step``. The JAX package's
orbax checkpoints are not read here (that needs JAX).
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(ckpt_dir: str, module, step: int) -> str:
    """Write ``module``'s (a ``DetModule`` or ``SegModule``) model and
    optimizer state and step count to ``<ckpt_dir>/epoch_<step>``
    atomically. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"epoch_{step}"))
    state = {
        "model": module.model.state_dict(),
        "optimizer": module.optimizer.state_dict(),
        "step": int(module.step),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``epoch_<n>`` checkpoint with the largest n, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_n = None, -1
    for name in os.listdir(ckpt_dir):
        if name.startswith("epoch_"):
            try:
                n = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if n > best_n:
                best_n, best = n, os.path.join(ckpt_dir, name)
    return os.path.abspath(best) if best else None


def _load(path: str) -> dict:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, module):
    """Load a checkpoint's model and optimizer state and step count into
    ``module`` (a ``DetModule`` or ``SegModule`` of the same mode and
    widths as the one saved). Returns it."""
    state = _load(path)
    module.model.load_state_dict(state["model"], strict=True)
    module.optimizer.load_state_dict(state["optimizer"])
    module.step = int(state["step"])
    return module


def restore_teacher(path: str, module):
    """Load the KD teacher of ``module`` (a ``DetModule`` with
    ``kd_weight > 0``) from an upperbound run's checkpoint: the reference's
    teacher is the trained early-fusion upperbound model, and
    ``TeacherModel``'s submodule names are ``DetModel``'s. Returns it."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"teacher checkpoint not found: {path}")
    module.load_teacher_state_dict(_load(path)["model"])
    return module
