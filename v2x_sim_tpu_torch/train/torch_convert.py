"""The reference's PyTorch checkpoints (``.pth``) into the port.

Counterpart of ``v2x_sim_tpu/train/torch_convert.py``, which turns a
reference state dict into the JAX package's flax tree (layouts
transposed, names remapped). The port's modules carry the reference
graph's own names and layouts (``bridge.key_map``), so here a state dict
is only renamed: each key's module prefix goes through a table
(reference prefix -> port prefix; the identity over ``bridge.key_map(mode)``
by default, a table edit for a checkpoint named otherwise), and the
reference's ``num_batches_tracked`` counters are dropped (the port's
BatchNorm follows flax's momentum and never reads them).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from v2x_sim_tpu_torch.bridge import key_map

#: The checkpoint wrappers :func:`load_pth` unwraps, in order.
WRAPPER_KEYS = ("model_state_dict", "state_dict")


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's state dict, read on the CPU with
    ``weights_only=True``: a bare state dict, or one wrapped under
    ``model_state_dict`` or ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in WRAPPER_KEYS:
        if isinstance(obj, dict) and key in obj:
            return obj[key]
    return obj


def state_dict_from_reference(sd: Mapping[str, Any], table: Optional[Mapping[str, str]] = None,
                              mode: str = "disco") -> Dict[str, torch.Tensor]:
    """Rename a reference state dict into the port's names.

    Args:
      sd: the reference model's state dict.
      table: reference module prefix -> port module prefix; None is the
        identity over ``bridge.key_map(mode)``.
      mode: the collaboration mode whose modules the default table names.

    Raises KeyError on a key whose module prefix the table does not name.
    """
    if table is None:
        table = {prefix: prefix for prefix in key_map(mode)}
    out = {}
    for key, value in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        if prefix not in table:
            raise KeyError(f"no port module for reference module '{prefix}' (key {key})")
        out[f"{table[prefix]}.{leaf}"] = torch.as_tensor(value)
    return out


def load_reference(model: torch.nn.Module, path: str,
                   table: Optional[Mapping[str, str]] = None) -> None:
    """Load the reference checkpoint at ``path`` into the port's
    ``model`` (a ``DetModel`` of the checkpoint's mode). Every parameter
    and running stat must be given: only the BatchNorm counters may be
    missing. Raises KeyError otherwise."""
    sd = state_dict_from_reference(load_pth(path), table, model.mode)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"reference checkpoint {path}: missing {missing}, unexpected {unexpected}")
