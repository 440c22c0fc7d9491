"""Weight bridge: flax ``{params, batch_stats}`` tree -> the port's state_dict.

One weight tree serves both packages. This is the inverse of the layout
rules of ``v2x_sim_tpu/train/torch_convert.py``:

  * conv ``kernel`` (kh, kw, in, out)   -> ``weight`` (out, in, kh, kw)
  * BatchNorm ``scale``/``bias``        -> ``weight``/``bias``
  * BatchNorm ``mean``/``var``          -> ``running_mean``/``running_var``
  * biases pass through unchanged.

The module-name table is the port's own copy of
``v2x_sim_tpu/baselines/torch_ref.py::key_map``, so the JAX package's
``convert_state_dict(port.state_dict(), key_map(mode))`` returns the
original tree. Trees arrive as nested dicts of numpy arrays (or anything
``np.asarray`` takes).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from v2x_sim_tpu_torch.models.backbone import STAGE_CHANNELS

_BLOCK_PARTS = (("conv1", "Conv_0"), ("bn1", "BatchNorm_0"),
                ("conv2", "Conv_1"), ("bn2", "BatchNorm_1"))

_BN_LEAVES = (("weight", "params", "scale"), ("bias", "params", "bias"),
              ("running_mean", "batch_stats", "mean"),
              ("running_var", "batch_stats", "var"))


def key_map(mode: str = "disco") -> Dict[str, Tuple[str, ...]]:
    """Port module prefix -> flax DetModel module path."""
    m: Dict[str, Tuple[str, ...]] = {}
    for i in range(len(STAGE_CHANNELS)):
        for tk, fk in _BLOCK_PARTS:
            m[f"encoder.blocks.{i}.{tk}"] = ("encoder", f"ConvBlock_{i}", fk)
    for i in range(len(STAGE_CHANNELS) - 1):
        for tk, fk in _BLOCK_PARTS:
            m[f"decoder.blocks.{i}.{tk}"] = ("decoder", f"ConvBlock_{i}", fk)
    for head in ("cls_head", "reg_head"):
        m[f"{head}.conv1"] = (head, "Conv_0")
        m[f"{head}.conv2"] = (head, "Conv_1")
    if mode == "disco":
        m["fusion.edge_hidden"] = ("fusion", "edge_hidden")
        m["fusion.edge_score"] = ("fusion", "edge_score")
    return m


def _node(tree: Mapping[str, Any], path: Tuple[str, ...]) -> Mapping[str, Any]:
    for k in path:
        tree = tree[k]
    return tree


def _leaf_paths(tree: Mapping[str, Any], prefix=()) -> set:
    out = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, prefix + (k,))
        else:
            out.add(prefix + (k,))
    return out


def state_dict_from_flax(variables: Mapping[str, Any], mode: str = "disco") -> Dict[str, torch.Tensor]:
    """Convert a flax ``{"params", "batch_stats"}`` tree into a state_dict
    for ``DetModel(config, mode)``. Raises KeyError on a missing leaf and
    ValueError on a flax leaf the table does not consume."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    trees = {"params": params, "batch_stats": stats}
    used = {"params": set(), "batch_stats": set()}
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path in key_map(mode).items():
        node = _node(params, path)
        if "scale" in node:  # BatchNorm
            for tleaf, coll, fleaf in _BN_LEAVES:
                arr = np.asarray(_node(trees[coll], path)[fleaf], dtype=np.float32)
                sd[f"{prefix}.{tleaf}"] = torch.from_numpy(arr.copy())
                used[coll].add(path + (fleaf,))
            sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            continue
        kernel = np.asarray(node["kernel"], dtype=np.float32)
        sd[f"{prefix}.weight"] = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        used["params"].add(path + ("kernel",))
        if "bias" in node:
            sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(node["bias"], np.float32).copy())
            used["params"].add(path + ("bias",))
    for coll, tree in trees.items():
        extra = _leaf_paths(tree) - used[coll]
        if extra:
            raise ValueError(f"flax {coll} leaves with no port module: {sorted(extra)}")
    return sd


def random_flax_variables(model: torch.nn.Module, seed: int) -> Dict[str, Any]:
    """A flax-layout ``{params, batch_stats}`` tree of numpy arrays for the
    shapes of ``model`` (a ``DetModel``), drawn from
    ``np.random.default_rng(seed)``.

    He-normal conv kernels, small random biases and BatchNorm affines, and
    random running stats, so activations keep their scale through the
    depth and every parameter kind affects the output."""
    rng = np.random.default_rng(seed)
    kmap = key_map(model.mode)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}

    def put(coll, path, arr):
        node = out[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr.astype(np.float32)

    for key, t in model.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        path = kmap[prefix]
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and len(shape) == 4:
            o, i, kh, kw = shape
            std = math.sqrt(2.0 / (i * kh * kw))
            put("params", path + ("kernel",), rng.normal(0.0, std, (kh, kw, i, o)))
        elif leaf == "weight":
            put("params", path + ("scale",), rng.uniform(0.8, 1.2, shape))
        elif leaf == "bias":
            put("params", path + ("bias",), rng.normal(0.0, 0.1, shape))
        elif leaf == "running_mean":
            put("batch_stats", path + ("mean",), rng.uniform(-0.3, 0.3, shape))
        elif leaf == "running_var":
            put("batch_stats", path + ("var",), rng.uniform(0.5, 1.5, shape))
        else:
            raise ValueError(f"unexpected state_dict key {key}")
    return out
