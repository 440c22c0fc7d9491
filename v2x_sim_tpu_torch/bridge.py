"""Weight bridge between a flax ``{params, batch_stats}`` tree and the port.

One weight tree serves both packages, in both directions, and optax's
Adam state loads into the port's optimizer. The layout rules are the
inverse of those of ``v2x_sim_tpu/train/torch_convert.py``:

  * conv ``kernel`` (kh, kw, in, out)   -> ``weight`` (out, in, kh, kw)
  * Dense ``kernel`` (in, out)          -> ``Linear.weight`` (out, in)
  * BatchNorm ``scale``/``bias``        -> ``weight``/``bias``
  * BatchNorm ``mean``/``var``          -> ``running_mean``/``running_var``
  * GroupNorm ``scale``/``bias``        -> ``weight``/``bias`` (no stats)
  * biases pass through unchanged; a module without one has no ``bias``.

A key map names, for each port module, its flax module path. The
detection table (``key_map(mode)``) extends the port's own copy of
``v2x_sim_tpu/baselines/torch_ref.py::key_map`` with every mode's fusion
modules, so the JAX package's
``convert_state_dict(port.state_dict(), key_map(mode))`` returns the
original tree. ``TeacherModel`` has DetModel's submodule names, so an
upperbound tree loads as the teacher. The segmentation table
(``seg_key_map(mode, depth)``) names SegModel's ``down{i}``,
``bottleneck``, ``up{i}``, ``head`` and ``fusion``. The converters take a
key map, or a det mode for ``key_map(mode)``; ``model_key_map(model)``
gives the one that matches a model. Trees arrive as nested dicts of numpy
arrays (or anything ``np.asarray`` takes).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from v2x_sim_tpu_torch.models.backbone import STAGE_CHANNELS
from v2x_sim_tpu_torch.models.seg.unet import SegModel

KeyMap = Mapping[str, Tuple[str, ...]]

_BLOCK_PARTS = (("conv1", "Conv_0"), ("bn1", "BatchNorm_0"),
                ("conv2", "Conv_1"), ("bn2", "BatchNorm_1"))

#: Each mode's fusion modules: port prefix under ``fusion.`` -> flax path
#: under ``fusion``. sum, mean, max, lowerbound and upperbound have none.
_FUSION_MODULES = {
    "disco": {"edge_hidden": ("edge_hidden",), "edge_score": ("edge_score",)},
    "cat": {"compress": ("compress",)},
    "agent": {"score_hidden": ("score_hidden",), "score": ("score",)},
    "when2com": {
        **{f"query_key_net.{n}": ("query_key_net", n)
           for n in ("Conv_0", "Conv_1", "Conv_2", "query_proj", "key_proj")},
        "attn_w": ("attn_w",),
    },
    "v2v": {"conv_gru.gates": ("conv_gru", "gates"),
            "conv_gru.candidate": ("conv_gru", "candidate"),
            "msg_hidden": ("msg_hidden",), "msg_out": ("msg_out",),
            "msg_norm": ("msg_norm",)},
}
_FUSION_MODULES["who2com"] = _FUSION_MODULES["when2com"]

#: Modules with a ``scale`` that are GroupNorms: no running statistics.
_GROUP_NORMS = frozenset({"fusion.msg_norm"})


def key_map(mode: str = "disco") -> Dict[str, Tuple[str, ...]]:
    """Port module prefix -> flax DetModel module path (V2VNet's optional
    GroupNorm included)."""
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
    for tk, fk in _FUSION_MODULES.get(mode, {}).items():
        m[f"fusion.{tk}"] = ("fusion",) + fk
    return m


def seg_key_map(mode: str = "lowerbound", depth: int = 4) -> Dict[str, Tuple[str, ...]]:
    """Port module prefix -> flax SegModel module path."""
    m: Dict[str, Tuple[str, ...]] = {}
    blocks = [(f"downs.{i}", f"down{i}") for i in range(depth)] + [("bottleneck", "bottleneck")]
    blocks += [(f"ups.{i}", f"up{i}") for i in range(depth)]
    for tp, fp in blocks:
        for tk, fk in _BLOCK_PARTS:
            m[f"{tp}.{tk}"] = (fp, fk)
    m["head"] = ("head",)
    for tk, fk in _FUSION_MODULES.get(mode, {}).items():
        m[f"fusion.{tk}"] = ("fusion",) + fk
    return m


def model_key_map(model: torch.nn.Module) -> Dict[str, Tuple[str, ...]]:
    """The key map of ``model``: a ``SegModel`` (its mode and depth) or a
    ``DetModel``/``TeacherModel`` (its mode)."""
    if isinstance(model, SegModel):
        return seg_key_map(model.mode, model.depth)
    return key_map(model.mode)


def _as_key_map(kmap: Union[str, KeyMap]) -> KeyMap:
    """A key map as given, or the det key map of a mode."""
    return key_map(kmap) if isinstance(kmap, str) else kmap


def _tree_key_map(params: Mapping[str, Any], kmap: KeyMap) -> Dict[str, Tuple[str, ...]]:
    """``kmap`` for the modules a flax ``params`` tree holds: V2VNet's
    GroupNorm only where the tree has it."""
    has_norm = "msg_norm" in params.get("fusion", {})
    return {k: v for k, v in kmap.items() if has_norm or k != "fusion.msg_norm"}


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


def _param_tensors(params: Mapping[str, Any], kmap: KeyMap, used: set) -> Dict[str, torch.Tensor]:
    """Port parameter name -> float32 tensor from a flax ``params`` tree, or
    from any tree of its shape (optax's Adam moments). Records each flax
    path it reads in ``used``."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path in _tree_key_map(params, kmap).items():
        node = _node(params, path)
        weight = "scale" if "scale" in node else "kernel"  # a norm, or a conv or Dense
        for tleaf, fleaf in (("weight", weight), ("bias", "bias")):
            if fleaf == "bias" and "bias" not in node:  # ConvBlock's convs, attn_w
                continue
            arr = np.asarray(node[fleaf], dtype=np.float32)
            if fleaf == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            sd[f"{prefix}.{tleaf}"] = torch.from_numpy(arr.copy())
            used.add(path + (fleaf,))
    return sd


def state_dict_from_flax(variables: Mapping[str, Any],
                         kmap: Union[str, KeyMap] = "disco") -> Dict[str, torch.Tensor]:
    """Convert a flax ``{"params", "batch_stats"}`` tree into the state_dict
    of the model ``kmap`` names (a key map, or a mode for ``DetModel(config,
    mode)``). Raises KeyError on a missing leaf and ValueError on a flax
    leaf the table does not consume."""
    kmap = _as_key_map(kmap)
    params, stats = variables["params"], variables.get("batch_stats", {})
    used = {"params": set(), "batch_stats": set()}
    sd = _param_tensors(params, kmap, used["params"])
    for prefix, path in _tree_key_map(params, kmap).items():
        if "scale" not in _node(params, path) or prefix in _GROUP_NORMS:
            continue
        for tleaf, fleaf in (("running_mean", "mean"), ("running_var", "var")):
            arr = np.asarray(_node(stats, path)[fleaf], dtype=np.float32)
            sd[f"{prefix}.{tleaf}"] = torch.from_numpy(arr.copy())
            used["batch_stats"].add(path + (fleaf,))
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    for coll, tree in (("params", params), ("batch_stats", stats)):
        extra = _leaf_paths(tree) - used[coll]
        if extra:
            raise ValueError(f"flax {coll} leaves with no port module: {sorted(extra)}")
    return sd


#: state_dict leaf -> (flax collection, flax leaf); ``weight`` is decided by its rank.
_FLAX_LEAF = {"bias": ("params", "bias"), "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def flax_from_state_dict(sd: Mapping[str, torch.Tensor],
                         kmap: Union[str, KeyMap] = "disco") -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_flax`: a numpy ``{params,
    batch_stats}`` tree from the port's state_dict, or from any subset of
    its keys (``{name: p.grad}`` gives the gradients as a flax tree).
    Leaves are float32, or float64 from a float64 model.
    ``num_batches_tracked`` has no flax leaf and is dropped."""
    kmap = _as_key_map(kmap)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().to(torch.promote_types(t.dtype, torch.float32)).numpy()
        if leaf == "weight":
            coll, fleaf = ("params", "scale") if arr.ndim == 1 else ("params", "kernel")
            if arr.ndim == 4:  # conv
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:  # Linear
                arr = arr.T
        else:
            coll, fleaf = _FLAX_LEAF[leaf]
        node = out[coll]
        for k in kmap[prefix]:
            node = node.setdefault(k, {})
        node[fleaf] = arr.copy()
    return out


def adam_state_from_optax(opt_state: Any, module: Any) -> None:
    """Load optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``), found
    anywhere in ``opt_state`` (a bare Adam state or a chain's tuple), into
    ``module.optimizer`` (``torch.optim.Adam`` over ``module.model``, a
    det or seg model), so a run of the JAX package continues in the port
    step for step."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    kmap = model_key_map(module.model)
    mu = _param_tensors(adam.mu, kmap, set())
    nu = _param_tensors(adam.nu, kmap, set())
    step = float(np.asarray(adam.count))
    for name, p in module.model.named_parameters():
        module.optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p),
            "exp_avg_sq": nu[name].to(p),
        }


def _find_adam(state: Any) -> Any:
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def random_flax_variables(model: torch.nn.Module, seed: int) -> Dict[str, Any]:
    """A flax-layout ``{params, batch_stats}`` tree of numpy arrays for the
    shapes of ``model`` (a ``DetModel`` or a ``SegModel``), drawn from
    ``np.random.default_rng(seed)``.

    He-normal conv and Dense kernels, small random biases and norm
    affines, and random running stats, so activations keep their scale
    through the depth and every parameter kind affects the output."""
    rng = np.random.default_rng(seed)
    kmap = model_key_map(model)
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
        elif leaf == "weight" and len(shape) == 2:
            o, i = shape
            put("params", path + ("kernel",), rng.normal(0.0, math.sqrt(2.0 / i), (i, o)))
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
