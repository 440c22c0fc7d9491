"""The system under test: the port's detection module, built from a
configuration file, and the calls a window drives.

The only module of the harness that imports the port. It takes from the
port the entry (``DetModule``: ``prepare_batch`` and ``train_step``, or
``predict``) and the configuration types it needs to build it.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Dict
from unittest import mock

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: The batch entries the entry reads: inputs and ground truth.
INPUT_KEYS = ("points", "point_mask", "trans", "agent_mask", "gt_boxes", "gt_mask")
#: A ``fusion`` key of the files under the name the port's constructor
#: gives it, where the two differ (``DiscoFusion(hidden=...)``).
PORT_NAMES = {"edge_hidden": "hidden"}


def port_config(config: dict):
    """The port's ``Config`` of a configuration file; raises where the
    port's derived sizes disagree with the file's."""
    from v2x_sim_tpu_torch.configs.config import AnchorConfig, Config, GridConfig
    from v2x_sim_tpu_torch.ops.assign import sparse_cell_capacity

    g, a = config["grid"], config["anchors"]
    grid = GridConfig(voxel_size=tuple(g["voxel_size"]),
                      area_extents=tuple(tuple(e) for e in g["area_extents"]))
    cfg = Config(grid=grid,
                 anchors=AnchorConfig(sizes=tuple(tuple(s) for s in a["sizes"]),
                                      box_code_size=a["box_code_size"],
                                      pos_iou_threshold=a["pos_iou_threshold"],
                                      neg_iou_threshold=a["neg_iou_threshold"]),
                 num_agents=config["num_agents"], num_classes=config["num_classes"],
                 fusion_layer=config["fusion_layer"])
    if list(grid.grid_shape) != list(g["shape"]):
        raise ValueError(f"grid {grid.grid_shape} != the file's shape {g['shape']}")
    if sparse_cell_capacity(cfg) != config["sparse_cell_capacity"]:
        raise ValueError("the port's positive-cell capacity differs from the file's")
    return cfg


def load() -> None:
    """Imports the port's modules that :func:`build` uses: a phase of
    set-up of its own (the port's imports pull in ``torch.distributed``)."""
    import v2x_sim_tpu_torch.models.backbone  # noqa: F401
    import v2x_sim_tpu_torch.train.det_module  # noqa: F401


def build(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """The port's ``DetModule`` for ``config`` on ``device``, with
    ``state_dict`` loaded; raises where it cannot run the file as stated."""
    from v2x_sim_tpu_torch.models.backbone import width_mult as scaled_widths
    from v2x_sim_tpu_torch.train.det_module import DetModule

    chans = config["stage_channels"]
    wm = chans[0] / 32
    if list(scaled_widths(wm)) != list(chans):
        raise ValueError(f"the port cannot run the widths {chans}")
    prec, opt = config["precision"], config["optimizer"]
    if prec["parameters"] != "float32" or prec["loss_sums"] != "float32":
        raise ValueError("the port keeps float32 parameters and loss sums")
    with fusion_keywords(config.get("fusion", {})):
        module = DetModule(port_config(config), config["mode"],
                           compute_dtype=DTYPES[prec["activations"]], device=device,
                           learning_rate=opt["lr"], width_mult=wm)
    defaults = module.optimizer.defaults
    if (tuple(defaults["betas"]) != tuple(opt["betas"]) or defaults["eps"] != opt["eps"]
            or type(module.optimizer).__name__ != "Adam"):
        raise ValueError(f"the port's optimizer {defaults} is not the file's {opt}")
    module.model.load_state_dict(state_dict, strict=True)
    return module


@contextlib.contextmanager
def fusion_keywords(fusion: dict):
    """Inside it, the fusion module the port's ``DetModel`` builds for its
    mode (``models/det/net.py::build_fusion``) is constructed with every
    key of the configuration's ``fusion`` block as a keyword, over what
    ``build_fusion`` passes. Raises where the mode has no fusion module to
    take a key, or its constructor has no such keyword: no key of the file
    goes unapplied."""
    from v2x_sim_tpu_torch.models.det import net

    build_fusion = net.build_fusion
    given = {PORT_NAMES.get(k, k): v for k, v in fusion.items()}

    def build(mode, *args, **kwargs):
        with torch.device("meta"):
            probe = build_fusion(mode, *args, **kwargs)
        if probe is None:
            if given:
                raise ValueError(f"mode {mode!r} has no fusion module to take {sorted(fusion)}")
            return None
        cls = type(probe)
        init = cls.__init__
        takes = inspect.signature(init).parameters
        unknown = sorted(k for k in fusion if PORT_NAMES.get(k, k) not in takes)
        if unknown:
            raise ValueError(f"the port's {cls.__name__} takes no fusion key {unknown}")

        def init_given(self, *a, **kw):
            init(self, *a, **{**kw, **given})

        with mock.patch.object(cls, "__init__", init_given):
            return build_fusion(mode, *args, **kwargs)

    with mock.patch.object(net, "build_fusion", build):
        yield


@contextlib.contextmanager
def nms_keeping_all():
    """A fault for ``calibrate.py``: inside it, the port's NMS keeps every
    valid candidate."""
    from v2x_sim_tpu_torch.ops import nms

    with mock.patch.object(nms, "greedy_keep", lambda iou, valid, threshold: valid.clone()):
        yield
