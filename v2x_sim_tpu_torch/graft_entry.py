"""Entry points of the flagship model and the multi-device training surface.

The counterpart of the JAX package's root ``__graft_entry__.py``:

  * :func:`entry`: the DiscoNet forward with its example arguments, on a
    small grid;
  * :func:`dryrun_multichip`: one training step of each of five variants
    of the multi-device surface on ``n`` ranks (``parallel/mesh.py``),
    each printing ``dryrun ... ok: {metrics}``.

``python -m v2x_sim_tpu_torch.graft_entry`` runs ``dryrun_multichip(8)``.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Optional, Union

import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch

#: How long the dry run's ranks may take in all, seconds.
DRYRUN_TIMEOUT_S = 900.0


def _tiny_setup():
    """The dry run's geometry: a 64 x 64 x 8 BEV at 1 m voxels (the
    production code path on a small grid), and a light synthetic scene."""
    cfg = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
    spec = SyntheticSpec(num_vehicles=6, points_per_agent=1024, max_gt=8, points_per_vehicle=48)
    return cfg, spec


def entry(device: Optional[Union[str, torch.device]] = None):
    """The forward step of the flagship model (DiscoNet fusion).

    Returns ``(fn, (model, occupancy, trans, agent_mask))``: one synthetic
    scene voxelized on ``device`` (the card by default), ``DetModel(cfg,
    "disco")`` with flax-default weights drawn from seed 0, and ``fn(model,
    occupancy, trans, agent_mask) -> (cls_logits, reg)``, the forward in
    BatchNorm's inference semantics.
    """
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.models.init import init_flax_defaults_
    from v2x_sim_tpu_torch.ops.voxelize import voxelize_batch

    dev = resolve_device(device)
    cfg, spec = _tiny_setup()
    raw = generate_batch(cfg, spec, batch_size=1, seed=0)
    occ = voxelize_batch(torch.from_numpy(raw["points"]).to(dev),
                         torch.from_numpy(raw["point_mask"]).to(dev), cfg.grid)
    trans = torch.from_numpy(raw["trans"]).to(dev)
    agent_mask = torch.from_numpy(raw["agent_mask"]).to(dev)
    model = init_flax_defaults_(DetModel(cfg, "disco"), seed=0)
    model = model.to(dev, memory_format=torch.channels_last).eval()

    @torch.no_grad()
    def fn(model, occ, trans, agent_mask):
        out = model(occ, trans, agent_mask, train=False)
        return out.cls_logits, out.reg

    return fn, (model, occ, trans, agent_mask)


def dryrun_multichip(n_devices: int, device: Optional[Union[str, torch.device]] = None) -> None:
    """One training step of each multi-device variant on ``n_devices``
    ranks, printing ``dryrun ... ok: {metrics}`` for each:

      A. disco + KD (kd_weight 10) under data parallelism, the teacher
         replicated;
      B. MGDA under data parallelism;
      C. det on a (data n/2, spatial 2) mesh: the BEV rows sharded;
      D1. SegModule (depth 2) under data parallelism;
      D2. seg on the (data, spatial) mesh.

    The ranks are ``n_devices`` fresh processes (``parallel/mesh.py::
    spawn``) joined over gloo; rank r runs on ``cuda:(r mod cards)``, so
    ranks may share a card, or on the CPU with ``device="cpu"``. The
    global batch holds ``n_devices`` scenes. Raises RuntimeError when a
    rank fails, and when there is no card unless ``device="cpu"``.
    """
    from v2x_sim_tpu_torch.parallel.mesh import spawn

    kind = resolve_device(device).type
    store = tempfile.mkdtemp(prefix="v2x_dryrun_")
    try:
        results = spawn(_dryrun_rank, n_devices, (kind,), store_dir=store,
                        timeout=DRYRUN_TIMEOUT_S)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    for name, metrics, *extra in results[0]:
        print(f"dryrun {name} ok:", metrics, *extra, flush=True)


def _dryrun_rank(rank: int, world: int, init_method: str, kind: str) -> list:
    """One rank of :func:`dryrun_multichip`: the five variants' steps;
    returns [(variant name, {metric: float}, ...)], the metrics the global
    batch's. The names are the JAX dry run's ("gspmd" there: one program
    partitioned by XLA; here the ranks of the (data, spatial) mesh)."""
    from v2x_sim_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    if kind == "cpu":
        torch.set_num_threads(1)
        dev = "cpu"
    else:
        dev = f"cuda:{rank % torch.cuda.device_count()}"
    cfg, spec = _tiny_setup()
    mesh = make_mesh(world, rank=rank, init_method=init_method, backend="gloo", device=dev)
    mesh2 = make_mesh(world, 2, backend="gloo", device=dev)
    raw = generate_batch(cfg, spec, batch_size=world, seed=0)
    raw.pop("visible", None)
    local, local2 = shard_batch(raw, mesh), shard_batch(raw, mesh2)

    def step(module, batch, seed, teacher_seed=None):
        module.init_weights(seed)
        if teacher_seed is not None:
            module.init_teacher_weights(teacher_seed)
        replicate(module, mesh)
        metrics = module.train_step(module.prepare_batch(batch))
        return {k: float(v) for k, v in metrics.items()}

    dp, sharded = {"process_group": mesh.data_group}, {
        "process_group": mesh2.data_group, "spatial_group": mesh2.spatial_group}
    return [
        ("disco+kd", step(DetModule(cfg, "disco", kd_weight=10.0, device=dev, **dp), local, 0,
                          teacher_seed=1)),
        ("mgda", step(DetModule(cfg, "disco", mgda=True, device=dev, **dp), local, 2)),
        ("gspmd dp x spatial", step(DetModule(cfg, "disco", device=dev, **sharded), local2, 3),
         "devices:", world),
        ("seg dp", step(SegModule(cfg, "disco", depth=2, device=dev, **dp), local, 4)),
        ("gspmd seg dp x spatial", step(SegModule(cfg, "disco", depth=2, device=dev, **sharded),
                                        local2, 5)),
    ]


if __name__ == "__main__":
    from v2x_sim_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(8)
