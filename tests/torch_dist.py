"""Multi-process helpers of the port's parallel tests: gloo ranks on the CPU
and the functions they run.

The ranks are spawned processes that rendezvous through a file store in
the test's ``tmp_path`` (no ports, so pytest-xdist's workers never
clash). Each rank runs torch on one thread, and every rendezvous,
collective and join waits at most ``TIMEOUT_S``: a hung rank fails its
test instead of stalling the suite. This module imports only numpy, torch
and the port, so the ranks never import JAX.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Mapping

import numpy as np
import torch

from v2x_sim_tpu_torch.models.backbone import ConvBlock, STPNEncoder
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from v2x_sim_tpu_torch.parallel import spatial
from v2x_sim_tpu_torch.parallel.mesh import Mesh, average_, make_mesh, shard_batch, spawn
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.train.seg_module import SegModule

TIMEOUT_S = 120.0


def run(fn, world: int, tmp_path, *args) -> list:
    """``fn(rank, world, init_method, *args)`` on ``world`` gloo ranks;
    their results in rank order."""
    return spawn(fn, world, args, store_dir=str(tmp_path), timeout=TIMEOUT_S)


def _mesh(rank: int, world: int, init_method: str, spatial_size: int = 1) -> Mesh:
    torch.set_num_threads(1)
    return make_mesh(world, spatial_size, rank=rank, init_method=init_method, device="cpu",
                     timeout=timedelta(seconds=TIMEOUT_S))


def _numpy(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def step_record(module, metrics: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A task module after one step: metrics, state_dict, Adam's moments."""
    named = dict(module.model.named_parameters())
    return {
        "metrics": {k: v.item() for k, v in metrics.items()},
        "state": _numpy(module.model.state_dict()),
        "exp_avg": _numpy({n: module.optimizer.state[p]["exp_avg"] for n, p in named.items()}),
        "exp_avg_sq": _numpy({n: module.optimizer.state[p]["exp_avg_sq"]
                              for n, p in named.items()}),
    }


def det_step(cfg, case: Mapping[str, Any], batch: Mapping[str, np.ndarray],
             process_group=None, spatial_group=None) -> Dict[str, Any]:
    """One float64 ``DetModule`` step of ``case`` (mode, DetModule options,
    flax weights, optional teacher) on ``batch``."""
    module = DetModule(cfg, case["mode"], torch.float64, device="cpu",
                       process_group=process_group, spatial_group=spatial_group, **case["opts"])
    module.model.double()
    module.load_flax_variables(case["variables"])
    if case.get("teacher") is not None:
        module.load_teacher_flax_variables(case["teacher"])
    return step_record(module, module.train_step(module.prepare_batch(batch)))


def seg_step(cfg, case: Mapping[str, Any], batch: Mapping[str, np.ndarray],
             process_group=None, spatial_group=None) -> Dict[str, Any]:
    """One float64 ``SegModule`` step of ``case`` on ``batch``."""
    module = SegModule(cfg, case["mode"], torch.float64, device="cpu",
                       process_group=process_group, spatial_group=spatial_group, **case["opts"])
    module.model.double()
    module.load_flax_variables(case["variables"])
    return step_record(module, module.train_step(module.prepare_batch(batch)))


def dp_steps(rank: int, world: int, init_method: str, cfg, det_cases: Mapping[str, Any],
             seg_cfg, seg_cases: Mapping[str, Any], batch: Mapping[str, np.ndarray],
             seg_batch: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Rank function: each case's step on this rank's rows of the global
    batch, over the data group of a (world, 1) mesh."""
    mesh = _mesh(rank, world, init_method)
    out = {name: det_step(cfg, case, shard_batch(batch, mesh), mesh.data_group)
           for name, case in det_cases.items()}
    out.update({name: seg_step(seg_cfg, case, shard_batch(seg_batch, mesh), mesh.data_group)
                for name, case in seg_cases.items()})
    try:  # the running stats' pmean, given values the ranks do not share
        average_([torch.full((3,), 1.0 + rank, dtype=torch.float64)], mesh.data_group)
        out["average_raises"] = False
    except RuntimeError:
        out["average_raises"] = True
    return out


def spatial_checks(rank: int, world: int, init_method: str, inputs: Mapping[str, Any]
                   ) -> Dict[str, Any]:
    """Rank function over a (1, world) mesh: every row-sharded op of
    ``parallel/spatial.py`` on this rank's rows of ``inputs``' maps (NCHW
    float64 unless noted). Returns each output shard."""
    mesh = _mesh(rank, world, init_method, spatial_size=world)
    group = mesh.spatial_group
    rows = lambda key: spatial.shard_rows(torch.from_numpy(inputs[key]), mesh)  # noqa: E731
    out: Dict[str, Any] = {}
    out["halo"] = spatial.halo_exchange_rows(rows("x"), group).numpy()
    w = torch.from_numpy(inputs["w"])
    out["conv"] = spatial.conv3x3_halo(rows("x"), w, group).numpy()
    out["conv_s2"] = spatial.conv3x3s2_halo(rows("x"), w, group).numpy()

    # Gradients through the exchange: d/dx and d/dw of sum(c * conv(x)).
    x = rows("x").requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    (spatial.conv3x3_halo(x, wg, group) * rows("cot")).sum().backward()
    wgrad = wg.grad.clone()
    torch.distributed.all_reduce(wgrad, group=group)
    out["grad_x"], out["grad_w"] = x.grad.numpy(), wgrad.numpy()

    encoder = STPNEncoder(inputs["enc_x"].shape[1], inputs["enc_channels"])
    encoder.load_state_dict(inputs["enc_state"])
    enc_x = rows("enc_x")
    with torch.no_grad():
        out["stem"] = spatial.make_spatial_stem(mesh, encoder.blocks[0])(enc_x).numpy()
        out["encoder"] = [f.numpy() for f in spatial.make_spatial_encoder(mesh, encoder)(enc_x)]

    block = ConvBlock(inputs["stem_x"].shape[1], inputs["stem_target"].shape[1])
    block.load_state_dict(inputs["stem_state"])
    step = spatial.make_spatial_stem_train_step(mesh, block, learning_rate=inputs["lr"])
    out["train_loss"] = step(rows("stem_x"), rows("stem_target")).item()
    out["train_state"] = _numpy(block.state_dict())
    return out



def _rows_model(model, state, occ, trans, mask, dtype=torch.float32, train: bool = False):
    """A model on this rank's rows of ``occ`` (B, A, H, W, D): its output
    rows, as numpy float32 (float64 for a float64 model)."""
    model.load_state_dict(state, strict=True)
    model.to(dtype if dtype != torch.bfloat16 else torch.float32)
    occ = spatial.take_rows(torch.from_numpy(occ).to(dtype), model.spatial_group)
    with torch.no_grad():
        out = model(occ, torch.from_numpy(trans), torch.from_numpy(mask), train=train)
    return [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy() for t in out
            if t is not None]


def spatial_model_checks(rank: int, world: int, init_method: str, inputs: Mapping[str, Any]
                         ) -> Dict[str, Any]:
    """Rank function over a (1, world) mesh: the channel-parallel conv and
    its float64 gradients, the sharded upsample, and the row-sharded
    ``DetModel``/``SegModel`` forwards of ``inputs``' cases. Returns each
    rank's outputs (for the row-sharded ones, its rows)."""
    mesh = _mesh(rank, world, init_method, spatial_size=world)
    g = mesh.spatial_group
    out: Dict[str, Any] = {}

    x, w = torch.from_numpy(inputs["cp_x"]), torch.from_numpy(inputs["cp_w"])
    cs = x.shape[1] // world
    part = slice(rank * cs, (rank + 1) * cs)
    out["cp"] = spatial.conv3x3_channel_parallel(x[:, part], w[:, part], g).numpy()
    x64 = x.double()[:, part].clone().requires_grad_(True)
    w64 = w.double()[:, part].clone().requires_grad_(True)
    y = spatial.conv3x3_channel_parallel(x64, w64, g)
    # Every rank takes the same loss of the replicated output: / n.
    ((y * torch.from_numpy(inputs["cp_cot"])).sum() / world).backward()
    out["cp_grad_x"], out["cp_grad_w"] = x64.grad.numpy(), w64.grad.numpy()

    for key in ("up", "up_bf16"):
        up = torch.from_numpy(inputs["up"])
        up = up.to(torch.bfloat16) if key == "up_bf16" else up
        got = spatial.upsample_bilinear_halo(spatial.take_rows(up, g), g)
        out[key] = got.float().numpy() if key == "up_bf16" else got.numpy()

    for name, case in inputs["models"].items():
        if case.get("world", world) != world:
            continue
        cfg = case["cfg"]
        if case["kind"] == "seg":
            model = SegModel(cfg, case["mode"], case["width"], case["depth"], spatial_group=g)
        else:
            model = DetModel(cfg, case["mode"], case["width"], fusion_layer=case["layer"],
                             spatial_group=g, **case.get("kw", {}))
        out[name] = _rows_model(model, case["state"], case["occ"], case["trans"], case["mask"],
                                case["dtype"], case.get("train", False))
    return out


def spatial_train_checks(rank: int, world: int, init_method: str, cfg, det_cases, seg_cfg,
                         seg_cases, batch: Mapping[str, np.ndarray], predict: Mapping[str, Any]
                         ) -> Dict[str, Any]:
    """Rank function over a (world / 2, 2) mesh: each case's float64 step on
    this data rank's scenes of ``batch`` with the rows sharded over the
    spatial group, and ``predict``'s float64 DetModule.predict on them."""
    mesh = _mesh(rank, world, init_method, spatial_size=2)
    local = shard_batch(batch, mesh)
    groups = {"process_group": mesh.data_group, "spatial_group": mesh.spatial_group}
    out = {name: det_step(cfg, case, local, **groups) for name, case in det_cases.items()}
    out.update({name: seg_step(seg_cfg, case, local, **groups)
                for name, case in seg_cases.items()})
    module = DetModule(cfg, predict["mode"], torch.float64, device="cpu",
                       spatial_group=mesh.spatial_group, **predict["opts"])
    module.model.double()
    module.load_flax_variables(predict["variables"])
    module.peak_window = predict["peak_window"]
    res = module.predict(local, max_boxes=predict["max_boxes"])
    out["predict"] = _numpy(res._asdict())
    return out


def bn_relu_ranks(rank: int, world: int, init_method: str, inputs: Mapping[str, Any]
                  ) -> Dict[str, Any]:
    """Rank function over a (world, 1) mesh: one bf16 train-mode BatchNorm +
    ReLU layer on this rank's map ``inputs["x"][rank]``, fused
    (``bn_cu.batch_norm_relu``) and unfused (``relu(_bn(...))``), its
    moments over the data group; forward and backward of
    ``inputs["dy"][rank]``. Returns each one's output, gradients and
    running stats (float32 numpy)."""
    from v2x_sim_tpu_torch.models.backbone import BN_MOMENTUM, _bn
    from v2x_sim_tpu_torch.ops.cuda import bn_cu

    mesh = _mesh(rank, world, init_method)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    out: Dict[str, Any] = {}
    for name in ("fused", "unfused"):
        bn = torch.nn.BatchNorm2d(inputs["weight"].shape[0], eps=1e-5)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(inputs["weight"]))
            bn.bias.copy_(torch.from_numpy(inputs["bias"]))
        x = bf16(inputs["x"][rank]).requires_grad_(True)
        if name == "fused":
            y = bn_cu.batch_norm_relu(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                      bn.eps, BN_MOMENTUM, mesh.data_group)
        else:
            y = torch.relu(_bn(x, bn, True, mesh.data_group))
        y.backward(bf16(inputs["dy"][rank]))
        out[name] = {k: v.detach().float().numpy() for k, v in (
            ("y", y), ("dx", x.grad), ("dweight", bn.weight.grad), ("dbias", bn.bias.grad),
            ("running_mean", bn.running_mean), ("running_var", bn.running_var))}
    return out
