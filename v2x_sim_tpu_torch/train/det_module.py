"""Detection task module: the predict path and the training step.

Port of ``v2x_sim_tpu/train/det_module.py::DetModule`` for every
collaboration mode, with DiscoNet's KD, visibility input, MGDA and data
parallelism:

  * ``predict``: voxelize the padded points (merged into each agent's
    frame for upperbound), run the model, decode the top-K candidates per
    agent, suppress them with rotated NMS;
  * ``prepare_batch``: voxelize and assign sparse anchor targets once per
    batch (the rotated-IoU kernels run here), plus the teacher's merged
    occupancy when KD is on;
  * ``train_step``: forward in BatchNorm's training mode, focal and sparse
    smooth-L1 losses normalized by the positive count, plus
    ``kd_weight`` times the MSE between the student's fused map and the
    frozen teacher's (once teacher weights are loaded), backward,
    optional global-norm clipping, one Adam step at a constant or a
    scheduled learning rate; ``step`` counts the steps taken (JAX's
    ``TrainState.step``, which checkpoints carry);
    with ``mgda``, one backward per task and their MGDA combination;
  * ``use_vis``: the model's input is the occupancy followed by the
    visibility map over ``OCCUPIED`` (baked ``vis_maps``, else carved on
    the device from the points);
  * ``process_group`` (JAX's ``axis_name``): each rank of the group steps
    on its own rows of the global batch (``parallel/mesh.py``). The
    positive count and the KD element count are summed over the group
    before they divide, BatchNorm averages its batch moments over it, the
    gradients (each task's, with MGDA) are summed over it before clipping
    and Adam, the metrics are summed and the running stats averaged: the
    step is the single-process step on the global batch;
  * ``init_weights`` / ``init_teacher_weights``: fresh weights drawn as
    flax's default initializers draw them (``models/init.py``).

The model runs in the plain layout, with targets in plain (H, W, K)
anchor order; the JAX package's blocked heads and lazy regression decode
compute the same values for the TPU, and the loss sums do not depend on
the anchor order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.bridge import state_dict_from_flax
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.det.net import DetModel, DetOutput, TeacherModel, check_mode
from v2x_sim_tpu_torch.models.init import init_flax_defaults_
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.assign import (
    AnchorTargets,
    SparseTargets,
    assign_targets_batched,
    labels_from_sparse_idx,
)
from v2x_sim_tpu_torch.ops.nms import NMSResult, batched_nms
from v2x_sim_tpu_torch.ops.postprocess import decode_topk
from v2x_sim_tpu_torch.ops.visibility import OCCUPIED, visibility_batch
from v2x_sim_tpu_torch.ops.voxelize import merged_occupancy, voxelize_batch
from v2x_sim_tpu_torch.parallel.mesh import all_reduce_, average_, psum, sum_metrics
from v2x_sim_tpu_torch.utils.losses import (
    kd_mse_loss_sum,
    smooth_l1_loss_sparse_sum,
    softmax_focal_loss_sum,
)
from v2x_sim_tpu_torch.utils.mgda import mgda_grads

#: A constant learning rate, or a schedule: step count -> learning rate.
LearningRate = Union[float, Callable[[int], float]]

#: Batch keys the module reads: inputs, GT, and targets and visibility
#: maps baked offline.
BATCH_KEYS = (
    "points", "point_mask", "trans", "agent_mask", "occupancy", "gt_boxes", "gt_mask",
    "tgt_labels", "tgt_pos_idx", "tgt_ign_idx", "tgt_cells", "tgt_reg", "tgt_wts", "vis_maps",
)


def batch_to_device(batch: Mapping[str, Any], keys: Iterable[str], device: torch.device) -> dict:
    """The entries of ``batch`` named in ``keys`` (numpy arrays or
    tensors), as tensors on ``device``."""
    return {
        k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
        for k, v in batch.items()
        if k in keys
    }


def occupancy_input(batch: Mapping[str, torch.Tensor], mode: str, grid, dtype: torch.dtype
                    ) -> torch.Tensor:
    """A model's (B, A, H, W, D) occupancy in ``dtype``: ``occupancy`` as
    given, else the points voxelized (merged into each agent's frame for
    upperbound)."""
    if "occupancy" in batch:
        return batch["occupancy"].to(dtype)
    if mode == "upperbound":
        return merged_occupancy(batch["points"], batch["point_mask"], batch["trans"],
                                batch["agent_mask"].to(torch.bool), grid, dtype)
    return voxelize_batch(batch["points"], batch["point_mask"], grid, dtype)


class DetModule:
    """One detection model configuration on one device.

    Args:
      config: static geometry/anchor config.
      mode: collaboration mode (models/det/net.py::MODES).
      compute_dtype: activation dtype. With bfloat16, activations run in
        bf16 from the encoder input on, parameters stay float32, and the
        decode and the losses run in float32.
      device: None means the CUDA card, and raises when there is none.
      learning_rate: Adam's step size (betas 0.9, 0.999, eps 1e-8: optax's
        defaults): a float, or a schedule ``step -> lr`` read at the count
        of steps taken before each step, as optax's ``scale_by_schedule``
        reads it (:func:`warmup_cosine_decay`).
      grad_clip: clip gradients to this global norm before Adam, by optax's
        rule; 0 disables.
      width_mult: uniform scale of the STPN stage widths (1.0 = 32..512).
      kd_weight: weight of the KD MSE term; > 0 builds the model with
        ``kd`` and adds the teacher's input to ``prepare_batch``. The term
        applies once a teacher is loaded (``load_teacher_state_dict``,
        ``load_teacher_flax_variables`` or ``init_teacher_weights``).
      kd_reduce: "mean" divides the KD squared-error sum by its element
        count; "pos" by the positive count, as the detection terms.
      warp_flag, v2v_rounds, v2v_msg_norm: DetModel's.
      use_vis: feed the visibility map as D more input channels
        (DetModel's ``use_vis``); the teacher reads no visibility.
      mgda: train by MGDA over the cls, loc and (with a teacher) KD losses
        (:meth:`train_step`).
      process_group: the data-parallel group (``Mesh.data_group``) the
        step's sums run over; None steps alone.
    """

    def __init__(
        self,
        config: Config,
        mode: str = "disco",
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        learning_rate: LearningRate = 1e-3,
        grad_clip: float = 0.0,
        width_mult: float = 1.0,
        kd_weight: float = 0.0,
        kd_reduce: str = "mean",
        warp_flag: bool = True,
        v2v_rounds: int = 3,
        v2v_msg_norm: bool = False,
        use_vis: bool = False,
        mgda: bool = False,
        process_group=None,
    ):
        check_mode(mode)
        if kd_reduce not in ("mean", "pos"):
            raise ValueError(f"kd_reduce must be 'mean' or 'pos', got {kd_reduce!r}")
        self.config = config
        self.mode = mode
        self.width_mult = width_mult
        self.kd_weight = kd_weight
        self.kd_reduce = kd_reduce
        self.compute_dtype = compute_dtype
        self.use_vis = use_vis
        self.mgda = mgda
        self.device = resolve_device(device)
        # Activations arrive channels-last (permuted NHWC views), so the
        # conv weights take the same memory format.
        self.model = DetModel(
            config, mode, width_mult, warp_flag=warp_flag, v2v_rounds=v2v_rounds,
            v2v_msg_norm=v2v_msg_norm, kd=kd_weight > 0.0, use_vis=use_vis,
        ).to(self.device, memory_format=torch.channels_last)
        self.model.eval()  # BatchNorm's mode is the `train` argument, not this flag
        self.process_group = process_group
        self.model.set_process_group(process_group)
        #: The frozen early-fusion teacher, once its weights are loaded.
        self.teacher: Optional[TeacherModel] = None
        self.anchors = torch.from_numpy(anchor_grid(config)).to(self.device)
        # 3x3 score peaks before top-K at <= 0.5 m voxels, where one
        # vehicle saturates many anchors; off at coarse grids.
        self.peak_window = 3 if config.grid.voxel_size[0] <= 0.5 else 0
        self.grad_clip = grad_clip
        self.learning_rate = learning_rate
        self.optimizer = adam(self.model.parameters(), learning_rate)
        #: Optimization steps taken (host-side; checkpoints carry it).
        self.step = 0

    def init_weights(self, seed: int) -> None:
        """Fresh model weights, drawn from ``seed`` as flax's defaults."""
        init_flax_defaults_(self.model, seed)

    def load_flax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load a flax ``{params, batch_stats}`` tree (numpy leaves)."""
        sd = state_dict_from_flax(variables, self.mode)
        self.model.load_state_dict(sd, strict=True)

    def load_teacher_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load the KD teacher from the state_dict of an upperbound
        ``DetModel`` (its weights stay frozen; it runs in BatchNorm's
        inference mode in the student's parameter dtype)."""
        if self.kd_weight <= 0.0:
            raise ValueError("the teacher is used only with kd_weight > 0")
        dtype = next(self.model.parameters()).dtype
        teacher = TeacherModel(self.config, self.width_mult)
        teacher.load_state_dict(state_dict, strict=True)
        self.teacher = teacher.to(self.device, dtype, memory_format=torch.channels_last).eval()
        self.teacher.requires_grad_(False)

    def load_teacher_flax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load the KD teacher from a flax tree of an upperbound model."""
        self.load_teacher_state_dict(state_dict_from_flax(variables, "upperbound"))

    def init_teacher_weights(self, seed: int) -> None:
        """A KD teacher with fresh weights drawn from ``seed`` as flax's
        defaults (what the training tool trains against when no teacher
        checkpoint is given)."""
        teacher = init_flax_defaults_(TeacherModel(self.config, self.width_mult), seed)
        self.load_teacher_state_dict(teacher.state_dict())

    def to_device(self, batch: Mapping[str, Any]) -> dict:
        """The batch entries the module reads, as tensors on this device."""
        return batch_to_device(batch, BATCH_KEYS, self.device)

    def model_input(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(B, A, H, W, D) occupancy in the compute dtype: ``occupancy`` as
        given, else the points voxelized (merged for upperbound), followed
        with ``use_vis`` by the D channels of :meth:`vis_input`."""
        occ = occupancy_input(batch, self.mode, self.config.grid, self.compute_dtype)
        if self.use_vis and "occupancy" not in batch:
            occ = torch.cat([occ, self.vis_input(batch)], dim=-1)
        return occ

    def vis_input(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(B, A, H, W, D) visibility in [0, 1], in the compute dtype: the
        baked ``vis_maps``, else each agent's own cloud carved on this
        device (ops/visibility.py, DEFAULT_NUM_SAMPLES rays a point), over
        ``OCCUPIED``."""
        if "vis_maps" in batch:
            vis = batch["vis_maps"]
        else:
            vis = visibility_batch(batch["points"], batch["point_mask"], self.config.grid)
        return vis.to(self.compute_dtype) / OCCUPIED

    def merged_occupancy(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Early-fusion occupancy of a device batch (ops/voxelize.py)."""
        return merged_occupancy(batch["points"], batch["point_mask"], batch["trans"],
                                batch["agent_mask"].to(torch.bool), self.config.grid,
                                self.compute_dtype)

    @torch.inference_mode()
    def predict(
        self,
        batch: Mapping[str, Any],
        max_boxes: Optional[int] = None,
        nms_iou: float = 0.1,
        score_threshold: float = 0.3,
    ) -> NMSResult:
        """Forward -> score -> decode -> NMS.

        ``batch`` holds ``points`` (B, A, P, 3) with ``point_mask``, or a
        precomputed ``occupancy``; plus ``trans`` and ``agent_mask``
        (numpy arrays or tensors). Returns per-(batch, agent) NMSResult with
        (B, A, K, 5) boxes, K = max_boxes or config.max_boxes.
        """
        batch = self.to_device(batch)
        k = max_boxes or self.config.max_boxes
        agent_mask = batch["agent_mask"].to(torch.bool)
        out = self.model(self.model_input(batch), batch["trans"], agent_mask)
        boxes, scores, valid = decode_topk(
            out.cls_logits, out.reg, self.anchors, k, score_threshold, agent_mask,
            peak_window=self.peak_window,
        )
        return batched_nms(boxes, scores, valid, nms_iou)

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #

    def targets_from_gt(self, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                        flat: Union[bool, str] = False) -> Union[AnchorTargets, SparseTargets]:
        """Anchor assignment of (B, A, M, 5) GT over all B*A agent-scenes
        at once, in ``assign_targets_batched``'s ``flat`` layout (dense by
        default, as in JAX; "sparse" is the training path's); every field
        comes back as (B, A, ...)."""
        b, a, m, _ = gt_boxes.shape
        out = assign_targets_batched(
            gt_boxes.reshape(b * a, m, 5), gt_mask.reshape(b * a, m), self.anchors, self.config,
            flat=flat)
        return type(out)(*(t.reshape((b, a) + t.shape[1:]) for t in out))

    @torch.no_grad()
    def prepare_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Per-batch preprocessing on the device: ``occupancy``, ``trans``,
        ``agent_mask``, the training targets of :meth:`targets`, and with
        KD the teacher's merged ``teacher_occupancy``."""
        bt = self.to_device(batch)
        out = {"occupancy": self.model_input(bt), "trans": bt["trans"],
               "agent_mask": bt["agent_mask"], **self.targets(bt)}
        if self.kd_weight > 0.0:
            out["teacher_occupancy"] = self.merged_occupancy(bt)
        return out

    @torch.no_grad()
    def targets(self, bt: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Training targets of a batch on this device, assigned from GT
        (``gt_boxes``, ``gt_mask``) or baked offline (``tgt_pos_idx``/
        ``tgt_ign_idx`` or ``tgt_labels``, with ``tgt_cells``, ``tgt_reg``,
        ``tgt_wts``).

        Returns flat ``labels`` (B, A, H*W*K) int8, ``reg_cell``/``reg_lane``
        (B, A, Pc*K), ``reg_sp_t`` (B, A, Pc*K, 6) and ``reg_sp_w``
        (B, A, Pc*K) float32, and, from GT, ``overflow`` (B, A).
        """
        h, w = self.config.grid.bev_shape
        k = self.config.anchors.num_anchors
        out = {}
        if "tgt_labels" in bt or "tgt_pos_idx" in bt:
            labels = bt["tgt_labels"] if "tgt_labels" in bt else labels_from_sparse_idx(
                bt["tgt_pos_idx"], bt["tgt_ign_idx"], h * w * k)
            cells, reg, wts = bt["tgt_cells"], bt["tgt_reg"], bt["tgt_wts"]
        else:
            sp = self.targets_from_gt(bt["gt_boxes"], bt["gt_mask"], flat="sparse")
            labels, cells, reg, wts = sp.labels, sp.cells, sp.reg, sp.wts
            out["overflow"] = sp.overflow
        b, a, pc = cells.shape
        out["labels"] = labels.reshape(b, a, -1).to(torch.int8)
        # (cell, lane) of each target in the heads' (H*W, K*6) folding.
        out["reg_cell"] = cells.long()[..., None].expand(b, a, pc, k).reshape(b, a, pc * k)
        out["reg_lane"] = torch.arange(k, device=self.device).repeat(pc).expand(b, a, pc * k)
        # Baked targets may arrive compressed (bf16 reg, int8 wts).
        out["reg_sp_t"] = reg.float()
        out["reg_sp_w"] = wts.float()
        return out

    def loss_from_output(
        self, out: DetOutput, prepared: Mapping[str, torch.Tensor],
        teacher_feat: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Focal + sparse smooth-L1 loss of a forward's output against the
        prepared targets, with padded agents masked out of both terms, each
        normalized by max(positive count, 1); with ``teacher_feat``, plus
        ``kd_weight`` times the KD MSE of ``out.fused_feat`` against it
        (padded agents included, as in the JAX package). Under a process
        group the counts are the group's sums, so each term is this rank's
        share of the global batch's."""
        am = prepared["agent_mask"].to(torch.bool)
        b, a = am.shape
        labels = torch.where(am[:, :, None], prepared["labels"].reshape(b, a, -1), -1)
        sp_w = prepared["reg_sp_w"] * am[:, :, None].float()
        cls_sum, num_pos = softmax_focal_loss_sum(out.cls_logits, labels)
        r_cells = out.reg.shape[2] * out.reg.shape[3]
        loc_sum, _ = smooth_l1_loss_sparse_sum(
            out.reg.reshape(b, a, r_cells, -1), prepared["reg_cell"], prepared["reg_lane"],
            prepared["reg_sp_t"], sp_w)
        if self.process_group is not None:
            num_pos = psum(num_pos, self.process_group)
        denom = num_pos.clamp(min=1.0)
        cls_loss, loc_loss = cls_sum / denom, loc_sum / denom
        loss = cls_loss + loc_loss
        metrics = {"cls_loss": cls_loss, "loc_loss": loc_loss}
        if teacher_feat is not None:
            kd_sum, kd_n = kd_mse_loss_sum(out.fused_feat, teacher_feat)
            if self.kd_reduce == "pos":
                kd_n = denom
            elif self.process_group is not None:
                kd_n = psum(kd_n, self.process_group)
            kd = kd_sum / kd_n.clamp(min=1.0)
            loss = loss + self.kd_weight * kd
            metrics["kd_loss"] = kd
        metrics["loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def teacher_features(self, prepared: Mapping[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """The frozen teacher's fusion-layer map on ``teacher_occupancy``,
        or None when KD is off or no teacher is loaded."""
        if self.kd_weight <= 0.0 or self.teacher is None:
            return None
        return self.teacher.kd_target(prepared["teacher_occupancy"])

    def loss(
        self, prepared: Mapping[str, torch.Tensor], train: bool = True
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward (BatchNorm in training mode when ``train``, which updates
        the running stats) and the loss; returns (loss, metrics)."""
        am = prepared["agent_mask"].to(torch.bool)
        out = self.model(prepared["occupancy"], prepared["trans"], am, train=train)
        return self.loss_from_output(out, prepared, self.teacher_features(prepared))

    def train_step(self, prepared: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimization step on a prepared batch. Returns the metrics
        as device tensors; nothing waits for the device.

        With ``mgda``: one forward in BatchNorm's training mode (the running
        stats update once, as the JAX step's do), then one backward per
        task (``cls_loss``, ``loc_loss``, and ``kd_loss`` once a teacher is
        loaded; the teacher runs once), each task's gradient zero where its
        loss does not reach; their MGDA combination (utils/mgda.py) becomes
        every parameter's gradient, zeros included, so that Adam advances
        every moment as optax does. The metrics add ``mgda_w_<task>``.

        Under a process group the gradients (each task's before MGDA) and
        the metrics are summed over it, and the running stats averaged,
        before clipping and Adam."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.mgda:
            metrics = self._mgda_backward(prepared)
        else:
            loss, metrics = self.loss(prepared, train=True)
            loss.backward()
            all_reduce_([p.grad for p in self.model.parameters() if p.grad is not None],
                        self.process_group)
            metrics = sum_metrics(metrics, self.process_group)
        # A no-op in value (BatchNorm synced the moments), kept as JAX's pmean.
        average_([b for b in self.model.buffers() if b.is_floating_point()], self.process_group)
        if self.grad_clip > 0.0:
            clip_by_global_norm_(
                [p.grad for p in self.model.parameters() if p.grad is not None], self.grad_clip)
        set_scheduled_lr(self.optimizer, self.learning_rate, self.step)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def _mgda_backward(self, prepared: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Set every parameter's ``.grad`` to the MGDA combination of the
        task gradients; returns the metrics with the task weights."""
        _, metrics = self.loss(prepared, train=True)
        tasks = ["cls_loss", "loc_loss"] + (["kd_loss"] if "kd_loss" in metrics else [])
        params = list(self.model.parameters())
        grads = []
        for i, key in enumerate(tasks):
            g = torch.autograd.grad(metrics[key], params, retain_graph=i + 1 < len(tasks),
                                    allow_unused=True)
            grads.append([torch.zeros_like(p) if gi is None else gi for p, gi in zip(params, g)])
            all_reduce_(grads[-1], self.process_group)
        combined, weights = mgda_grads(grads)
        for p, g in zip(params, combined):
            p.grad = g
        metrics = sum_metrics(metrics, self.process_group)
        metrics.update({f"mgda_w_{key}": weights[i] for i, key in enumerate(tasks)})
        return metrics


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient becomes
    g / norm * max_norm when the global norm reaches max_norm, and stays as
    it is below (no epsilon, unlike torch's clip_grad_norm_). Returns the
    norm, without a host sync."""
    grads = list(grads)
    acc = torch.promote_types(grads[0].dtype, torch.float32)
    norm = torch.stack([g.to(acc).square().sum() for g in grads]).sum().sqrt()
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def adam(params: Iterable[torch.nn.Parameter], learning_rate: LearningRate) -> torch.optim.Adam:
    """Adam with optax's defaults (betas 0.9, 0.999, eps 1e-8), at
    ``learning_rate`` or, for a schedule, at its step-0 value."""
    lr = learning_rate(0) if callable(learning_rate) else learning_rate
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_scheduled_lr(optimizer: torch.optim.Optimizer, learning_rate: LearningRate,
                     step: int) -> None:
    """Before a step: every param group's lr to ``learning_rate(step)``,
    ``step`` being the count of steps already taken (a no-op for a float)."""
    if callable(learning_rate):
        lr = float(learning_rate(step))
        for group in optimizer.param_groups:
            group["lr"] = lr


def warmup_cosine_decay(peak: float, steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, steps, 0.05 *
    peak)`` written out, with warmup = max(1, min(steps // 10, 200)): a
    linear rise from 0 over the warmup, then a cosine decay to 5% of the
    peak at ``steps``, held there after."""
    warmup = max(1, min(steps // 10, 200))
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs steps > {warmup}, got {steps}")

    def schedule(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        t = min(step - warmup, decay)
        return peak * (0.95 * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + 0.05)

    return schedule
