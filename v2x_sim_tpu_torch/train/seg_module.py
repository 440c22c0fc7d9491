"""Segmentation task module: the training step and the evaluation step.

Port of ``v2x_sim_tpu/train/seg_module.py::SegModule`` for every
collaboration mode, with data parallelism:

  * ``prepare_batch``: voxelize the padded points once per batch (merged
    into each agent's frame for upperbound);
  * ``train_step``: forward in BatchNorm's training mode, per-pixel
    cross-entropy over the real agents' labeled pixels, backward, one Adam
    step (no gradient clipping, unlike detection) at a constant or a
    scheduled learning rate; ``step`` counts the steps taken, which
    checkpoints carry;
  * ``eval_step``: the argmax class map and the batch's confusion matrix;
  * ``process_group``: as ``DetModule``'s (the labeled-pixel count summed
    over the group, BatchNorm's moments averaged, gradients and metrics
    summed, running stats averaged);
  * ``spatial_group``: as ``DetModule``'s (JAX's ``spatial_mesh``): the
    model runs on this rank's rows, ``prepare_batch`` keeps the rows of
    the occupancy and of the labels, and the sums run over the spatial
    group, then the data group; ``eval_step`` returns the whole class map
    of the data rank's scenes and their confusion matrix on every rank of
    the spatial group;
  * ``init_weights``: fresh weights drawn as flax's default initializers
    draw them (``models/init.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.bridge import model_key_map, state_dict_from_flax
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.init import init_flax_defaults_
from v2x_sim_tpu_torch.models.seg.unet import SegModel, SegOutput
from v2x_sim_tpu_torch.parallel.mesh import all_reduce_, average_, psum, sum_metrics
from v2x_sim_tpu_torch.parallel.spatial import gather_rows, take_rows
from v2x_sim_tpu_torch.train.det_module import (
    LearningRate,
    adam,
    batch_to_device,
    occupancy_input,
    set_scheduled_lr,
)
from v2x_sim_tpu_torch.utils.losses import seg_cross_entropy_sum
from v2x_sim_tpu_torch.utils.seg_metrics import confusion_matrix

#: Batch keys the module reads.
BATCH_KEYS = ("points", "point_mask", "trans", "agent_mask", "occupancy", "seg_labels")


class SegModule:
    """One segmentation model configuration on one device.

    Args:
      config: static geometry config.
      mode: collaboration mode (models/det/net.py::MODES).
      compute_dtype: activation dtype; parameters stay float32, the logits
        and the loss are float32.
      device: None means the CUDA card, and raises when there is none.
      learning_rate: Adam's step size (betas 0.9, 0.999, eps 1e-8: optax's
        defaults), a float or a schedule ``step -> lr`` (DetModule's).
      width_mult, depth: SegModel's.
      process_group: the data-parallel group the step's sums run over;
        None steps alone.
      spatial_group: the group the BEV rows are sharded over; None: whole
        maps.
    """

    def __init__(
        self,
        config: Config,
        mode: str = "lowerbound",
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        learning_rate: LearningRate = 1e-3,
        width_mult: float = 1.0,
        depth: int = 4,
        process_group=None,
        spatial_group=None,
    ):
        self.config = config
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.model = SegModel(config, mode, width_mult, depth, spatial_group).to(
            self.device, memory_format=torch.channels_last)
        self.model.eval()  # BatchNorm's mode is the `train` argument, not this flag
        self.spatial_group = spatial_group
        #: What the step's sums run over: the spatial group, then the data group.
        self.groups = tuple(g for g in (spatial_group, process_group) if g is not None) or None
        self.model.set_process_group(process_group)
        self.learning_rate = learning_rate
        self.optimizer = adam(self.model.parameters(), learning_rate)
        #: Optimization steps taken (host-side; checkpoints carry it).
        self.step = 0

    def init_weights(self, seed: int) -> None:
        """Fresh model weights, drawn from ``seed`` as flax's defaults."""
        init_flax_defaults_(self.model, seed)

    def load_flax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load a flax ``{params, batch_stats}`` tree of a SegModel."""
        sd = state_dict_from_flax(variables, model_key_map(self.model))
        self.model.load_state_dict(sd, strict=True)

    def to_device(self, batch: Mapping[str, Any]) -> dict:
        """The batch entries the module reads, as tensors on this device."""
        return batch_to_device(batch, BATCH_KEYS, self.device)

    def model_input(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(B, A, H, W, D) occupancy in the compute dtype: ``occupancy`` as
        given, else the points voxelized (merged for upperbound)."""
        return occupancy_input(batch, self.mode, self.config.grid, self.compute_dtype)

    @torch.no_grad()
    def prepare_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch on this device with its ``occupancy``: ``occupancy``,
        ``trans``, ``agent_mask`` and, where given, ``seg_labels``; with a
        spatial group, this rank's rows of the occupancy and the labels."""
        bt = self.to_device(batch)
        out = {"occupancy": self.model_input(bt), "trans": bt["trans"],
               "agent_mask": bt["agent_mask"]}
        if "seg_labels" in bt:
            out["seg_labels"] = bt["seg_labels"]
        if self.spatial_group is not None:
            for key in ("occupancy", "seg_labels"):
                if key in out:
                    out[key] = take_rows(out[key], self.spatial_group)
        return out

    def masked_labels(self, prepared: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(B, A, H, W) labels, -1 (ignored) at padded agents."""
        am = prepared["agent_mask"].to(torch.bool)
        return torch.where(am[:, :, None, None], prepared["seg_labels"], -1)

    def loss_from_output(self, out: SegOutput, prepared: Mapping[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy sum over max(labeled pixel count, 1), the count
        summed over the spatial and the process group."""
        ce_sum, ce_n = seg_cross_entropy_sum(out.logits, self.masked_labels(prepared),
                                             self.config.num_seg_classes)
        ce_n = psum(ce_n, self.groups)
        loss = ce_sum / ce_n.clamp(min=1.0)
        return loss, {"loss": loss}

    def loss(self, prepared: Mapping[str, torch.Tensor], train: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward (BatchNorm in training mode when ``train``, which updates
        the running stats) and the loss; returns (loss, metrics)."""
        am = prepared["agent_mask"].to(torch.bool)
        out = self.model(prepared["occupancy"], prepared["trans"], am, train=train)
        return self.loss_from_output(out, prepared)

    def train_step(self, prepared: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One Adam step on a prepared batch. Returns the metrics as device
        tensors; nothing waits for the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(prepared, train=True)
        loss.backward()
        all_reduce_([p.grad for p in self.model.parameters() if p.grad is not None],
                    self.groups)
        metrics = sum_metrics(metrics, self.groups)
        average_([b for b in self.model.buffers() if b.is_floating_point()], self.groups)
        set_scheduled_lr(self.optimizer, self.learning_rate, self.step)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.inference_mode()
    def eval_step(self, prepared: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred (B, A, H, W) int64, the (C, C) int64 confusion matrix of
        the batch's real agents' labeled pixels); with a spatial group, the
        whole map's and its confusion, on every rank of the group."""
        am = prepared["agent_mask"].to(torch.bool)
        out = self.model(prepared["occupancy"], prepared["trans"], am)
        pred = out.logits.argmax(dim=-1)
        conf = confusion_matrix(pred, self.masked_labels(prepared), self.config.num_seg_classes)
        if self.spatial_group is not None:
            pred = gather_rows(pred, self.spatial_group)
            all_reduce_([conf], self.spatial_group)
        return pred, conf
