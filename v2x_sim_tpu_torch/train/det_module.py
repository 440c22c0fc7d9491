"""Detection task module: the predict path.

Port of the predict half of ``v2x_sim_tpu/train/det_module.py::DetModule``:
voxelize the padded points, run the model, decode the top-K candidates
per agent, and suppress them with rotated NMS, all on one device. Training
is not ported yet (ROADMAP.md queue 1 item 7).

The model runs in the plain layout; the JAX package's blocked heads and
lazy regression decode compute the same values for the TPU.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.bridge import state_dict_from_flax
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.det.net import DetModel, check_mode
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.nms import NMSResult, batched_nms
from v2x_sim_tpu_torch.ops.postprocess import decode_topk
from v2x_sim_tpu_torch.ops.voxelize import voxelize_batch

#: Batch keys the predict path reads.
BATCH_KEYS = ("points", "point_mask", "trans", "agent_mask", "occupancy")


class DetModule:
    """One detection model configuration on one device.

    Args:
      config: static geometry/anchor config.
      mode: collaboration mode ("lowerbound" or "disco"; the JAX package's
        other modes raise NotImplementedError).
      compute_dtype: activation dtype. With bfloat16, activations run in
        bf16 from the encoder input on, parameters stay float32, and the
        decode casts to float32.
      device: None means the CUDA card, and raises when there is none.
    """

    def __init__(
        self,
        config: Config,
        mode: str = "disco",
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        check_mode(mode)
        self.config = config
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        # Activations arrive channels-last (permuted NHWC views), so the
        # conv weights take the same memory format.
        self.model = DetModel(config, mode).to(self.device, memory_format=torch.channels_last)
        self.model.eval()
        self.anchors = torch.from_numpy(anchor_grid(config)).to(self.device)
        # 3x3 score peaks before top-K at <= 0.5 m voxels, where one
        # vehicle saturates many anchors; off at coarse grids.
        self.peak_window = 3 if config.grid.voxel_size[0] <= 0.5 else 0

    def load_flax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load a flax ``{params, batch_stats}`` tree (numpy leaves)."""
        sd = state_dict_from_flax(variables, self.mode)
        self.model.load_state_dict(sd, strict=True)

    def to_device(self, batch: Mapping[str, Any]) -> dict:
        """The predict path's batch entries as tensors on this device."""
        return {
            k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(self.device)
            for k, v in batch.items()
            if k in BATCH_KEYS
        }

    def model_input(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(B, A, H, W, D) occupancy in the compute dtype."""
        if "occupancy" in batch:
            return batch["occupancy"].to(self.compute_dtype)
        return voxelize_batch(
            batch["points"], batch["point_mask"], self.config.grid, self.compute_dtype
        )

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
