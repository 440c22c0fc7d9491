"""Detection evaluation CLI.

Port of ``v2x_sim_tpu/tools/test_det.py`` (the reference's
``test_codet.py``): restores a checkpoint, predicts every batch (exact
top-K, ``config.max_boxes`` candidates, rotated NMS), optionally late-fuses
every agent's boxes into each ego frame, and prints per-agent ("local")
and averaged ("global") mAP@0.5/0.7 as JSON; optionally dumps the
detections for tracking and renders BEV plots.

    python -m v2x_sim_tpu_torch.tools.test_det --com disco --resume auto --logpath RUN

Evaluation seeds start at 2^31 (disjoint from training's) and are not
shuffled, so dumped detections stay in temporal order for
``tools/track.py`` (the dumps carry the batch's ``gt_ids`` when it has
them). Evaluation runs in float32 whatever ``--bf16`` says, as the JAX
tool's does. With ``--use_vis 1`` the model reads the batch's baked
``vis_maps``, or carves them on the device.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from v2x_sim_tpu_torch.ops.boxes import box_corners
from v2x_sim_tpu_torch.ops.postprocess import late_fuse
from v2x_sim_tpu_torch.tools.common import (
    add_common_args,
    build_config,
    device_and_dtype,
    fusion_settings,
    make_batches,
    resolve_mode,
)
from v2x_sim_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.utils.mean_ap import eval_map_agents


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--kd_flag", type=int, default=0)
    p.add_argument("--score_threshold", type=float, default=0.3)
    p.add_argument("--nms_iou", type=float, default=0.1)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--save_dets", default="", help="dir to dump per-batch detections")
    p.add_argument("--visualize", default="", help="dir for BEV renderings")
    p.add_argument(
        "--late_fusion", action="store_true",
        help="merge every agent's boxes into each ego frame and re-NMS "
        "(the reference's test-time late fusion)",
    )
    return p.parse_args(argv)


class Evaluation(NamedTuple):
    """The mAP dict (unrounded; the JSON printout rounds to 4 places), and
    the host seconds spent predicting (late fusion and the copy of the
    detections to the host included) and computing mAP."""

    metrics: dict
    predict_s: float
    map_s: float


def main(argv: Optional[Sequence[str]] = None) -> Evaluation:
    args = parse_args(argv)
    config = build_config(args)
    mode = resolve_mode(args)
    device, _ = device_and_dtype(args)
    module = DetModule(config, mode, torch.float32, device, width_mult=args.width_mult,
                       fusion=fusion_settings(args, mode), use_vis=bool(args.use_vis))
    path = args.resume if args.resume != "auto" else latest_checkpoint(args.logpath)
    if path:
        restore_checkpoint(path, module)
        print(f"loaded checkpoint {path}")
    elif args.resume == "auto":
        raise SystemExit(f"--resume auto: no checkpoint under {args.logpath}")
    else:
        module.init_weights(0)
        print("WARNING: no --resume given: evaluating randomly initialized weights; "
              "the metrics below are meaningless.")

    dets = {k: [] for k in ("boxes", "scores", "valid", "gt_boxes", "gt_mask", "agent_mask")}
    predict_s = 0.0
    for bi, raw in enumerate(
        make_batches(args, config, split_seed=2**31, num_batches=args.num_batches, shuffle=False)
    ):
        t0 = time.perf_counter()
        # Baked training targets (tgt_*) are dead weight here: not uploaded.
        batch = {k: v for k, v in raw.items() if not k.startswith("tgt_")}
        res = module.predict(batch, config.max_boxes, args.nms_iou, args.score_threshold)
        if args.late_fusion:
            bt = module.to_device({"trans": raw["trans"], "agent_mask": raw["agent_mask"]})
            res = late_fuse(res.boxes, torch.where(res.valid, res.scores, 0.0), res.valid,
                            bt["trans"], bt["agent_mask"].to(torch.bool), args.nms_iou,
                            config.max_boxes)
        boxes, scores, valid = (t.cpu().numpy() for t in res)
        predict_s += time.perf_counter() - t0
        for key, v in (("boxes", boxes), ("scores", scores), ("valid", valid),
                       ("gt_boxes", raw["gt_boxes"]), ("gt_mask", raw["gt_mask"]),
                       ("agent_mask", raw["agent_mask"])):
            dets[key].append(v)
        if args.save_dets:
            os.makedirs(args.save_dets, exist_ok=True)
            np.savez_compressed(
                os.path.join(args.save_dets, f"dets_{bi:05d}.npz"),
                boxes=boxes, scores=scores, valid=valid,
                gt_boxes=raw["gt_boxes"], gt_mask=raw["gt_mask"], agent_mask=raw["agent_mask"],
                # Real instance-track identities (nuScenes reader): the
                # tracking tools use them as MOT ground truth.
                **({"gt_ids": raw["gt_ids"]} if "gt_ids" in raw else {}),
            )
        if args.visualize:
            _render(args.visualize, bi, raw, boxes, valid, config)

    t0 = time.perf_counter()
    cat = {k: np.concatenate(v, axis=0) for k, v in dets.items()}
    metrics = eval_map_agents(
        cat["boxes"], cat["scores"], cat["valid"], cat["gt_boxes"], cat["gt_mask"],
        cat["agent_mask"], device=device)
    map_s = time.perf_counter() - t0
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}, indent=1))
    return Evaluation(metrics, predict_s, map_s)


def _render(outdir, bi, raw, boxes, valid, config):
    """BEV plot of GT (green) and detections (red), agent 0 of sample 0;
    nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(outdir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 6))
    (x0, x1), (y0, y1) = config.grid.area_extents[0], config.grid.area_extents[1]
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    gt = raw["gt_boxes"][0, 0][raw["gt_mask"][0, 0]]
    det = boxes[0, 0][valid[0, 0]]
    for b, color in ((gt, "g"), (det, "r")):
        if len(b) == 0:
            continue
        for quad in box_corners(torch.from_numpy(np.asarray(b, np.float32))).numpy():
            loop = np.vstack([quad, quad[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=1)
    fig.savefig(os.path.join(outdir, f"bev_{bi:04d}.png"), dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
