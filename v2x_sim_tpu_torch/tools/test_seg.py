"""Segmentation evaluation CLI.

Port of ``v2x_sim_tpu/tools/test_seg.py`` (the reference's
``test_seg.py``): restores a checkpoint, accumulates the confusion matrix
over the evaluation batches and prints the per-class IoU and the mIoU as
JSON, rounded to 4 places; optionally renders ground truth beside the
prediction.

    python -m v2x_sim_tpu_torch.tools.test_seg --com disco --resume auto --logpath RUN

Evaluation runs in float32 whatever ``--bf16`` says, as the JAX tool's
does. Evaluation seeds start at 2^31 (disjoint from training's) and are
not shuffled.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from v2x_sim_tpu_torch.tools.common import (
    add_common_args,
    build_config,
    device_and_dtype,
    make_batches,
    reject_use_vis,
    resolve_mode,
)
from v2x_sim_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
from v2x_sim_tpu_torch.train.seg_module import SegModule
from v2x_sim_tpu_torch.utils.seg_metrics import iou_from_confusion


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--visualize", default="", help="dir for pred-vs-GT BEV label map renderings")
    args = p.parse_args(argv)
    reject_use_vis(p, args)
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Evaluate; returns {class name: IoU, ..., "miou": mIoU}, unrounded."""
    args = parse_args(argv)
    config = build_config(args)
    device, _ = device_and_dtype(args)
    module = SegModule(config, resolve_mode(args), torch.float32, device,
                       width_mult=args.width_mult)
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

    c = config.num_seg_classes
    cm_total = torch.zeros((c, c), dtype=torch.int64, device=device)
    for bi, raw in enumerate(
        make_batches(args, config, split_seed=2**31, num_batches=args.num_batches, shuffle=False)
    ):
        pred, cm = module.eval_step(module.prepare_batch(raw))
        cm_total += cm
        if args.visualize:
            _render(args.visualize, bi, raw, pred[0, 0].cpu().numpy())

    metrics = iou_from_confusion(cm_total.cpu().numpy())
    out = {name: metrics[f"iou_class{i}"] for i, name in enumerate(config.seg_class_names)}
    out["miou"] = metrics["miou"]
    print(json.dumps({k: round(v, 4) for k, v in out.items()}, indent=1))
    return out


def _render(outdir, bi, raw, pred):
    """Ground truth beside the predicted BEV class map, agent 0 of sample
    0; nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(outdir, exist_ok=True)
    gt = np.asarray(raw["seg_labels"][0, 0])
    vmax = max(int(gt.max()), int(pred.max()), 1)
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    for ax, img, title in ((axes[0], gt, "GT"), (axes[1], pred, "pred")):
        ax.imshow(img, origin="lower", cmap="tab10", vmin=0, vmax=vmax)
        ax.set_title(title)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, f"seg_{bi:04d}.png"), dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
