"""Cumulative stage budget of the detection predict path (and training).

Port of ``v2x_sim_tpu/tools/profile_det.py``: the predict path of one
mode in bf16 at the production geometry (``--grid small`` for CPU runs),
timed in cumulative slices: vox, +enc, +fuse (collaborative modes),
+dec, +heads, +decode, +nms; a stage's cost is the difference of
adjacent rows. With ``--train 1``, ``prepare_batch`` (voxelize and the
anchor assignment) and ``train_step`` too. Each row runs once to warm up,
then ``--steps`` times, and ends in ``torch.cuda.synchronize()``; the
host clock over the ``--steps`` calls gives ms a batch. The first line
names the device: the card's name and power limit, or CPU.

    python -m v2x_sim_tpu_torch.tools.profile_det [--batch 16] [--steps 10] [--mode disco] [--train 1]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import NO_FUSION
from v2x_sim_tpu_torch.ops.nms import batched_nms
from v2x_sim_tpu_torch.ops.postprocess import decode_topk
from v2x_sim_tpu_torch.tools.common import device_label, grid_config, synchronize, tool_device
from v2x_sim_tpu_torch.train.det_module import DetModule

#: Predict's decode and NMS settings (the JAX tool's).
TOPK, SCORE_THRESHOLD, NMS_IOU = 128, 0.3, 0.1


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--mode", default="disco")
    p.add_argument("--train", type=int, default=0, help="also time prepare_batch/train_step")
    p.add_argument("--grid", default="full", choices=["full", "small"],
                   help="small = 64x64 BEV for CPU runs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def setup(args, device: torch.device):
    """The bf16 module with seeded weights and B=``args.batch`` scenes of
    the production synthetic spec, uploaded once."""
    cfg = Config(grid=grid_config(args.grid))
    spec = SyntheticSpec(points_per_agent=8192 if args.grid == "full" else 2048,
                         num_vehicles=12, max_gt=32)
    raw = generate_batch(cfg, spec, batch_size=args.batch, seed=0)
    module = DetModule(cfg, mode=args.mode, compute_dtype=torch.bfloat16, device=device)
    module.init_weights(0)
    return module, module.to_device(raw)


def stages(module: DetModule, batch: dict) -> Dict[str, Callable[[], object]]:
    """The cumulative predict slices, in order: label -> a call of the path
    up to that stage."""
    model = module.model
    tr, am = batch["trans"], batch["agent_mask"].to(torch.bool)
    a = am.shape[1]

    def vox():
        return module.model_input(batch)

    def enc():
        return model.encode(vox())

    def fuse():
        return model.fuse(enc(), tr, am)

    def dec():
        return model.decoder(fuse())

    def heads():
        return model.decode_heads(fuse(), a)

    def decode():
        out = heads()
        return decode_topk(out.cls_logits, out.reg, module.anchors, TOPK, SCORE_THRESHOLD, am,
                           peak_window=module.peak_window)

    def nms():
        return batched_nms(*decode(), NMS_IOU)

    rows = {"vox": vox, "+enc": enc}
    if module.mode not in NO_FUSION:
        rows["+fuse"] = fuse
    rows.update({"+dec": dec, "+heads": heads, "+decode": decode, "+nms": nms})
    return rows


def timed_ms(fn: Callable[[], object], steps: int, device: torch.device) -> float:
    """ms a call of ``fn`` over ``steps`` warm calls, each run ending in a
    synchronize."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Print the budget; returns {row label: ms a batch}."""
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f"device: {device_label(device)}")
    module, batch = setup(args, device)
    print(f"mode={args.mode} B={args.batch} cumulative stage budget (bf16):")
    out: Dict[str, float] = {}
    prev = 0.0
    with torch.inference_mode():
        for label, fn in stages(module, batch).items():
            ms = out[label] = timed_ms(fn, args.steps, device)
            print(f"{label:10s} {ms:8.2f} ms/batch  ({args.batch / ms * 1e3:7.1f} scenes/s)")
            if prev:
                print(f"{'':10s} {'':8s}    delta {ms - prev:+7.2f} ms")
            prev = ms
    if args.train:
        ms = out["prepare"] = timed_ms(lambda: module.prepare_batch(batch), args.steps, device)
        print(f"{'prepare':10s} {ms:8.2f} ms/batch")
        prepared = module.prepare_batch(batch)
        ms = out["train"] = timed_ms(lambda: module.train_step(prepared), args.steps, device)
        print(f"{'train':10s} {ms:8.2f} ms/batch  ({args.batch / ms * 1e3:7.1f} scenes/s)")
    return out


if __name__ == "__main__":
    main()
