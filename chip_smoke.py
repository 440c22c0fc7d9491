#!/usr/bin/env python3
"""Card checks of the PyTorch/CUDA port (v2x_sim_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--baseline OTHER.cu]

Three harnesses measure and check the port on the card, each with its own
share of the work:

  * tests/test_torch_cuda.py (python -m pytest --noconftest -m gpu) holds
    each kernel to its plain version over its edge cases, checks the
    inputs its wrapper rejects and counts its launches;
  * benchmark/run.py measures the whole model: its cells' rates,
    latencies and memory;
  * this script times each kernel alone on the main path's operands,
    beside its plain version and its bound, and holds it once to the
    plain version there, the gap the record's max_abs_err (PERF.md's
    kernel table and the last lines' kernels record), and runs the port's
    integration on
    the card: every mode, late fusion, KD, the tools, segmentation,
    visibility, MGDA, tracking, data parallelism and row sharding, bf16
    against the CPU, and the entry points.

Phases, each reported on its own line; any failure exits non-zero. There
is no phase 4 or 6: whole-model rates are benchmark/run.py's, and the other
phases keep their numbers, which logs and documents cite.

  1. Card and build: the card's name and power limit (nvidia-smi), then
     every kernel of the predict and training paths built from csrc/ with
     nvcc, with ptxas' register and spill report.
  2. Each kernel entry point against its plain PyTorch version on the
     card, with known-value cases: the NMS matrix, aligned pairs at 2^20
     and at the assignment's forced-anchor shape, periodic pairs at ~2^20
     with a period that tiles nothing; timed with CUDA events on these
     random boxes.
  3. Predict at full width: DiscoNet (6 agents, 256x256x13 BEV, widths
     32..512, fusion at stage 3) predicting B=16 synthetic scenes from
     seeded random weights that go through the weight bridge, finite in
     fp32 and in bf16. The matrix kernel's launch count must rise; the NMS
     IoU matrix must match the plain version on predict's own sorted
     candidates, where it is also timed; one scene must match the port
     run on the CPU.
  5. Training at full width: prepare_batch (voxelize + sparse anchor
     assignment) then train_step on B=16 scenes. The periodic kernel must
     launch exactly twice per prepare_batch, the forced-anchor entry once
     and the aligned pairs never; one scene's assignment and loss must
     match the port on the CPU; loss and grads stay finite and the loss
     falls over 8 fp32 steps on one batch. Then the assignment's kernels
     on that batch's own operands, timed and held against the plain
     version over every pair: the periodic entry on both nearest-GT
     candidates (2 x 37.7M pairs, exact zeros equal too); the
     forced-anchor entry (own_iou bit for bit; own_k, force and the cell
     equal), timed in turns against the chain of launches it replaced and
     beside an empty launch of its grid; the aligned pairs on the
     forced-anchor test's pairs.
  7. Every other collaboration mode (upperbound, sum, mean, max, cat,
     agent, when2com, who2com, v2v with 3 rounds) at the same geometry and
     B, random weights through the bridge: predict, where the matrix
     kernel must launch; scene 0 against the port on the CPU, strictly at
     every agent (logits within 1e-3; each agent's kept boxes the same set,
     in any order, with scores within 1e-4); a finite bf16 predict; one
     bf16 train step for cat, agent, when2com and v2v (finite loss and
     grads).
  8. Late fusion over disco's predict output with config.max_boxes (512)
     candidates per agent: the matrix kernel on the merged candidates
     (96 x 512 x 512) against its plain version over every pair (beyond
     1e-4, as accurate against the plain version in float64 as the fp32
     plain version is), timed against its bound; keep masks against the
     recomputation and, for
     scene 0, against late_fuse on the CPU over the same detections.
  9. DiscoNet's KD training: a disco student at kd_weight 1e5 with a
     random upperbound teacher. Launch counts of prepare_batch (which adds
     the teacher's merged occupancy), scene 0's loss and kd term against
     the CPU, the loss falling over 8 fp32 steps; one bf16 prepare + step
     (finite loss and grads).
 10. The detection workflow at full width, each tool's main(argv) run in
     this process in a temporary directory: create_data_det --targets 1
     bakes 2 x 16 synthetic frames (the periodic kernel launches exactly
     twice a frame, the forced-anchor entry once; frame 0's targets
     equal the CPU's bake of it; the frame's assignment kernels timed and
     held against the plain version); train_det trains 2 epochs of 2
     batches from the cache (no assignment launches; epoch_0, epoch_1;
     finite losses) and resumes at epoch 2; train_det on 6 batches of live
     targets, assigned in the prefetch thread on its own stream (step 1's
     loss against the same batch prepared on the main stream); test_det
     --resume auto, plain and with late fusion (the matrix kernel launches
     for NMS and for 2 thresholds x 6 agents of mAP; the mAP equals the
     CPU's over the same detections within 1e-6, and over the evaluation's
     GT jittered); the matrix kernel at mAP's operands (F x 512 x 32)
     against its plain version at every pair, those with a padded
     (zero-size) GT box included, and against its bound.
 11. BEV segmentation at full width: SegModel (UNet at depth 4, widths
     32..256, a 512-channel bottleneck at 16x16 where the agents' maps are
     fused) on B=16 synthetic scenes, random weights through the bridge.
     Disco: one eval step (finite logits; the confusion matrix sums to the
     labeled pixels and equals the CPU's count of the card's predictions),
     scene 0's logits against the port on the CPU (within 1e-3; argmax
     flips allowed, and counted, only where the top-2 logits lie within
     1e-3), one scene's train-mode loss against the CPU (rel 1e-4), finite
     grads and a loss that falls over 8 fp32 steps, one bf16 train step.
     Every other mode: one eval step and scene 0 against the CPU as for
     disco; one bf16 train step for cat, agent, when2com and v2v. Then the
     seg tools' main(argv): create_data_seg writes 16 frames, train_seg
     trains 2 epochs of 2 batches from them (epoch_0, epoch_1) and resumes
     to epoch 2, test_seg --resume auto evaluates, and test_seg --bf16
     must build a float32 module. The seg path launches none of the port's
     kernels.
 12. Visibility input, MGDA training and tracking at full width, through
     the tools' main(argv): (a) create_data_det --vis 1 --targets 1 bakes
     16 frames (K2 twice a frame, the forced-anchor entry once), frame
     0's int8 vis_maps equal to the CPU's bake in every cell and to the
     maps carved again on the card, its targets as in phase 10; (b)
     train_det --use_vis 1 --MGDA --kd_flag 1 from that cache, 2 epochs of
     its one batch of 16 in fp32 and bf16 (no launches, finite metrics,
     task weights on the simplex); one scene's MGDA step (use_vis, KD,
     random weights and teacher) against the CPU (weights within 1e-4,
     losses rel 1e-4); a live batch with no baked targets or maps (K2
     twice, the visibility fallback on the card, scene 0 equal to the
     CPU's carving, a finite MGDA step, and one bf16 prepare + MGDA step
     with finite loss and grads); (c) an 8-frame generate_sequence
     saved as a cache with gt_ids, test_det --use_vis 1 --save_dets on the
     card and on the CPU with fixed random weights (K1 for NMS and mAP),
     then tools/track.py over both dumps: the same kept set at every frame
     and agent, MOT counts and MOTA equal, IoU means within 1e-4.
 13. The benchmark-table, diagnostic and profiling tools at full width,
     through their main(argv): bench_table's det sweep (lowerbound, disco,
     upperbound, disco+kd; B=4, a pool of 2 batches baked on the card, 4
     cosine steps, eval at 2 and 4, states saved): K2 launches in the
     bake (2 a pool batch) and in each mode's warmup step on live targets
     (2), never in a training step; disco+kd's teacher is the upperbound row
     (teacher_s 0), every row and curve finite; the seg sweep (disco, 2
     steps; no launch); bench_table_track over the saved states (one
     4-frame sequence; K1 for NMS); merge and assemble over those outputs;
     diag_v2v (2 steps at B=2: 3 probes of 3 rounds of finite gate
     stats); diag_upperbound (2 steps, probes at 0 and 2), and its probe
     on the card after a training step leaves every parameter, buffer and
     Adam state bit-identical; xprof_det's kernel profile, device busy
     and idle shares and by-span table of train, prepare (the
     assignment's kernels by name, under det.assign) and predict at B=16.
 14. Data parallelism and row sharding at Config(), through
     v2x_sim_tpu_torch/parallel/: (a) two gloo ranks sharing the card
     (spawned; the kernels built before), each on 8 of 16 scenes: one
     float64 step of disco, disco + KD, disco MGDA + use_vis and seg disco,
     each held to the single-process step on the 16 scenes by the parity
     tests' rules (loss terms rel 1e-5, Adam's first moment 1e-4 of a
     leaf's max, new params 1e-8 where the gradient is clear, running
     stats 1e-8), every rank's parameters, buffers and Adam moments
     bit-identical to rank 0's, K1's forced-anchor entry and K2 launched
     by each rank's prepare_batch; one fp32 DP step of disco at B=16 with
     a finite loss on each rank; (c) in the same ranks, the row-sharded
     5-stage encoder (128 of 256 rows a rank) against the unsharded one
     and the sharded stem's SGD step against the unsharded (float64,
     1e-10 of the max); (b) train_det --dp 1 (NCCL) for a step, a
     checkpoint and a resumed second step, against --dp 0; (d) the whole
     model row-sharded on a (data 2, spatial 2) mesh of 4 gloo ranks
     sharing the card (DetModule/SegModule with process_group and
     spatial_group; 128 of 256 rows a rank, each rank's prepare_batch on
     the whole grid): one float64 step of disco, disco + KD and seg disco
     on 2 of 4 scenes a data rank, each held to the single-process step on
     the 4 by (a)'s rules, every rank bit-identical; one fp32 sharded
     step of disco at B=16 (8 scenes a data rank) with a finite loss on
     each rank; the sharded predict
     against the unsharded on the same scenes: in fp32 (B=16) the gathered
     heads within 1e-3 and the kept sets counted, in float64 the kept sets
     equal and the scores within 1e-9; K2 twice and K1's forced-anchor
     entry once a sharded prepare, K1's matrix in each sharded predict.
 15. The last host modules and bf16, at Config(): (a) one scene's dense
     and flat anchor targets (assign_targets_batched(flat=False/True)) on
     the card against the CPU (K2 twice and the forced-anchor entry once a
     call; labels equal away from the thresholds, targets within 1e-5),
     and the dense smooth-L1 against the sparse one on the same random
     predictions (rel 1e-5); (b) one scene's disco logits in bf16 on the
     card (predict's eval forward, a train-mode forward, seg disco's
     eval and train-mode forwards) against the CPU's fp32, within 1.25 x
     the port's own CPU bf16 distance (max and mean); (c) a 1-scene x
     2-frame nuScenes-format root from the port's writer through
     create_data_det --targets 1 (K2 twice a frame), train_det (1 step),
     test_det (K1 for NMS and mAP) and create_data_seg; (d) the card model
     saved as the reference's {"model_state_dict": ...} .pth and reloaded
     through train/torch_convert.py: bit-equal logits.
 16. The root entry points' counterparts: (a) python bench_torch.py --run
     in a subprocess under its own time limit (the headline bench: bf16
     disco predict at B=16, the train step alone, prepare + step, the
     .npz pipeline, FLOP-counted MFU, the reference graph timed on this
     card): exit code 0, every key of its last line, rates and
     vs_baseline > 0, 0 < mfu_pct and train_mfu_pct <= 100, its K1/K2
     launches (stderr); (b) graft_entry.entry() on the card against
     entry(device="cpu"), the same weights and occupancy: logits and
     regression within 1e-4 (TF32 off); (c) graft_entry.dryrun_multichip(4)
     on 4 gloo ranks sharing the card: all five variants' lines.
 17. The fused train-mode BatchNorm + ReLU of bf16 maps
     (csrc/batchnorm.cu through ops/cuda/bn_cu.py): one bf16 disco
     DetModule train step at B=16 launches each of its four passes 18
     times (its maps' shapes recorded; a finite loss), a bf16 eval forward
     normalize_relu 18 times (on the running stats) and no other pass;
     then at each recorded shape, on random maps, each pass held
     once to its plain version (normalize_relu and backward_dx bit-equal,
     the float32 sums within 1e-5 of their terms) and timed beside its
     byte bound (2, 4, 6 and 8 bytes an element) and its plain
     version, and the Function's forward and backward beside the unfused
     PyTorch layer's (relu(_bn(...)) under autograd), the yardstick;
     totals over the step's 18 layers.
 18. The decoder's fused stage input of bf16 maps (csrc/upsample.cu
     through ops/cuda/upsample_cu.py): a bf16 disco train step at B
     launches each entry 4 times and a bf16 predict the forward 4 times,
     each counted from zero (the counts the kernels line reports); then
     at a B=16 call's four stage inputs (96 maps: C 512 at 16^2, 256 at
     32^2, 128 at 64^2, 64 at 128^2, each with its skip of C/2 channels at
     twice the size), on random maps, each entry held once to its plain
     version (bit-equal; the forward also to upsample + cat, the backward
     run to run) and timed beside its byte bound (9 and 5 bf16 elements
     an element of x) and its plain version,
     and the Function's forward and backward beside the two ops' under
     autograd, the yardstick; totals over the four stages.

Each kernel timing line gives the share of pairs that pass the kernel's
cull, the share of 32-pair groups with any pair that passes, and the
data-dependent bound: the larger of the counted operations that these
operands need (iou_cu.OPS_*, the clip counted at the vertex counts they
produce) and the bytes they need moved. With --baseline, another version
of csrc/rotated_iou.cu is built too and timed against this one in turns
on the main path's operands (lines tagged [A/B]).

The kernels record's launches are the main path's own: phase 3's two
fp32 predicts (the matrix), phase 5's prepare_batch (the assignment's
entries), phases 17's and 18's bf16 steps; a "[time]" line gives the
other phases' rotated-IoU launches.
Each kernel wrapper's launch count is set to 0 before each path (predict,
training, every mode's predict, late fusion, KD training, each tool run
of the workflow, the segmentation phase, each run of phase 12, each
tool run of phase 13, phase 14's ranks from their start, and its --dp 0
run, each sharded run of phase 14 (d), each call and tool run of phase
15) and read after it; phase 16's bench counts its own launches in its
process and prints them on stderr. "[time]"
lines give each phase's seconds.

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
port's package beside this file, it exits non-zero and prints no result.
Parity phases run with TF32 off (cuDNN and matmul), so fp32 is fp32.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside
#: the tensor cores, and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: bench.py's predict shapes: B=16 scenes x 6 agents, 128 NMS candidates.
BATCH = 16
MAX_BOXES = 128
NMS_IOU = 0.1
SCORE_THRESHOLD = 0.3
IOU_TOL = 1e-4  # kernel vs plain (fp32), as met while nvcc contracted the kernel's sums into FMAs
#: Where kernel and plain differ by more than IOU_TOL (late fusion's boxes,
#: far from the origin), the kernel's error against the plain version in
#: float64 may be at most this multiple of the fp32 plain version's.
F64_RATIO = 2.0
SCORE_TOL = 1e-4  # card vs CPU, where valid
LOGIT_TOL = 1e-3  # card vs CPU logits of one scene (fp32, TF32 off)
BOX_TOL = 1e-3  # card vs CPU boxes (m, rad), where valid: exp() of fp32 codes
#: Assignment card vs CPU: labels may differ only at anchors whose IoU lies
#: this close to a threshold (kernel and plain version round differently).
NEAR_THRESHOLD = 1e-4
REG_TOL = 1e-5  # regression targets card vs CPU
LOSS_RTOL = 1e-4  # one scene's loss card vs CPU (fp32, TF32 off)
TRAIN_STEPS = 8  # fp32 steps on one batch over which the loss must fall
#: The collaboration modes beyond the main path's disco, and those of them
#: with trained fusion weights, which also take one bf16 train step.
OTHER_MODES = ("upperbound", "sum", "mean", "max", "cat", "agent", "when2com", "who2com", "v2v")
TRAIN_MODES = ("cat", "agent", "when2com", "v2v")
#: Phase 11's segmentation modes beyond disco.
SEG_OTHER_MODES = ("lowerbound",) + OTHER_MODES
KD_WEIGHT = 1e5  # the JAX training tool's default --kd_weight
CHUNK = 1 << 20  # pairs per chunk of the plain version in the full-size periodic check
#: Phase 10's workflow: frames baked (2 training batches of BATCH), and
#: evaluation batches.
WORKFLOW_SCENES, WORKFLOW_FRAMES = 2, 16
WORKFLOW_EVAL_BATCHES = 2
WORKFLOW_LIVE_BATCHES = 6  # batches of the training run on live targets
PERIOD = 4099  # a prime period for the random periodic check
MGDA_W_TOL = 1e-4  # one scene's MGDA task weights, card vs CPU in float64 (and card fp32)
TRACK_FRAMES = 8  # phase 12's generated sequence
#: Phase 13: the bench tools' grid (bench_table's names) and the profilers'
#: (full or small); a CPU rehearsal sets smaller ones.
TOOLS_GRID, PROFILE_GRID = "full", "full"
#: Phase 13's bench_table det sweep, and its pool of training batches.
TOOLS_MODES = ("lowerbound", "disco", "upperbound", "disco+kd")
TOOLS_POOL = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def random_boxes(rng: np.random.Generator, n: int, spread: float = 6.0) -> np.ndarray:
    """(n, 5) float32 boxes, dense enough that most pairs overlap some."""
    return np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(1.0, 5.0, n),
            rng.uniform(0.8, 3.0, n),
            rng.uniform(-np.pi, np.pi, n),
        ],
        axis=-1,
    ).astype(np.float32)


#: (box a, box b, IoU, atol): identical, half-shifted square, far apart, contained.
SPECIAL_CASES = (
    ((1.0, 2.0, 4.0, 2.0, 0.7), (1.0, 2.0, 4.0, 2.0, 0.7), 1.0, 1e-4),
    ((0.0, 0.0, 2.0, 2.0, 0.0), (1.0, 0.0, 2.0, 2.0, 0.0), 1.0 / 3.0, 1e-4),
    ((0.0, 0.0, 2.0, 2.0, 0.0), (50.0, 50.0, 2.0, 2.0, 1.0), 0.0, 1e-6),
    ((0.0, 0.0, 10.0, 10.0, 0.2), (0.0, 0.0, 2.0, 2.0, 1.0), 0.04, 1e-4),
)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def iou_bound(ops: int, bytes_moved: int):
    """Least time (ms) on the card for `ops` counted operations and
    `bytes_moved` bytes, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, bytes_moved / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


class IouWork:
    """What one launch's pairs need, summed over chunks of its operands:
    the pairs that pass the kernel's cull (its plain copy, iou_sh.culled;
    with cull=False every pair is clipped), the 32-pair groups in launch
    order with any pair that passes, and the counted operations of
    clipping the pairs that pass (iou_cu.clip_ops)."""

    def __init__(self, cull: bool = True):
        self.cull = cull
        self.pairs = self.passed = self.groups = self.groups_passed = self.clip_ops = 0

    def add(self, boxes_a, boxes_b) -> None:
        import torch

        from v2x_sim_tpu_torch.ops import iou_sh
        from v2x_sim_tpu_torch.ops.cuda import iou_cu

        boxes_a, boxes_b = (t.reshape(-1, 5) for t in torch.broadcast_tensors(boxes_a, boxes_b))
        if self.cull:
            keep = ~iou_sh.culled(boxes_a, boxes_b)
        else:
            keep = torch.ones(boxes_a.shape[0], dtype=torch.bool, device=boxes_a.device)
        pad = -keep.numel() % 32
        groups = torch.cat([keep, keep.new_zeros(pad)]).view(-1, 32).any(dim=1)
        self.pairs += keep.numel()
        self.passed += int(keep.sum())
        self.groups += groups.numel()
        self.groups_passed += int(groups.sum())
        self.clip_ops += iou_cu.clip_ops(boxes_a[keep], boxes_b[keep])

    def matrix_bound(self, g: int, n: int, m: int):
        """The matrix entry: corners and radius once a box, the cull's test
        on every pair, the clip on those that pass; bytes: both box arrays
        in, the matrix out."""
        from v2x_sim_tpu_torch.ops.cuda.iou_cu import OPS_CORNERS, OPS_CULL, OPS_RADIUS

        ops = (OPS_CORNERS + OPS_RADIUS) * g * (n + m) + OPS_CULL * self.pairs + self.clip_ops
        return iou_bound(ops, 4 * (5 * g * (n + m) + self.pairs))

    def pairs_bound(self):
        """The aligned-pairs entry: both corners and the clip on every
        pair; bytes: two 5-float boxes in and one float out a pair."""
        from v2x_sim_tpu_torch.ops.cuda.iou_cu import OPS_CORNERS

        return iou_bound(2 * OPS_CORNERS * self.pairs + self.clip_ops, 44 * self.pairs)

    def forced_bound(self, gts: int):
        """The forced-anchor entry on `gts` GT rows and these (GT, anchor)
        pairs: one GT's corners, its own cell and force test a GT; an
        anchor's corners, the clip and the maximum's step a pair; bytes: the
        GT and its mask in, each GT's K anchors gathered, own_iou out a
        pair, own_k, force and the cell out a GT."""
        from v2x_sim_tpu_torch.ops.cuda.iou_cu import OPS_ARGMAX, OPS_CORNERS, OPS_FORCE, OPS_OWN_CELL

        ops = ((OPS_CORNERS + OPS_OWN_CELL + OPS_FORCE) * gts
               + (OPS_CORNERS + OPS_ARGMAX) * self.pairs + self.clip_ops)
        return iou_bound(ops, 21 * gts + 24 * self.pairs + 17 * gts)

    def periodic_bound(self, n: int):
        """The periodic entry: both radii and the cull's test on every pair,
        corners and the clip on those that pass; bytes: the (5, n) table
        once, x, y, l, w in and the IoU out for every pair, and the yaw
        only for the pairs that pass."""
        from v2x_sim_tpu_torch.ops.cuda.iou_cu import OPS_CORNERS, OPS_CULL, OPS_RADIUS

        ops = ((2 * OPS_RADIUS + OPS_CULL) * self.pairs + 2 * OPS_CORNERS * self.passed
               + self.clip_ops)
        return iou_bound(ops, 4 * 5 * n + 20 * self.pairs + 4 * self.passed)

    def __str__(self) -> str:
        if not self.cull:
            return f"no cull in this entry: all {self.pairs} pairs clipped"
        return (f"{self.passed}/{self.pairs} pairs pass the cull ({self.passed / self.pairs:.4f}), "
                f"32-pair groups with one that passes {self.groups_passed / self.groups:.4f}")


def time_against(base, entry: str, operands, sizes, pairs: int, what: str, card: str) -> None:
    """With a baseline build (--baseline), time its C entry point `entry`
    against this build's on the same operands in turns (baseline, current,
    current, baseline; raw calls, not counted as launches) and check that
    the two builds agree within IOU_TOL. Does nothing without one."""
    if base is None:
        return
    import torch

    from v2x_sim_tpu_torch.ops.cuda import build, iou_cu

    libs = {"baseline": base, "current": iou_cu.declare(build.load("rotated_iou"))}
    outs = {key: torch.empty(pairs, device=operands[0].device) for key in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def call(key):
        rc = getattr(libs[key], entry)(*(t.data_ptr() for t in operands), outs[key].data_ptr(),
                                       *sizes, stream)
        if rc != 0:
            raise RuntimeError(f"{key} {entry}: cudaError_t {rc}")

    times = {key: [] for key in libs}
    for key in ("baseline", "current", "current", "baseline"):
        times[key].append(time_ms(lambda: call(key), iters=20))
    err = float((outs["baseline"] - outs["current"]).abs().max())
    if not err <= IOU_TOL:
        raise AssertionError(f"{what}: the two builds differ by {err} > {IOU_TOL}")
    log(f"[A/B] {what} ({pairs} pairs): baseline "
        + " ".join(f"{t:.4f}" for t in times["baseline"]) + " ms, current "
        + " ".join(f"{t:.4f}" for t in times["current"]) + " ms, speedup "
        f"{np.mean(times['baseline']) / np.mean(times['current']):.2f}x, max |diff| {err:.2e} "
        f"[{card}]")


def phase_build() -> None:
    from v2x_sim_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    built = build.build(["rotated_iou", "batchnorm", "upsample"])
    for name, b in built.items():
        report = [ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[1] built {name} -> {os.path.relpath(b.path, ROOT)} in "
            f"{time.perf_counter() - t0:.1f} s")
        for ln in report:
            log(f"[1]   ptxas: {ln}")


def phase_kernel(device, card: str, groups: int, n_random: int, own_pairs: int) -> dict:
    """Each entry point vs the plain version: the matrix at the NMS shape,
    aligned pairs at n_random and at groups * own_pairs (the forced-anchor
    test's GT x anchor-shape pairs), periodic pairs at ~n_random."""
    import torch

    from v2x_sim_tpu_torch.ops import iou_sh
    from v2x_sim_tpu_torch.ops.cuda import iou_cu

    rng = np.random.default_rng(0)
    # Known values through both entry points.
    a = torch.tensor([c[0] for c in SPECIAL_CASES], device=device)
    b = torch.tensor([c[1] for c in SPECIAL_CASES], device=device)
    want = torch.tensor([c[2] for c in SPECIAL_CASES])
    tol = torch.tensor([c[3] for c in SPECIAL_CASES])
    got_pairs = iou_cu.rotated_iou_pairs_soa(a.T.contiguous(), b.T.contiguous()).cpu()
    got_mat = iou_cu.rotated_iou_matrix(a[:, None].contiguous(), b[:, None].contiguous()).cpu()
    for name, got in (("pairs", got_pairs), ("matrix", got_mat.reshape(-1))):
        if not bool(((got - want).abs() <= tol).all()):
            raise AssertionError(f"special cases via {name}: got {got.tolist()}, want {want.tolist()}")
    log(f"[2] special cases ok via both entry points: {got_pairs.tolist()}")

    # (a) aligned pairs at n_random.
    pa = torch.from_numpy(random_boxes(rng, n_random)).to(device)
    pb = torch.from_numpy(random_boxes(rng, n_random)).to(device)
    pa_soa, pb_soa = pa.T.contiguous(), pb.T.contiguous()
    got = iou_cu.rotated_iou_pairs_soa(pa_soa, pb_soa)
    ref = iou_sh.rotated_iou(pa, pb)
    err_pairs = float((got - ref).abs().max())
    if not err_pairs <= IOU_TOL:
        raise AssertionError(f"pairs entry: max |kernel - plain| = {err_pairs} > {IOU_TOL}")
    # (b) batched matrix at the NMS shape.
    ma = torch.from_numpy(random_boxes(rng, groups * MAX_BOXES).reshape(groups, MAX_BOXES, 5)).to(device)
    got = iou_cu.rotated_iou_matrix(ma, ma)
    ref = iou_sh.rotated_iou_matrix(ma, ma)
    err_mat = float((got - ref).abs().max())
    if not err_mat <= IOU_TOL:
        raise AssertionError(f"matrix entry: max |kernel - plain| = {err_mat} > {IOU_TOL}")
    overlap = float((ref > 0).float().mean())
    log(f"[2] kernel vs plain: pairs ({n_random}) max_abs_err={err_pairs:.3e}; "
        f"matrix ({groups}x{MAX_BOXES}x{MAX_BOXES}) max_abs_err={err_mat:.3e}; "
        f"share of pairs that overlap {overlap:.3f}")
    # (c) aligned pairs at the assignment's forced-anchor shape.
    n_own = groups * own_pairs
    oa = torch.from_numpy(random_boxes(rng, n_own)).to(device)
    ob = torch.from_numpy(random_boxes(rng, n_own)).to(device)
    oa_soa, ob_soa = oa.T.contiguous(), ob.T.contiguous()
    err_own = float((iou_cu.rotated_iou_pairs_soa(oa_soa, ob_soa) - iou_sh.rotated_iou(oa, ob)).abs().max())
    if not err_own <= IOU_TOL:
        raise AssertionError(f"pairs entry at {n_own}: max |kernel - plain| = {err_own} > {IOU_TOL}")
    # (d) periodic pairs: known values three times over, then a prime period.
    got = iou_cu.rotated_iou_pairs_soa_periodic(a.T.contiguous(), b.repeat(3, 1).T.contiguous()).cpu()
    if not bool(((got - want.repeat(3)).abs() <= tol.repeat(3)).all()):
        raise AssertionError(f"special cases via the periodic entry: got {got.tolist()}")
    reps = n_random // PERIOD
    qa = torch.from_numpy(random_boxes(rng, PERIOD)).to(device)
    qb = torch.from_numpy(random_boxes(rng, PERIOD * reps)).to(device)
    qa_soa, qb_soa = qa.T.contiguous(), qb.T.contiguous()
    got = iou_cu.rotated_iou_pairs_soa_periodic(qa_soa, qb_soa)
    err_per = float((got - iou_sh.rotated_iou_pairs_soa_periodic(qa_soa, qb_soa)).abs().max())
    if not err_per <= IOU_TOL:
        raise AssertionError(f"periodic entry: max |kernel - plain| = {err_per} > {IOU_TOL}")
    log(f"[2] special cases ok via the periodic entry; pairs at the forced-anchor shape "
        f"({n_own}) max_abs_err={err_own:.3e}; periodic ({PERIOD} x {reps} = {PERIOD * reps} "
        f"pairs) max_abs_err={err_per:.3e}")

    cull_mat, cull_pairs, cull_own = IouWork(), IouWork(cull=False), IouWork(cull=False)
    cull_mat.add(ma[:, :, None], ma[:, None])
    cull_pairs.add(pa, pb)
    cull_own.add(oa, ob)
    out = {
        "err_mat": err_mat,
        "ms": time_ms(lambda: iou_cu.rotated_iou_matrix(ma, ma), iters=50),
        "plain_ms": time_ms(lambda: iou_sh.rotated_iou_matrix(ma, ma), iters=10),
        "pairs_ms": time_ms(lambda: iou_cu.rotated_iou_pairs_soa(pa_soa, pb_soa), iters=50),
        "pairs_plain_ms": time_ms(lambda: iou_sh.rotated_iou(pa, pb), iters=10),
        "err_pairs": max(err_pairs, err_own),
        "own_ms": time_ms(lambda: iou_cu.rotated_iou_pairs_soa(oa_soa, ob_soa), iters=50),
        "own_plain_ms": time_ms(lambda: iou_sh.rotated_iou(oa, ob), iters=10),
        "err_per": err_per,
    }
    bound, by = cull_mat.matrix_bound(groups, MAX_BOXES, MAX_BOXES)
    pairs_bound, pairs_by = cull_pairs.pairs_bound()
    own_bound, own_by = cull_own.pairs_bound()
    log(f"[2] rotated_iou_matrix {groups}x{MAX_BOXES}x{MAX_BOXES} random boxes: kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, bound {bound:.5f} ms ({by}); "
        f"{cull_mat} [{card}]")
    log(f"[2] rotated_iou_pairs {n_random} random boxes: kernel {out['pairs_ms']:.4f} ms, plain "
        f"{out['pairs_plain_ms']:.3f} ms, bound {pairs_bound:.4f} ms ({pairs_by}); {cull_pairs}; "
        f"library_ms null: no single PyTorch call computes rotated-box IoU [{card}]")
    log(f"[2] rotated_iou_pairs {n_own} random boxes (forced-anchor shape): kernel "
        f"{out['own_ms']:.4f} ms, plain {out['own_plain_ms']:.3f} ms, bound {own_bound:.5f} ms "
        f"({own_by}); {cull_own} [{card}]")
    return out


def _finite_predict(module, batch, what: str):
    """``module.predict`` of ``batch`` at the main path's settings; raises
    where its boxes or scores are not finite."""
    import torch

    res = module.predict(batch, MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)
    for name, t in (("boxes", res.boxes), ("scores", res.scores)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: non-finite {name} in the predict output")
    return res


def phase_main_path(device, cfg, spec, batch_size: int, variables, card: str = "",
                    base=None) -> dict:
    """Drive DetModule.predict on the card; check launches, finiteness (in
    fp32, and of one bf16 predict), the NMS IoU matrix against the plain
    version (and time it there, against the baseline build too if there is
    one), and one scene against the CPU."""
    import torch

    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.ops import iou_sh
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.ops.nms import greedy_keep, sort_candidates
    from v2x_sim_tpu_torch.ops.postprocess import decode_topk
    from v2x_sim_tpu_torch.train.det_module import DetModule

    module = DetModule(cfg, "disco", torch.float32, device=device)
    module.load_flax_variables(variables)
    batches = [generate_batch(cfg, spec, batch_size, seed=s) for s in (0, 1)]

    iou_cu.reset_launches()
    results = [_finite_predict(module, bt, "fp32") for bt in batches]
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = iou_cu.rotated_iou_matrix.launches
    if device.type == "cuda" and launches < 1:
        raise AssertionError("the predict path never launched the rotated-IoU kernel")
    half = DetModule(cfg, "disco", torch.bfloat16, device=device)
    half.load_flax_variables(variables)
    _finite_predict(half, batches[0], "bf16")
    del half
    n_valid = [int(r.valid.sum()) for r in results]
    log(f"[3] predict x{len(batches)} at B={batch_size}: rotated_iou_matrix launches={launches}, "
        f"kept boxes per batch {n_valid}, outputs finite; a bf16 predict of batch 0 finite")

    # The NMS candidates of batch 0: kernel IoU vs plain IoU on the card.
    with torch.inference_mode():
        bt = module.to_device(batches[0])
        am = bt["agent_mask"].to(torch.bool)
        out = module.model(module.model_input(bt), bt["trans"], am)
        boxes, scores, valid = decode_topk(
            out.cls_logits, out.reg, module.anchors, MAX_BOXES, SCORE_THRESHOLD, am,
            peak_window=module.peak_window)
        sb, _, sv = sort_candidates(
            boxes.reshape(-1, MAX_BOXES, 5), scores.reshape(-1, MAX_BOXES),
            valid.reshape(-1, MAX_BOXES))
        sb = sb.contiguous()
        iou_k = iou_cu.rotated_iou_matrix(sb, sb)
        iou_p = iou_sh.rotated_iou_matrix(sb, sb)
        err = float((iou_k - iou_p).abs().max())
        keep_k = greedy_keep(iou_k, sv, NMS_IOU)
        keep_p = greedy_keep(iou_p, sv, NMS_IOU)
    if not err <= IOU_TOL:
        raise AssertionError(f"NMS IoU: max |kernel - plain| = {err} > {IOU_TOL}")
    near = ((iou_p - NMS_IOU).abs() <= IOU_TOL).any(dim=(1, 2))
    differ = (keep_k != keep_p).any(dim=1)
    if bool((differ & ~near).any()):
        raise AssertionError("NMS keep masks differ away from the IoU threshold")
    if not torch.equal(keep_k, results[0].valid.reshape(-1, MAX_BOXES)):
        raise AssertionError("predict's keep mask differs from the candidates' recomputation")
    log(f"[3] NMS candidates of batch 0: IoU max_abs_err kernel vs plain {err:.3e}; keep masks "
        f"equal in {int((~differ).sum())}/{differ.numel()} problems (others near the threshold: "
        f"{int(differ.sum())})")
    # K1's matrix entry timed on these candidates, predict's own operands.
    own = {"err": err}
    if device.type == "cuda":
        g = sb.shape[0]
        pairs = g * MAX_BOXES * MAX_BOXES
        cull = IouWork()
        cull.add(sb[:, :, None], sb[:, None])
        own["ms"] = time_ms(lambda: iou_cu.rotated_iou_matrix(sb, sb), iters=50)
        own["plain_ms"] = time_ms(lambda: iou_sh.rotated_iou_matrix(sb, sb), iters=10)
        own["bound_ms"], own["bound_by"] = cull.matrix_bound(g, MAX_BOXES, MAX_BOXES)
        log(f"[3] rotated_iou_matrix {g}x{MAX_BOXES}x{MAX_BOXES} on predict's NMS candidates: "
            f"kernel {own['ms']:.4f} ms, plain {own['plain_ms']:.3f} ms, bound "
            f"{own['bound_ms']:.5f} ms ({own['bound_by']}); {cull} [{card}]")
        time_against(base, "v2x_rotated_iou_matrix", (sb, sb), (g, MAX_BOXES, MAX_BOXES), pairs,
                     "matrix on predict's NMS candidates", card)

    # One scene through the port on the CPU, same weights.
    cpu = DetModule(cfg, "disco", torch.float32, device="cpu")
    cpu.load_flax_variables(variables)
    scene = {k: v[:1] for k, v in batches[0].items()}
    t0 = time.perf_counter()
    ref = cpu.predict(scene, MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)
    cpu_s = time.perf_counter() - t0
    dev_valid = results[0].valid[:1].cpu()
    if not torch.equal(dev_valid, ref.valid):
        raise AssertionError(
            f"valid masks differ card vs CPU: {int((dev_valid != ref.valid).sum())} entries")
    v = ref.valid
    d_scores = float((results[0].scores[:1].cpu()[v] - ref.scores[v]).abs().max()) if v.any() else 0.0
    d_boxes = float((results[0].boxes[:1].cpu()[v] - ref.boxes[v]).abs().max()) if v.any() else 0.0
    if not (d_scores <= SCORE_TOL and d_boxes <= BOX_TOL):
        raise AssertionError(f"card vs CPU where valid: scores {d_scores}, boxes {d_boxes}")
    log(f"[3] card vs CPU, scene 0 ({int(v.sum())} kept): valid equal, max |d score| "
        f"{d_scores:.3e} (tol {SCORE_TOL}), max |d box| {d_boxes:.3e} (tol {BOX_TOL}); "
        f"CPU predict {cpu_s:.1f} s")
    return {"launches": launches, "batches": batches, "nms_matrix": own}


def _positive_cells(cells, wts, k: int):
    """Per agent, the set of cells that hold a positive target."""
    pos = wts.reshape(cells.shape + (k,)).any(-1)
    return [set(c[m].tolist()) for c, m in zip(cells.reshape(-1, cells.shape[-1]),
                                                pos.reshape(-1, cells.shape[-1]))]


def phase_train(device, cfg, spec, batch_size: int, variables) -> dict:
    """Drive prepare_batch and train_step on the card; check the launch
    counts, one scene's assignment and loss against the port on the CPU,
    finiteness, and that the loss falls over TRAIN_STEPS steps."""
    import torch

    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.train.det_module import DetModule

    module = DetModule(cfg, "disco", torch.float32, device=device)
    module.load_flax_variables(variables)
    batch = generate_batch(cfg, spec, batch_size, seed=2)

    iou_cu.reset_launches()
    prepared = module.prepare_batch(batch)
    metrics = module.train_step(prepared)
    torch.cuda.synchronize()
    launches = {key: n for key, n in _launches().items() if key != "matrix"}
    if device.type == "cuda" and launches != {"periodic": 2, "forced": 1, "pairs": 0}:
        raise AssertionError(f"one prepare_batch launched {launches}: want periodic 2, forced 1, "
                             f"pairs 0")
    if not all(bool(torch.isfinite(p.grad).all()) for p in module.model.parameters()):
        raise AssertionError("non-finite gradients")
    k = cfg.anchors.num_anchors
    labels = prepared["labels"]
    log(f"[5] prepare_batch + train_step at B={batch_size}: launches {launches}; positives "
        f"{int((labels == 1).sum())}, ignored {int((labels == -1).sum())}, overflow cells "
        f"{int(prepared['overflow'].sum())}; metrics "
        + ", ".join(f"{n} {float(v):.4f}" for n, v in metrics.items()))

    # Scene 0's assignment through the port on the CPU.
    cpu = DetModule(cfg, "disco", torch.float32, device="cpu")
    cpu.load_flax_variables(variables)
    t0 = time.perf_counter()
    bt = cpu.to_device({key: v[:1] for key, v in batch.items()})
    ref = cpu.targets_from_gt(bt["gt_boxes"], bt["gt_mask"], flat="sparse")
    cpu_s = time.perf_counter() - t0
    lab_d = labels[:1].cpu()
    thr = torch.tensor([cfg.anchors.neg_iou_threshold, cfg.anchors.pos_iou_threshold])
    near = ((ref.iou[..., None] - thr).abs() <= NEAR_THRESHOLD).any(-1)
    differ = lab_d != ref.labels
    if bool((differ & ~near).any()):
        raise AssertionError(f"labels differ card vs CPU away from the thresholds: "
                             f"{int((differ & ~near).sum())} anchors")
    cells_d = prepared["reg_cell"][:1, :, ::k].cpu()
    wts_d, reg_d = prepared["reg_sp_w"][:1].cpu(), prepared["reg_sp_t"][:1].cpu()
    over_d = prepared["overflow"][:1].cpu()
    if not bool(differ.any()):
        if not (torch.equal(cells_d, ref.cells) and torch.equal(over_d, ref.overflow)
                and torch.equal(wts_d, ref.wts)):
            raise AssertionError("cells, weights or overflow differ card vs CPU")
    else:  # a cell may change sides only through an anchor at a threshold
        flips = [set((torch.nonzero(d).flatten() // k).tolist()) for d in differ[0]]
        for got, want, f in zip(_positive_cells(cells_d, wts_d, k),
                                _positive_cells(ref.cells, ref.wts, k), flips):
            if (got ^ want) - f:
                raise AssertionError("positive cells differ card vs CPU away from the thresholds")
    same = ((cells_d == ref.cells)[..., None].expand(cells_d.shape + (k,)).reshape(wts_d.shape)
            & (wts_d == ref.wts))
    err_reg = float((reg_d - ref.reg).abs()[same].max())
    if not err_reg <= REG_TOL:
        raise AssertionError(f"regression targets card vs CPU: max |d| = {err_reg} > {REG_TOL}")
    log(f"[5] assignment card vs CPU, scene 0: labels equal at {int((~differ).sum())}/"
        f"{differ.numel()} anchors (the rest within {NEAR_THRESHOLD} of a threshold; "
        f"{int(near.sum())} anchors are), cells and overflow "
        f"{'equal' if not bool(differ.any()) else 'equal up to those anchors'}, max |d reg| "
        f"{err_reg:.3e}; CPU assignment {cpu_s:.1f} s")

    # Scene 0's loss, forward only, on the card's targets and the card's
    # current weights and stats: card vs CPU.
    cpu.model.load_state_dict({key: v.cpu() for key, v in module.model.state_dict().items()})
    scene = {key: v[:1] for key, v in prepared.items()}
    with torch.no_grad():
        loss_d = float(module.loss(scene, train=True)[0])
        loss_c = float(cpu.loss({key: v.cpu() for key, v in scene.items()}, train=True)[0])
    rel = abs(loss_d - loss_c) / abs(loss_c)
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"scene 0 loss card {loss_d} vs CPU {loss_c}: rel {rel} > {LOSS_RTOL}")
    del cpu

    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(module.train_step(prepared)["loss"]))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    log(f"[5] scene 0 loss card {loss_d:.6f} vs CPU {loss_c:.6f} (rel {rel:.2e}, tol {LOSS_RTOL}); "
        f"loss over {TRAIN_STEPS} fp32 steps on one batch: "
        + " ".join(f"{x:.4f}" for x in losses))
    return {"launches": launches, "batch": batch}


def _check_zeros(got, ref, what: str) -> int:
    """The kernel's exact zeros must be the plain version's, except where
    the plain IoU is below 1e-6; returns how many pairs are such exceptions."""
    differ = (got == 0) != (ref == 0)
    firm = int((differ & (ref >= 1e-6)).sum())
    if firm:
        raise AssertionError(f"{what}: exact zeros differ kernel vs plain at {firm} pairs with IoU >= 1e-6")
    return int(differ.sum())


def phase_assign_kernels(device, cfg, batch, card: str, base=None, tag: str = "[5]") -> dict:
    """The assignment's kernels on a batch's own operands: the periodic
    entry on both nearest-GT candidates (c1, c2) at full size, the
    forced-anchor entry, and the aligned-pairs entry on the forced-anchor
    test's pairs, each against the plain version over every pair (in
    chunks), with its cull counts, and against the baseline build if there
    is one. The forced-anchor entry is also timed in turns against the
    chain of launches it replaced and against an empty launch."""
    import torch

    from v2x_sim_tpu_torch.ops import iou_sh
    from v2x_sim_tpu_torch.ops.anchors import anchor_grid
    from v2x_sim_tpu_torch.ops.assign import (
        forced_anchor_plain,
        gt_soa,
        nearest_gt,
        own_cell,
        own_cell_pairs,
    )
    from v2x_sim_tpu_torch.ops.cuda import build, iou_cu

    anchors = torch.from_numpy(anchor_grid(cfg)).to(device)
    h, w, k, _ = anchors.shape
    n = h * w * k
    m = batch["gt_boxes"].shape[-2]
    gt = torch.from_numpy(batch["gt_boxes"]).to(device).reshape(-1, m, 5)
    mask = torch.from_numpy(batch["gt_mask"]).to(device).reshape(-1, m)
    b = gt.shape[0]
    nb = b * n
    a_soa = anchors.reshape(n, 5).T.contiguous()
    out = {"periodic": []}
    for name, c in zip(("c1", "c2"), nearest_gt(gt, mask, anchors)[:2]):
        b_soa = gt_soa(gt, c[..., None].expand(b, h, w, k).reshape(b, n))
        got = iou_cu.rotated_iou_pairs_soa_periodic(a_soa, b_soa)
        ms = time_ms(lambda: iou_cu.rotated_iou_pairs_soa_periodic(a_soa, b_soa), iters=20)
        ref = torch.empty_like(got)
        cull = IouWork()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(0, nb, CHUNK):
            cols = torch.arange(s, min(nb, s + CHUNK), device=device) % n
            ref[s:s + CHUNK] = iou_sh.rotated_iou(a_soa[:, cols].T, b_soa[:, s:s + CHUNK].T)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        for s in range(0, nb, CHUNK):
            cols = torch.arange(s, min(nb, s + CHUNK), device=device) % n
            cull.add(a_soa[:, cols].T, b_soa[:, s:s + CHUNK].T)
        err = float((got - ref).abs().max())
        if not err <= IOU_TOL:
            raise AssertionError(f"periodic entry on {name}: max |kernel - plain| = {err} > {IOU_TOL}")
        soft = _check_zeros(got, ref, f"periodic entry on {name}")
        bound_ms, bound_by = cull.periodic_bound(n)
        log(f"{tag} rotated_iou_pairs_periodic {b} x {n} = {nb} pairs (candidate {name}): "
            f"max_abs_err={err:.3e} over every pair (plain version in {-(-nb // CHUNK)} chunks of "
            f"{CHUNK}); exact zeros equal but at {soft} pairs with plain IoU < 1e-6; share with IoU > 0 "
            f"{float((ref > 0).float().mean()):.4f}; {cull}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        out["periodic"].append({"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by})
        time_against(base, "v2x_rotated_iou_pairs_periodic", (a_soa, b_soa), (n, nb), nb,
                     f"periodic entry on candidate {name}", card)
        del got, ref, b_soa

    # The forced-anchor entry: every output against the plain version on
    # the card (own_iou bit for bit: both round each product alike), then
    # timed in turns (chain, entry, entry, chain) against the chain of
    # launches it replaced, and an empty launch of its grid.
    grid = cfg.grid
    got = iou_cu.forced_anchor(gt, mask, anchors, grid)
    want = forced_anchor_plain(gt, mask, anchors, grid)
    err = float((got[0] - want[0]).abs().max())
    differ = {name: int((g != v).sum()) for name, g, v in zip(("own_k", "force", "cell"), got[1:], want[1:])}
    if err != 0.0 or any(differ.values()):
        raise AssertionError(f"forced-anchor entry vs plain: own_iou max |d| {err}, entries that "
                             f"differ {differ}")
    gts = b * m

    def chain():
        gr, gc = own_cell(gt, grid)
        own_iou = iou_cu.rotated_iou_pairs_soa(*own_cell_pairs(gt, anchors, gr, gc)).view(b, m, k)
        return own_iou.argmax(dim=-1), mask & (own_iou.amax(dim=-1) > 0.0), gr * w + gc

    if not all(torch.equal(x, y) for x, y in zip(chain(), got[1:])):
        raise AssertionError("forced-anchor entry vs the chain it replaced: own_k, force or cell differ")
    lib = iou_cu.declare(build.load("rotated_iou"))
    blocks = -(-gts * iou_cu.FORCED_GROUP // iou_cu.FORCED_THREADS)
    stream = torch.cuda.current_stream().cuda_stream
    if lib.v2x_empty_launch(blocks, stream) != 0:
        raise RuntimeError("the empty launch failed")
    turns = {"chain": [], "entry": []}
    fns = {"chain": chain, "entry": lambda: iou_cu.forced_anchor(gt, mask, anchors, grid)}
    for key in ("chain", "entry", "entry", "chain"):
        turns[key].append(time_ms(fns[key], iters=50))
    floor_ms = time_ms(lambda: lib.v2x_empty_launch(blocks, stream), iters=50)
    # The C entry alone, on outputs allocated once: the wrapper's launch
    # without its checks and allocations.
    (x0, _), (y0, _) = grid.area_extents[0], grid.area_extents[1]
    raw_outs = [torch.empty_like(t) for t in got]
    raw_args = (gt.data_ptr(), mask.data_ptr(), anchors.data_ptr(), x0, y0, grid.voxel_size[0],
                grid.voxel_size[1], h, w, k, gts, *(t.data_ptr() for t in raw_outs), stream)
    raw_ms = time_ms(lambda: lib.v2x_forced_anchor(*raw_args), iters=50)
    if not all(torch.equal(x, y) for x, y in zip(raw_outs, got)):
        raise AssertionError("the C entry alone wrote other outputs than the wrapper's launch")
    plain_ms = time_ms(lambda: forced_anchor_plain(gt, mask, anchors, grid), iters=10)
    work = IouWork(cull=False)
    work.add(gt[:, :, None, :].expand(b, m, k, 5), anchors[got[3] // w, got[3] % w])
    bound_ms, bound_by = work.forced_bound(gts)
    ms, chain_ms = float(np.mean(turns["entry"])), float(np.mean(turns["chain"]))
    log(f"{tag} forced_anchor {b} x {m} GT x {k} anchors = {work.pairs} pairs ({blocks} blocks of "
        f"{iou_cu.FORCED_THREADS}): own_iou max_abs_err={err:.3e} over every pair, own_k, force and "
        f"cell equal to the plain version's and the old chain's; {int(got[2].sum())} of "
        f"{int(mask.sum())} valid GT force an anchor; kernel "
        + " ".join(f"{t:.4f}" for t in turns["entry"]) + " ms, the chain it replaced (own_cell, "
        "own_cell_pairs, the aligned entry, argmax, amax) " + " ".join(f"{t:.4f}" for t in turns["chain"])
        + f" ms in turns ({chain_ms / ms:.2f}x); the C entry alone {raw_ms:.4f} ms; an empty launch "
        f"of {blocks} blocks {floor_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bound_ms:.5f} ms "
        f"({bound_by}) [{card}]")
    out["forced"] = {"err": err, "ms": ms, "chain_ms": chain_ms, "raw_ms": raw_ms,
                     "floor_ms": floor_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}

    # The aligned-pairs entry on the forced-anchor test's pairs: each GT
    # against its own cell's K anchors, as field-major operands.
    gt_op, own_op = own_cell_pairs(gt, anchors, *own_cell(gt, grid))
    pairs = gt_op.shape[1]
    got = iou_cu.rotated_iou_pairs_soa(gt_op, own_op)
    ref = iou_sh.rotated_iou(gt_op.T, own_op.T)
    err = float((got - ref).abs().max())
    if not err <= IOU_TOL:
        raise AssertionError(f"pairs entry on the forced-anchor test: max |kernel - plain| = {err}")
    cull = IouWork(cull=False)
    cull.add(gt_op.T, own_op.T)
    ms = time_ms(lambda: iou_cu.rotated_iou_pairs_soa(gt_op, own_op), iters=50)
    raw_out = torch.empty_like(got)
    raw_ms = time_ms(lambda: lib.v2x_rotated_iou_pairs(gt_op.data_ptr(), own_op.data_ptr(),
                                                       raw_out.data_ptr(), pairs, stream), iters=50)
    plain_ms = time_ms(lambda: iou_sh.rotated_iou(gt_op.T, own_op.T), iters=10)
    bound_ms, bound_by = cull.pairs_bound()
    log(f"{tag} rotated_iou_pairs {pairs} pairs (the batch's forced-anchor test, padded GT "
        f"included): max_abs_err={err:.3e}; {cull}; kernel {ms:.4f} ms, the C entry alone "
        f"{raw_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    out["pairs"] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}
    time_against(base, "v2x_rotated_iou_pairs", (gt_op, own_op), (pairs,), pairs,
                 "aligned pairs on the forced-anchor test", card)
    return out


def _scene_logits(module, scene) -> "torch.Tensor":
    """One scene's class logits through `module`'s model on its device,
    moved to the CPU."""
    import torch

    with torch.inference_mode():
        bt = module.to_device(scene)
        am = bt["agent_mask"].to(torch.bool)
        return module.model(module.model_input(bt), bt["trans"], am).cls_logits.cpu()


def _same_kept_set(boxes_a, scores_a, boxes_b, scores_b):
    """Whether two agents' kept boxes are the same set (each box within
    BOX_TOL of one on the other side; the order may differ where scores
    tie), and the largest score difference between matched boxes."""
    if boxes_a.shape[0] != boxes_b.shape[0]:
        return False, 0.0
    if boxes_a.shape[0] == 0:
        return True, 0.0
    d = (boxes_a[:, None] - boxes_b[None]).abs().amax(dim=-1)
    match = d.argmin(dim=1)
    ok = bool((d.amin(dim=1) <= BOX_TOL).all()) and bool((d.amin(dim=0) <= BOX_TOL).all())
    return ok, float((scores_a - scores_b[match]).abs().max())


def _check_scene_on_cpu(module, cfg, variables, scene, got, mode: str) -> str:
    """Predict one scene with the port on the CPU (same weights, fp32) and
    hold the card's result `got` (that scene's NMSResult) to it: logits
    within LOGIT_TOL; each agent's kept boxes the same set, scores within
    SCORE_TOL."""
    import torch

    from v2x_sim_tpu_torch.ops.nms import NMSResult
    from v2x_sim_tpu_torch.train.det_module import DetModule

    cpu = DetModule(cfg, mode, torch.float32, device="cpu")
    cpu.load_flax_variables(variables)
    t0 = time.perf_counter()
    ref = cpu.predict(scene, MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)
    cpu_s = time.perf_counter() - t0
    d_logit = float((_scene_logits(cpu, scene) - _scene_logits(module, scene)).abs().max())
    if not d_logit <= LOGIT_TOL:
        raise AssertionError(f"{mode}: logits card vs CPU differ by {d_logit} > {LOGIT_TOL}")
    dev = NMSResult(*(t[0].cpu() for t in got))
    differ, d_scores = [], 0.0
    for a in range(dev.valid.shape[0]):
        kd, kc = dev.valid[a], ref.valid[0, a]
        ok, ds = _same_kept_set(dev.boxes[a][kd], dev.scores[a][kd], ref.boxes[0, a][kc],
                                ref.scores[0, a][kc])
        if not ok:
            differ.append(a)
        d_scores = max(d_scores, ds)
    if differ:
        raise AssertionError(f"{mode}: kept boxes differ card vs CPU at agents {differ} "
                             f"(max |d logit| {d_logit:.2e})")
    if not d_scores <= SCORE_TOL:
        raise AssertionError(f"{mode}: kept scores card vs CPU differ by {d_scores}")
    return (f"scene 0 card vs CPU: max |d logit| {d_logit:.2e}; kept sets equal at "
            f"{dev.valid.shape[0]}/{dev.valid.shape[0]} agents, positions equal at "
            f"{int((dev.valid == ref.valid[0]).all(dim=1).sum())}, {int(ref.valid.sum())} kept "
            f"on the CPU, max |d score| {d_scores:.2e} (CPU {cpu_s:.1f} s)")


def _when2com_margin(module, batch) -> str:
    """The smallest distance of a real source's soft weight from the eval
    threshold 1/n on this batch (a link nearer than rounding could flip
    between the card and the CPU)."""
    import torch

    from v2x_sim_tpu_torch.models.backbone import unfold_agents

    with torch.inference_mode():
        bt = module.to_device(batch)
        am = bt["agent_mask"].to(torch.bool)
        feats = module.model.encode(module.model_input(bt))[module.model.layer]
        f = unfold_agents(feats.permute(0, 2, 3, 1), am.shape[1])
        attn = module.model.fusion.attention(f, am, train=True)
        uniform = 1.0 / am.sum(1).clamp(min=1).float()
        gap = (attn - uniform[:, None, None]).abs()[am[:, None, :].expand_as(attn)]
    return f"min |attention - 1/n| over real links {float(gap.min()):.2e}"


def phase_modes(device, cfg, batch, card: str, seed: int = 10) -> None:
    """Every other collaboration mode at full width: predict on the card
    (the matrix kernel's launches must rise), scene 0 against the port on
    the CPU, a finite bf16 predict, and one bf16 train step for the
    trained fusion modules."""
    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.ops.nms import NMSResult
    from v2x_sim_tpu_torch.train.det_module import DetModule

    scene = {key: v[:1] for key, v in batch.items()}
    for i, mode in enumerate(OTHER_MODES):
        t0 = time.perf_counter()
        variables = random_flax_variables(DetModel(cfg, mode), seed=seed + i)
        module = DetModule(cfg, mode, torch.float32, device=device)
        module.load_flax_variables(variables)
        iou_cu.reset_launches()
        res = _finite_predict(module, batch, mode)
        torch.cuda.synchronize()
        launches = iou_cu.rotated_iou_matrix.launches
        if device.type == "cuda" and launches < 1:
            raise AssertionError(f"{mode}: predict never launched the rotated-IoU matrix kernel")
        first = NMSResult(*(t[:1] for t in res))
        extra = f"; {_when2com_margin(module, scene)}" if mode == "when2com" else ""
        log(f"[7] {mode}: predict at B={BATCH}: rotated_iou_matrix launches={launches}, kept "
            f"{int(res.valid.sum())}; {_check_scene_on_cpu(module, cfg, variables, scene, first, mode)}"
            f"{extra}")
        del module, res, first
        torch.cuda.empty_cache()
        module = DetModule(cfg, mode, torch.bfloat16, device=device)
        module.load_flax_variables(variables)
        res = _finite_predict(module, batch, f"{mode} bf16")
        log(f"[7] {mode} bf16: predict at B={BATCH}: kept {int(res.valid.sum())}, outputs "
            f"finite [{card}]")
        del module, res
        torch.cuda.empty_cache()
        if mode in TRAIN_MODES:
            _bf16_train_step(device, cfg, variables, batch, mode)
        log(f"[7] {mode}: {time.perf_counter() - t0:.1f} s")


def _finite_step(module, batch, what: str) -> float:
    """One prepare_batch + train_step of ``module`` on ``batch``; raises
    unless the loss and the gradients are finite. Returns the loss."""
    import torch

    metrics = module.train_step(module.prepare_batch(batch))
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"{what}: non-finite training loss")
    if not all(bool(torch.isfinite(p.grad).all()) for p in module.model.parameters()):
        raise AssertionError(f"{what}: non-finite gradients")
    return float(metrics["loss"])


def _bf16_train_step(device, cfg, variables, batch, mode: str) -> None:
    """One full-width bf16 prepare + train step: finite loss and grads."""
    import torch

    from v2x_sim_tpu_torch.train.det_module import DetModule

    module = DetModule(cfg, mode, torch.bfloat16, device=device)
    module.load_flax_variables(variables)
    loss = _finite_step(module, batch, f"{mode} bf16")
    log(f"[7] {mode} bf16 train step at B={batch['points'].shape[0]}: loss {loss:.4f}, grads "
        f"finite")
    del module
    torch.cuda.empty_cache()


def phase_late_fusion(device, cfg, variables, batch, card: str) -> dict:
    """Late fusion over disco's predict output with config.max_boxes (512)
    candidates per agent, as the JAX package's test tool runs it: the
    matrix kernel on the merged candidates (G x 512 x 512) against its
    plain version over every pair, timed against its data-dependent
    bound; the keep mask of the card's late_fuse against the recomputed
    candidates' and, for scene 0, against late_fuse on the CPU over the
    same detections."""
    import torch

    from v2x_sim_tpu_torch.ops import iou_sh
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.ops.nms import greedy_keep, sort_candidates
    from v2x_sim_tpu_torch.ops.postprocess import late_fuse, late_fuse_candidates
    from v2x_sim_tpu_torch.train.det_module import DetModule

    k = cfg.max_boxes
    module = DetModule(cfg, "disco", torch.float32, device=device)
    module.load_flax_variables(variables)
    det = module.predict(batch, k, NMS_IOU, SCORE_THRESHOLD)
    bt = module.to_device(batch)
    am = bt["agent_mask"].to(torch.bool)
    args = (det.boxes, torch.where(det.valid, det.scores, 0.0), det.valid, bt["trans"], am)
    iou_cu.reset_launches()
    fused = late_fuse(*args, NMS_IOU, k)
    torch.cuda.synchronize()
    launches = iou_cu.rotated_iou_matrix.launches
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"late_fuse launched the matrix kernel {launches} times, want 1")
    if not (bool(torch.isfinite(fused.boxes).all()) and bool(torch.isfinite(fused.scores).all())):
        raise AssertionError("non-finite late fusion output")

    with torch.inference_mode():
        sb, _, sv = sort_candidates(*(t.reshape((-1,) + t.shape[2:])
                                      for t in late_fuse_candidates(*args, k)))
        sb = sb.contiguous()
        g = sb.shape[0]
        iou_k = iou_cu.rotated_iou_matrix(sb, sb)
        iou_p = torch.empty_like(iou_k)
        step = max(1, CHUNK // (k * k))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(0, g, step):
            iou_p[s:s + step] = iou_sh.rotated_iou_matrix(sb[s:s + step], sb[s:s + step])
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = float((iou_k - iou_p).abs().max())
        # Merged boxes lie far from the ego origin, where both fp32 versions
        # lose digits to cancellation in the clip and the shoelace area:
        # beyond IOU_TOL, hold each against the plain version in float64.
        iou_64 = torch.empty(iou_k.shape, dtype=torch.float64, device=device)
        for s in range(0, g, step):
            b64 = sb[s:s + step].double()
            iou_64[s:s + step] = iou_sh.rotated_iou_matrix(b64, b64)
        err_k64 = float((iou_k - iou_64).abs().max())
        err_p64 = float((iou_p - iou_64).abs().max())
        if not (err <= IOU_TOL or err_k64 <= F64_RATIO * err_p64):
            raise AssertionError(
                f"late fusion matrix: max |kernel - plain| = {err} > {IOU_TOL}, and against float64 "
                f"the kernel errs by {err_k64}, the fp32 plain version by {err_p64}")
        reach = float(sb[..., :2].abs().max())
        keep_k, keep_p = greedy_keep(iou_k, sv, NMS_IOU), greedy_keep(iou_p, sv, NMS_IOU)
        near = ((iou_p - NMS_IOU).abs() <= max(IOU_TOL, err)).any(dim=(1, 2))
        differ = (keep_k != keep_p).any(dim=1)
        if bool((differ & ~near).any()):
            raise AssertionError("late fusion keep masks differ kernel vs plain away from the threshold")
        if not torch.equal(keep_k, fused.valid.reshape(g, k)):
            raise AssertionError("late_fuse's keep mask differs from its candidates' recomputation")
        cull = IouWork()
        for s in range(0, g, step):
            cull.add(sb[s:s + step, :, None], sb[s:s + step, None])
        ms = time_ms(lambda: iou_cu.rotated_iou_matrix(sb, sb), iters=20)
        bound_ms, bound_by = cull.matrix_bound(g, k, k)
    log(f"[8] late_fuse over disco's predict at B={BATCH}, {k} candidates per agent: "
        f"rotated_iou_matrix launches={launches}; merged candidates valid {int(sv.sum())}, kept "
        f"{int(fused.valid.sum())}; matrix {g}x{k}x{k} max_abs_err={err:.3e} over every pair "
        f"(against the plain version in float64: kernel {err_k64:.3e}, fp32 plain {err_p64:.3e}; "
        f"box centers reach {reach:.0f} m from the ego); "
        f"keep masks kernel vs plain equal in {int((~differ).sum())}/{g} problems (others within "
        f"max(IOU_TOL, that error) of the threshold: {int(differ.sum())})")
    log(f"[8] rotated_iou_matrix {g}x{k}x{k} on late fusion's merged candidates: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms ({-(-g // step)} chunks), bound {bound_ms:.5f} ms ({bound_by}), "
        f"share {bound_ms / ms:.1%}; {cull} [{card}]")

    # Scene 0: late_fuse on the CPU over the card's own detections.
    a = am.shape[1]
    ref = late_fuse(*(t[:1].cpu() for t in args), NMS_IOU, k)
    got = fused.valid[:1].cpu()
    if not torch.equal(got, ref.valid):
        near0 = near[:a].cpu()
        rows = (got != ref.valid).any(dim=-1).reshape(-1)
        if bool((rows & ~near0).any()):
            raise AssertionError("late fusion scene 0: keep masks differ card vs CPU away from the threshold")
    v = ref.valid & got
    d_boxes = float((fused.boxes[:1].cpu()[v] - ref.boxes[v]).abs().max()) if v.any() else 0.0
    if not d_boxes <= BOX_TOL:
        raise AssertionError(f"late fusion scene 0: boxes card vs CPU differ by {d_boxes}")
    log(f"[8] late fusion scene 0 card vs CPU on the same detections: keep masks "
        f"{'equal' if torch.equal(got, ref.valid) else 'equal up to problems near the threshold'} "
        f"({int(ref.valid.sum())} kept), max |d box| {d_boxes:.2e}")
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kd(device, cfg, variables, batch, card: str, seed: int = 30) -> None:
    """DiscoNet's KD training at full width: a disco student with
    kd_weight KD_WEIGHT and a random upperbound teacher. Launch counts of
    one prepare_batch, finite grads, scene 0's loss (kd included) against
    the port on the CPU, the loss falling over TRAIN_STEPS fp32 steps."""
    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.train.det_module import DetModule

    teacher = random_flax_variables(DetModel(cfg, "upperbound"), seed=seed)

    def make(dtype, dev):
        m = DetModule(cfg, "disco", dtype, device=dev, kd_weight=KD_WEIGHT)
        m.load_flax_variables(variables)
        m.load_teacher_flax_variables(teacher)
        return m

    module = make(torch.float32, device)
    iou_cu.reset_launches()
    prepared = module.prepare_batch(batch)
    metrics = module.train_step(prepared)
    torch.cuda.synchronize()
    launches = {key: n for key, n in _launches().items() if key != "matrix"}
    if device.type == "cuda" and launches != {"periodic": 2, "forced": 1, "pairs": 0}:
        raise AssertionError(f"KD prepare_batch launched {launches}: want periodic 2, forced 1, "
                             f"pairs 0")
    if not all(bool(torch.isfinite(p.grad).all()) for p in module.model.parameters()):
        raise AssertionError("KD: non-finite gradients")
    if "kd_loss" not in metrics:
        raise AssertionError("KD: no kd_loss in the metrics")
    log(f"[9] KD prepare_batch + train_step at B={BATCH} (kd_weight {KD_WEIGHT:g}, kd_reduce "
        f"mean): launches {launches}; metrics "
        + ", ".join(f"{n} {float(v):.6g}" for n, v in metrics.items()))

    cpu = make(torch.float32, "cpu")
    cpu.model.load_state_dict({key: v.cpu() for key, v in module.model.state_dict().items()})
    scene = {key: v[:1] for key, v in prepared.items()}
    with torch.no_grad():
        loss_d, met_d = module.loss(scene, train=True)
        loss_c, met_c = cpu.loss({key: v.cpu() for key, v in scene.items()}, train=True)
    rel = {key: abs(float(met_d[key]) - float(met_c[key])) / abs(float(met_c[key])) for key in met_c}
    if not max(rel.values()) <= LOSS_RTOL:
        raise AssertionError(f"KD scene 0 loss card vs CPU: rel {rel} > {LOSS_RTOL}")
    del cpu
    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(module.train_step(prepared)["loss"]))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"KD: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    log(f"[9] KD scene 0 card vs CPU: loss {float(loss_d):.6f} vs {float(loss_c):.6f}, kd_loss "
        f"{float(met_d['kd_loss']):.6g} vs {float(met_c['kd_loss']):.6g} (max rel {max(rel.values()):.2e}, "
        f"tol {LOSS_RTOL}); loss over {TRAIN_STEPS} fp32 steps on one batch: "
        + " ".join(f"{x:.2f}" for x in losses) + f" [{card}]")
    del module, prepared
    torch.cuda.empty_cache()
    loss = _finite_step(make(torch.bfloat16, device), batch, "KD bf16")
    log(f"[9] KD bf16 prepare + train step at B={BATCH}: loss {loss:.4f}, grads finite")
    torch.cuda.empty_cache()


def _run_tool(tool, argv, tag: str = "[10]"):
    """`tool.main(argv)` in this process, its printout logged under `tag`
    (indented, so that no line of it reads as this script's result)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = tool.main(argv)
    secs = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"{tag}   | {line}")
    return result, secs


def _load_npz(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _launches() -> dict:
    """Each entry point's launch count: "forced" is the forced-anchor entry,
    "pairs" the aligned-pairs entry, which the main path no longer calls."""
    from v2x_sim_tpu_torch.ops.cuda import iou_cu

    return {"matrix": iou_cu.rotated_iou_matrix.launches,
            "pairs": iou_cu.rotated_iou_pairs_soa.launches,
            "periodic": iou_cu.rotated_iou_pairs_soa_periodic.launches,
            "forced": iou_cu.forced_anchor.launches}


def _check_baked_frame(card_path: str, cpu_path: str) -> str:
    """Frame 0's targets baked on the card against the same frame baked on
    the CPU: index lists, cells and weights equal, regression targets
    within REG_TOL."""
    with np.load(card_path) as card, np.load(cpu_path) as cpu:
        for key in ("tgt_pos_idx", "tgt_ign_idx", "tgt_cells", "tgt_wts", "tgt_meta"):
            if not np.array_equal(card[key], cpu[key]):
                raise AssertionError(f"baked frame 0: {key} differs card vs CPU")
        err_reg = float(np.abs(card["tgt_reg"] - cpu["tgt_reg"]).max())
        if not err_reg <= REG_TOL:
            raise AssertionError(f"baked frame 0: regression targets card vs CPU differ by {err_reg}")
        n = int(cpu["tgt_meta"][0] * cpu["tgt_meta"][1] * cpu["tgt_meta"][2])
        pos = int((cpu["tgt_pos_idx"] < n).sum())
        ign = int((cpu["tgt_ign_idx"] < n).sum())
        return (f"frame 0 card vs CPU: {pos} positive and {ign} ignored anchors listed, index lists, "
                f"cells and weights equal, max |d reg| {err_reg:.2e} (tol {REG_TOL})")


def phase_workflow(device, cfg, card: str) -> dict:
    """The detection workflow at full width through the tools' main(argv),
    in a temporary directory: bake a cache with targets, train from it with
    checkpoints, resume, train once more on live targets, evaluate with and
    without late fusion; the kernels at the operands this workflow gives
    them (a frame's assignment, mAP's detections x GT)."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.ops import iou_sh
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import common, create_data_det, test_det, train_det
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.utils.mean_ap import eval_map_agents

    out = {"launches": {"matrix": 0, "pairs": 0, "periodic": 0, "forced": 0}}

    def add_launches(counts):
        for key, v in counts.items():
            out["launches"][key] += v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cache, run = os.path.join(tmp, "cache"), os.path.join(tmp, "run")
        # (a) Bake: 2 scenes x 16 frames with targets, on the card.
        iou_cu.reset_launches()
        frames, _ = _run_tool(create_data_det, [
            "--root", "synthetic", "--savepath", cache, "--scenes", str(WORKFLOW_SCENES),
            "--frames", str(WORKFLOW_FRAMES), "--targets", "1"])
        torch.cuda.synchronize()
        bake = _launches()
        add_launches(bake)
        if bake["periodic"] != 2 * frames or bake["forced"] != frames or bake["pairs"]:
            raise AssertionError(f"baking {frames} frames launched {bake}: want periodic "
                                 f"{2 * frames}, forced {frames}, pairs 0")
        _, cpu_s = _run_tool(create_data_det, [
            "--root", "synthetic", "--savepath", os.path.join(tmp, "cpu"), "--scenes", "1",
            "--frames", "1", "--targets", "1", "--cpu"])
        name = "scene0000_frame000.npz"
        same = _check_baked_frame(os.path.join(cache, "train", name), os.path.join(tmp, "cpu", "train", name))
        log(f"[10] create_data_det --targets 1: {frames} frames, launches {bake} (periodic "
            f"{bake['periodic'] // frames} a frame); {same}; the CPU baked it in {cpu_s:.1f} s")
        with np.load(os.path.join(cache, "train", name)) as f:
            frame = {"gt_boxes": f["gt_boxes"][None], "gt_mask": f["gt_mask"][None]}
        out["bake"] = phase_assign_kernels(device, cfg, frame, card, tag="[10]")

        # (b) Train from the baked targets, with checkpoints; then resume.
        train_args = ["--data", os.path.join(cache, "train"), "--com", "disco", "--batch",
                      str(BATCH), "--batches_per_epoch", "2", "--logpath", run]
        iou_cu.reset_launches()
        first, _ = _run_tool(train_det, train_args + ["--nepoch", "2"])
        torch.cuda.synchronize()
        trained = _launches()
        add_launches(trained)
        if trained["periodic"] or trained["pairs"] or trained["forced"]:
            raise AssertionError(f"training from baked targets launched the assignment: {trained}")
        for epoch in (0, 1):
            if not os.path.exists(os.path.join(run, f"epoch_{epoch}")):
                raise AssertionError(f"train_det wrote no epoch_{epoch} checkpoint")
        if not (first.step == 4 and np.isfinite(list(first.metrics.values())).all()):
            raise AssertionError(f"train_det: step {first.step}, metrics {first.metrics}")
        iou_cu.reset_launches()
        resumed, _ = _run_tool(train_det, train_args + ["--nepoch", "3", "--resume", "auto"])
        torch.cuda.synchronize()
        add_launches(_launches())
        if (resumed.start_epoch, resumed.start_step, resumed.step) != (2, 4, 6):
            raise AssertionError(f"resume started at epoch {resumed.start_epoch}, step "
                                 f"{resumed.start_step}, ended at {resumed.step}: want 2, 4, 6")
        log(f"[10] train_det from the cache at B={BATCH}: launches {trained} (targets baked), "
            f"epoch_0 and epoch_1 written, loss {first.metrics['loss']:.4f}; resume --auto started "
            f"at epoch {resumed.start_epoch}, step {resumed.start_step} [{card}]")

        # (b') Train on live targets: the assignment runs in the prefetch
        # thread, on its stream, overlapping the steps; metrics read every
        # step. Step 1's loss against the same batch prepared and stepped
        # on this thread's stream.
        live_run = os.path.join(tmp, "live")
        live_args = ["--com", "disco", "--batch", str(BATCH), "--batches_per_epoch",
                     str(WORKFLOW_LIVE_BATCHES), "--nepoch", "1", "--log_every", "1",
                     "--logpath", live_run]
        iou_cu.reset_launches()
        _run_tool(train_det, live_args)
        torch.cuda.synchronize()
        live_launches = _launches()
        add_launches(live_launches)
        if (live_launches["periodic"] != 2 * WORKFLOW_LIVE_BATCHES
                or live_launches["forced"] != WORKFLOW_LIVE_BATCHES or live_launches["pairs"]):
            raise AssertionError(f"{WORKFLOW_LIVE_BATCHES} live batches launched {live_launches}: "
                                 f"want periodic {2 * WORKFLOW_LIVE_BATCHES}, forced "
                                 f"{WORKFLOW_LIVE_BATCHES}, pairs 0")
        with open(os.path.join(live_run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        step1 = records[0]
        ref = DetModule(cfg, "disco", torch.float32, device=device)
        ref.init_weights(0)
        raw = next(common.make_batches(train_det.parse_args(live_args), cfg, num_batches=1))
        loss = float(ref.train_step(ref.prepare_batch(raw))["loss"])
        rel = abs(step1["loss"] - loss) / abs(loss)
        if not (step1["step"] == 1 and rel <= LOSS_RTOL):
            raise AssertionError(f"live train_det step 1 loss {step1['loss']} vs {loss} on this "
                                 f"thread's stream: rel {rel} > {LOSS_RTOL}")
        log(f"[10] train_det on live targets, {WORKFLOW_LIVE_BATCHES} batches: launches "
            f"{live_launches} in the prefetch thread; step 1 loss {step1['loss']:.6f} vs {loss:.6f} "
            f"prepared and stepped on the main stream (rel {rel:.2e}, tol {LOSS_RTOL}) [{card}]")
        del ref, raw
        torch.cuda.empty_cache()

        # (c) Evaluate the newest checkpoint, then with late fusion.
        for late in (False, True):
            dets = os.path.join(tmp, "dets_late" if late else "dets")
            argv = ["--com", "disco", "--resume", "auto", "--logpath", run, "--batch", str(BATCH),
                    "--num_batches", str(WORKFLOW_EVAL_BATCHES), "--save_dets", dets]
            iou_cu.reset_launches()
            ev, _ = _run_tool(test_det, argv + (["--late_fusion"] if late else []))
            torch.cuda.synchronize()
            got = _launches()
            add_launches(got)
            saved = [_load_npz(os.path.join(dets, f"dets_{i:05d}.npz"))
                     for i in range(WORKFLOW_EVAL_BATCHES)]
            cat = {k: np.concatenate([s[k] for s in saved]) for k in saved[0]}
            if not late:
                plain_dets = cat
            agents = int(cat["agent_mask"].any(axis=0).sum())
            want = WORKFLOW_EVAL_BATCHES * (2 if late else 1) + 2 * agents
            if got["matrix"] != want or got["periodic"] or got["pairs"] or got["forced"]:
                raise AssertionError(f"test_det{' --late_fusion' if late else ''} launched {got}: "
                                     f"want matrix {want} (NMS, late fusion, 2 thresholds x "
                                     f"{agents} agents)")
            ref_map = eval_map_agents(cat["boxes"], cat["scores"], cat["valid"], cat["gt_boxes"],
                                      cat["gt_mask"], cat["agent_mask"], device="cpu")
            d_map = max(abs(ev.metrics[k] - ref_map[k]) for k in ref_map)
            if ev.metrics.keys() != ref_map.keys() or not d_map <= 1e-6:
                raise AssertionError(f"test_det's mAP on the card differs from the CPU's over the "
                                     f"same detections by {d_map}")
            label = "late fusion" if late else "plain"
            log(f"[10] test_det ({label}) at B={BATCH} x {WORKFLOW_EVAL_BATCHES}: launches {got}; "
                f"mAP@0.5 {ev.metrics['mAP@0.5']:.4f}, mAP@0.7 {ev.metrics['mAP@0.7']:.4f}, "
                f"{int(cat['valid'].sum())} detections kept; card vs CPU over the same detections: "
                f"max |d mAP| {d_map:.1e} over {len(ref_map)} keys [{card}]")

        # The evaluator where detections do match: the evaluation's real
        # GT boxes jittered, plus as many random boxes; card against CPU.
        rng = np.random.default_rng(0)
        gt_boxes = plain_dets["gt_boxes"]
        noise = np.concatenate([rng.normal(0, 0.3, gt_boxes.shape[:-1] + (2,)),
                                rng.normal(0, 0.05, gt_boxes.shape[:-1] + (3,))], axis=-1)
        spread = rng.uniform(-1, 1, gt_boxes.shape) * np.array([32, 32, 0, 0, np.pi])
        extra = spread + np.array([0, 0, 4.5, 1.9, 0])
        jittered = np.concatenate([gt_boxes + noise, extra], axis=2).astype(np.float32)
        scores = rng.random(jittered.shape[:-1]).astype(np.float32)
        real = np.concatenate([plain_dets["gt_mask"], np.ones_like(plain_dets["gt_mask"])], axis=2)
        valid = (rng.random(jittered.shape[:-1]) < 0.9) & real
        args = (jittered, scores, valid, gt_boxes, plain_dets["gt_mask"], plain_dets["agent_mask"])
        iou_cu.reset_launches()
        on_card = eval_map_agents(*args, device=device)
        torch.cuda.synchronize()
        add_launches(_launches())
        on_cpu = eval_map_agents(*args, device="cpu")
        d_map = max(abs(on_card[k] - on_cpu[k]) for k in on_cpu)
        if not (d_map <= 1e-6 and on_cpu["mAP@0.5"] > 0.1):
            raise AssertionError(f"eval_map_agents on jittered GT: card {on_card} vs CPU {on_cpu}")
        log(f"[10] eval_map_agents on the evaluation's GT jittered ({jittered.shape[2]} detections a "
            f"frame and agent): card mAP@0.5 {on_card['mAP@0.5']:.6f}, mAP@0.7 "
            f"{on_card['mAP@0.7']:.6f}; card vs CPU max |d mAP| {d_map:.1e}")

        # K1's matrix entry at mAP's operands: agent 0's detections x GT.
        # The evaluator reads the pairs of valid detections and real GT. A
        # padded GT box has zero size: the clip keeps the detection whole,
        # and the IoU is its area over the rounding residual of the union,
        # in the JAX package too (ROADMAP.md's F2). The kernel rounds every
        # product and sum as the plain version does, so every pair is held,
        # padded GT included.
        keep = plain_dets["agent_mask"][:, 0]
        take = lambda a: torch.from_numpy(np.ascontiguousarray(a[keep, 0])).to(device)
        det, gt = take(plain_dets["boxes"]), take(plain_dets["gt_boxes"])
        read = take(plain_dets["valid"])[:, :, None] & take(plain_dets["gt_mask"])[:, None, :]
        g, n, m = det.shape[0], det.shape[1], gt.shape[1]
        got = iou_cu.rotated_iou_matrix(det, gt)
        plain = iou_sh.rotated_iou_matrix(det, gt)
        err = float((got - plain).abs().max())
        apart = (got - plain).abs() > IOU_TOL
        if apart.any():
            i, j, k = (int(x) for x in torch.nonzero(apart)[0])
            raise AssertionError(
                f"mAP matrix: {int(apart.sum())} pairs ({int((apart & read).sum())} that mAP "
                f"reads) beyond {IOU_TOL}, e.g. detection {det[i, j].tolist()} x GT "
                f"{gt[i, k].tolist()}: kernel {float(got[i, j, k]):.6g}, plain "
                f"{float(plain[i, j, k]):.6g}")
        soft = _check_zeros(got[read], plain[read], "mAP matrix")
        padded = int((~take(plain_dets["gt_mask"])).sum()) * n
        work = IouWork()
        work.add(det[:, :, None], gt[:, None])
        ms = time_ms(lambda: iou_cu.rotated_iou_matrix(det, gt), iters=50)
        plain_ms = time_ms(lambda: iou_sh.rotated_iou_matrix(det, gt), iters=10)
        bound_ms, bound_by = work.matrix_bound(g, n, m)
        log(f"[10] rotated_iou_matrix {g}x{n}x{m} on mAP's operands (agent 0's detections x "
            f"GT): max_abs_err={err:.3e} over all {got.numel()} pairs, the {padded} with a padded "
            f"GT box included (F2: 0 beyond {IOU_TOL}); exact zeros equal at the "
            f"{int(read.sum())} pairs that mAP reads but at {soft} with plain IoU < 1e-6; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}), share "
            f"{bound_ms / ms:.1%}; {work} [{card}]")
        out["map_matrix"] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "shape": (g, n, m)}
    torch.cuda.empty_cache()
    return out


def _seg_inputs(module, batch):
    """(occupancy, trans, agent_mask) of a host batch on the module's device."""
    import torch

    bt = module.to_device(batch)
    return module.model_input(bt), bt["trans"], bt["agent_mask"].to(torch.bool)


def _seg_scene_vs_cpu(module, cfg, variables, scene, mode: str) -> str:
    """Scene 0's eval logits on the card against the port on the CPU (same
    weights, fp32): within LOGIT_TOL, and the argmax class equal but at
    pixels whose CPU top-2 logits lie within LOGIT_TOL (counted)."""
    import torch

    from v2x_sim_tpu_torch.train.seg_module import SegModule

    cpu = SegModule(cfg, mode, torch.float32, device="cpu")
    cpu.load_flax_variables(variables)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu.model(*_seg_inputs(cpu, scene)).logits
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        got = module.model(*_seg_inputs(module, scene)).logits.cpu()
    d_logit = float((got - ref).abs().max())
    if not d_logit <= LOGIT_TOL:
        raise AssertionError(f"seg {mode}: logits card vs CPU differ by {d_logit} > {LOGIT_TOL}")
    top2 = ref.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= LOGIT_TOL
    flips = got.argmax(-1) != ref.argmax(-1)
    if bool((flips & ~near).any()):
        raise AssertionError(f"seg {mode}: {int((flips & ~near).sum())} argmax classes differ card "
                             f"vs CPU away from a top-2 tie")
    return (f"scene 0 card vs CPU: max |d logit| {d_logit:.2e} (tol {LOGIT_TOL}); argmax flips "
            f"{int(flips.sum())} of {flips.numel()} pixels, each at a top-2 gap <= {LOGIT_TOL} "
            f"({int(near.sum())} pixels have one) (CPU {cpu_s:.1f} s)")


def _seg_eval_check(module, prepared, mode: str) -> str:
    """One eval step: finite logits, and a confusion matrix that sums to
    the real agents' labeled pixels and equals the one counted on the CPU
    from the card's own predictions."""
    import torch

    from v2x_sim_tpu_torch.utils.seg_metrics import confusion_matrix

    pred, cm = module.eval_step(prepared)
    with torch.inference_mode():
        logits = module.model(prepared["occupancy"], prepared["trans"],
                              prepared["agent_mask"].to(torch.bool)).logits
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"seg {mode}: non-finite eval logits")
    labels = module.masked_labels(prepared).cpu()
    valid = int((labels >= 0).sum())
    c = cm.shape[0]
    if int(cm.sum()) != valid or not torch.equal(cm.cpu(), confusion_matrix(pred.cpu(), labels, c)):
        raise AssertionError(f"seg {mode}: the confusion matrix sums to {int(cm.sum())} over "
                             f"{valid} labeled pixels, or differs from the CPU's count of the "
                             f"card's predictions")
    return (f"eval step: logits finite; the {c}x{c} confusion matrix sums to the {valid} labeled "
            f"pixels and equals the CPU's count of the card's predictions")


def _seg_bf16_step(device, cfg, mode: str, variables, batch) -> str:
    """One bf16 prepare + train step of seg ``mode``: finite loss and grads."""
    import torch

    from v2x_sim_tpu_torch.train.seg_module import SegModule

    module = SegModule(cfg, mode, torch.bfloat16, device=device)
    module.load_flax_variables(variables)
    loss = float(module.train_step(module.prepare_batch(batch))["loss"])
    if not (np.isfinite(loss)
            and all(bool(torch.isfinite(p.grad).all()) for p in module.model.parameters())):
        raise AssertionError(f"seg {mode}: non-finite bf16 loss or gradients")
    del module
    torch.cuda.empty_cache()
    return f"bf16 train step: loss {loss:.4f}, grads finite"


def _seg_workflow(cfg, card: str) -> None:
    """The segmentation tools at full width through their main(argv), in a
    temporary directory: bake 16 frames, train 2 epochs of 2 batches from
    them with checkpoints, resume to epoch 2, evaluate the newest checkpoint
    (and with --bf16, which must build a float32 module)."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.tools import create_data_seg, test_seg, train_seg

    batch = WORKFLOW_FRAMES // 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_") as tmp:
        cache, run = os.path.join(tmp, "cache"), os.path.join(tmp, "run")
        frames, _ = _run_tool(create_data_seg, [
            "--root", "synthetic", "--savepath", cache, "--scenes", "1", "--frames",
            str(WORKFLOW_FRAMES)], tag="[11]")
        train_args = ["--data", os.path.join(cache, "train"), "--com", "disco", "--batch",
                      str(batch), "--batches_per_epoch", "2", "--logpath", run]
        first, _ = _run_tool(train_seg, train_args + ["--nepoch", "2"], tag="[11]")
        for epoch in (0, 1):
            if not os.path.exists(os.path.join(run, f"epoch_{epoch}")):
                raise AssertionError(f"train_seg wrote no epoch_{epoch} checkpoint")
        if not (first.step == 4 and np.isfinite(first.metrics["loss"])):
            raise AssertionError(f"train_seg: step {first.step}, metrics {first.metrics}")
        resumed, _ = _run_tool(train_seg, train_args + ["--nepoch", "3", "--resume", "auto"],
                               tag="[11]")
        if (resumed.start_epoch, resumed.start_step, resumed.step) != (2, 4, 6):
            raise AssertionError(f"train_seg resumed at epoch {resumed.start_epoch}, step "
                                 f"{resumed.start_step}, ended at {resumed.step}: want 2, 4, 6")
        eval_args = ["--com", "disco", "--resume", "auto", "--logpath", run, "--batch", str(BATCH),
                     "--num_batches", str(WORKFLOW_EVAL_BATCHES)]
        metrics, _ = _run_tool(test_seg, eval_args, tag="[11]")
        built = []
        module_cls = test_seg.SegModule

        class Recorded(module_cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self.compute_dtype)

        test_seg.SegModule = Recorded
        try:
            _run_tool(test_seg, eval_args + ["--bf16"], tag="[11]")
        finally:
            test_seg.SegModule = module_cls
        if built != [torch.float32]:
            raise AssertionError(f"test_seg --bf16 built modules of {built}: want one float32")
        if not 0.0 <= metrics["miou"] <= 1.0:
            raise AssertionError(f"test_seg: mIoU {metrics['miou']}")
    log(f"[11] seg workflow: create_data_seg {frames} frames; train_seg from the cache at "
        f"B={batch}, epoch_0 and epoch_1 written, loss {first.metrics['loss']:.4f}; resume --auto "
        f"started at epoch {resumed.start_epoch}, step {resumed.start_step}; test_seg --resume "
        f"auto at B={BATCH} x {WORKFLOW_EVAL_BATCHES}: mIoU {metrics['miou']:.4f}, vehicle IoU "
        f"{metrics['vehicle']:.4f}; test_seg --bf16 built a {built[0]} module [{card}]")


def phase_seg(device, cfg, spec, batch_size: int, card: str, seed: int = 40) -> None:
    """BEV segmentation at full width: SegModel at depth 4 (widths 32..256,
    a 512-channel bottleneck at H/16) in every collaboration mode, on
    B synthetic scenes with random weights through the bridge. Disco: scene
    0's eval logits and one scene's train loss against the CPU, the eval
    step's confusion matrix, finite grads and a falling loss, and one bf16
    train step. The other modes: one eval step each, scene 0 against the
    CPU, and one bf16 train step for the trained fusions. Then the seg
    tools' workflow. The seg path launches none of the port's kernels:
    their counts are read after the phase."""
    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.models.seg.unet import SegModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    iou_cu.reset_launches()
    batch = generate_batch(cfg, spec, batch_size, seed=seed)
    scene = {key: v[:1] for key, v in batch.items()}
    variables = random_flax_variables(SegModel(cfg, "disco"), seed=seed)
    module = SegModule(cfg, "disco", torch.float32, device=device)
    module.load_flax_variables(variables)
    prepared = module.prepare_batch(batch)
    labels = prepared["seg_labels"]
    log(f"[11] seg disco at B={batch_size}, {cfg.grid.grid_shape} grid, bottleneck "
        f"{module.model.bottleneck.conv2.out_channels} channels at "
        f"{cfg.grid.bev_shape[0] // 2 ** module.model.depth}^2: "
        f"{_seg_eval_check(module, prepared, 'disco')}; "
        f"{_seg_scene_vs_cpu(module, cfg, variables, scene, 'disco')}; label pixels "
        + ", ".join(f"{int((labels == c).sum())} class {c}" for c in range(cfg.num_seg_classes)
                    if bool((labels == c).any())) + f" [{card}]")

    # One scene's train-mode loss on the card's weights: card vs CPU.
    cpu = SegModule(cfg, "disco", torch.float32, device="cpu")
    cpu.load_flax_variables(variables)
    with torch.no_grad():
        loss_d = float(module.loss({key: v[:1] for key, v in prepared.items()}, train=True)[0])
        loss_c = float(cpu.loss(cpu.prepare_batch(scene), train=True)[0])
    rel = abs(loss_d - loss_c) / abs(loss_c)
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"seg scene 0 loss card {loss_d} vs CPU {loss_c}: rel {rel} > {LOSS_RTOL}")
    del cpu
    module.load_flax_variables(variables)  # the running stats as loaded
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(float(module.train_step(prepared)["loss"]))
        if i == 0 and not all(bool(torch.isfinite(p.grad).all()) for p in module.model.parameters()):
            raise AssertionError("seg: non-finite gradients")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"seg: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    del module, prepared
    torch.cuda.empty_cache()
    log(f"[11] seg disco scene 0 train-mode loss card {loss_d:.6f} vs CPU {loss_c:.6f} (rel "
        f"{rel:.2e}, tol {LOSS_RTOL}); grads finite; loss over {TRAIN_STEPS} fp32 steps on one "
        f"batch: " + " ".join(f"{x:.4f}" for x in losses) + "; "
        + _seg_bf16_step(device, cfg, "disco", variables, batch) + f" [{card}]")

    for i, mode in enumerate(SEG_OTHER_MODES):
        t0 = time.perf_counter()
        variables = random_flax_variables(SegModel(cfg, mode), seed=seed + 1 + i)
        module = SegModule(cfg, mode, torch.float32, device=device)
        module.load_flax_variables(variables)
        msg = (f"{_seg_eval_check(module, module.prepare_batch(batch), mode)}; "
               f"{_seg_scene_vs_cpu(module, cfg, variables, scene, mode)}")
        del module
        torch.cuda.empty_cache()
        if mode in TRAIN_MODES:
            msg += "; " + _seg_bf16_step(device, cfg, mode, variables, batch)
        log(f"[11] seg {mode} at B={batch_size}: {msg}; {time.perf_counter() - t0:.1f} s [{card}]")

    _seg_workflow(cfg, card)
    torch.cuda.synchronize()
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the seg path launched a rotated-IoU kernel: {launches}")
    log(f"[11] kernel launches over the seg phase: {launches} (the seg path runs none of them)")


def _vis_bake(tmp: str, card: str) -> dict:
    """Phase 12 (a): create_data_det --vis 1 --targets 1 on the card, its
    launches, and frame 0 against the CPU's bake and against its maps
    carved again on the card."""
    import torch

    from v2x_sim_tpu_torch.configs.config import Config
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import create_data_det

    iou_cu.reset_launches()
    frames, _ = _run_tool(create_data_det, [
        "--root", "synthetic", "--savepath", os.path.join(tmp, "vis1"), "--scenes", "1",
        "--frames", str(WORKFLOW_FRAMES), "--targets", "1", "--vis", "1"], tag="[12]")
    torch.cuda.synchronize()
    launches = _launches()
    if (launches["periodic"] != 2 * frames or launches["forced"] != frames or launches["pairs"]
            or launches["matrix"]):
        raise AssertionError(f"baking {frames} frames (--vis 1) launched {launches}: want "
                             f"periodic {2 * frames}, forced {frames}, pairs 0")
    _, cpu_s = _run_tool(create_data_det, [
        "--root", "synthetic", "--savepath", os.path.join(tmp, "cpu"), "--scenes", "1", "--frames",
        "1", "--targets", "1", "--vis", "1", "--cpu"], tag="[12]")
    name = "scene0000_frame000.npz"
    card_path = os.path.join(tmp, "vis1", "train", name)
    same = _check_baked_frame(card_path, os.path.join(tmp, "cpu", "train", name))
    with np.load(card_path) as c, np.load(os.path.join(tmp, "cpu", "train", name)) as h:
        vis_card, vis_cpu = c["vis_maps"], h["vis_maps"]
        frame0 = {k: c[k] for k in ("points", "point_mask")}
    differ = int((vis_card != vis_cpu).sum())
    if vis_card.dtype != np.int8 or differ:
        raise AssertionError(f"baked frame 0: vis_maps ({vis_card.dtype}) differ card vs CPU in "
                             f"{differ} cells")
    counts = {name: int((vis_card == v).sum()) for name, v in (("free", 1), ("occupied", 2))}
    maps = create_data_det.add_vis(frame0, Config(), torch.device("cuda"), None)["vis_maps"]
    if not np.array_equal(maps, vis_card):
        raise AssertionError("frame 0's maps carved again on the card differ from its bake")
    log(f"[12] create_data_det --vis 1 --targets 1: {WORKFLOW_FRAMES} frames, launches "
        f"{launches}; frame 0's vis_maps (int8, {vis_card.shape}, {counts['free']} free and "
        f"{counts['occupied']} occupied cells) equal the CPU's bake in every cell and the maps "
        f"carved again on the card; {same}; the CPU baked it in {cpu_s:.1f} s [{card}]")
    return {"launches": launches, "cache": os.path.join(tmp, "vis1", "train")}


def _mgda_step_vs_cpu(device, make, scene) -> str:
    """One MGDA step (use_vis, KD) of one scene, prepared once on the card,
    in float64 on the card and on the CPU, and in fp32 on the card: task
    weights within MGDA_W_TOL of the CPU's float64 ones and on the simplex,
    losses within LOSS_RTOL. (fp32 gradients of this network move by up to
    1e-2 of a leaf between devices, and with them the weights by ~1e-4:
    float64 is the reference that holds the card to the CPU.)"""
    import torch

    card64 = make(torch.float64, device)
    prepared = card64.prepare_batch(scene)
    cast = lambda dtype, dev: {k: (v.to(dtype) if v.dtype == torch.float64 else v).to(dev)
                               for k, v in prepared.items()}
    mets = {"card f64": card64.train_step(prepared)}
    del card64
    module = make(torch.float64, "cpu")
    mets["CPU f64"] = module.train_step(cast(torch.float64, "cpu"))
    module = make(torch.float32, device)
    mets["card fp32"] = module.train_step(cast(torch.float32, device))
    del module, prepared
    mets = {run: {k: float(v) for k, v in m.items()} for run, m in mets.items()}
    ref = mets["CPU f64"]
    keys = [k for k in ref if k.startswith("mgda_w_")]
    msg = []
    for run in ("card f64", "card fp32"):
        got = mets[run]
        dw = max(abs(got[k] - ref[k]) for k in keys)
        rel = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ("cls_loss", "loc_loss", "kd_loss", "loss"))
        on_simplex = abs(sum(got[k] for k in keys) - 1.0) <= 1e-5 and min(got[k] for k in keys) >= 0
        if sorted(got) != sorted(ref) or len(keys) != 3 or not (
                dw <= MGDA_W_TOL and rel <= LOSS_RTOL and on_simplex):
            raise AssertionError(f"MGDA step scene 0 {run} {got} vs CPU f64 {ref}: max |d w| {dw} "
                                 f"(tol {MGDA_W_TOL}), loss rel {rel} (tol {LOSS_RTOL}), simplex "
                                 f"{on_simplex}")
        msg.append(f"{run}: weights " + "/".join(f"{got[k]:.6f}" for k in keys)
                   + f" (max |d| {dw:.1e}, sum {sum(got[k] for k in keys):.7f}), loss "
                   f"{got['loss']:.8g} (max rel over the terms {rel:.1e})")
    torch.cuda.empty_cache()
    return (f"scene 0's step against the CPU in float64 (weights cls/loc/kd " + "/".join(
        f"{ref[k]:.6f}" for k in keys) + f", loss {ref['loss']:.8g}; tol {MGDA_W_TOL} and rel "
        f"{LOSS_RTOL}): " + "; ".join(msg))


def _vis_mgda_train(device, cfg, spec, cache: str, card: str) -> dict:
    """Phase 12 (b): train_det --use_vis 1 --MGDA --kd_flag 1 from the baked
    cache in fp32 and bf16; one scene's MGDA step against the CPU; one
    prepare + step of a live batch (no baked targets or maps: the
    assignment and the visibility fallback run on the card)."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import train_det
    from v2x_sim_tpu_torch.train.det_module import DetModule

    out = {"launches": {"matrix": 0, "pairs": 0, "periodic": 0, "forced": 0}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mgda_") as tmp:
        for label, extra in (("fp32", []), ("bf16", ["--bf16"])):
            iou_cu.reset_launches()
            run, _ = _run_tool(train_det, [
                "--data", cache, "--com", "disco", "--batch", str(BATCH), "--batches_per_epoch",
                "1", "--nepoch", "2", "--use_vis", "1", "--MGDA", "--kd_flag", "1", "--log_every",
                "1", "--logpath", os.path.join(tmp, label)] + extra, tag="[12]")
            torch.cuda.synchronize()
            got = _launches()
            w = [run.metrics.get(f"mgda_w_{k}", -1.0) for k in ("cls_loss", "loc_loss", "kd_loss")]
            if any(got.values()) or run.step != 2 or not (
                    np.isfinite(list(run.metrics.values())).all() and abs(sum(w) - 1.0) <= 1e-5
                    and min(w) >= 0.0):
                raise AssertionError(f"train_det --use_vis 1 --MGDA ({label}): launches {got}, step "
                                     f"{run.step}, metrics {run.metrics}")
            log(f"[12] train_det --use_vis 1 --MGDA --kd_flag 1 {label} from the cache at B={BATCH}, "
                f"2 epochs of its one batch: no launches (targets and maps baked), loss "
                f"{run.metrics['loss']:.4f}, weights cls/loc/kd " + " ".join(f"{x:.4f}" for x in w)
                + f" [{card}]")

    variables = random_flax_variables(DetModel(cfg, "disco", kd=True, use_vis=True), seed=60)
    teacher = random_flax_variables(DetModel(cfg, "upperbound"), seed=61)

    def make(dtype, dev):
        m = DetModule(cfg, "disco", dtype, device=dev, kd_weight=KD_WEIGHT, use_vis=True, mgda=True)
        if dtype == torch.float64:
            m.model.double()
        m.load_flax_variables(variables)
        m.load_teacher_flax_variables(teacher)
        return m

    live = generate_batch(cfg, spec, BATCH, seed=62)
    out["vs_cpu"] = _mgda_step_vs_cpu(device, make, {k: v[:1] for k, v in live.items()})
    log(f"[12] MGDA + use_vis + KD {out['vs_cpu']}")

    # The live batch: assignment (K2 twice, the aligned pairs) and the
    # visibility fallback on the card, then one MGDA step.
    module = make(torch.float32, device)
    iou_cu.reset_launches()
    bt = module.to_device(live)
    vis = module.vis_input(bt)
    prepared = module.prepare_batch(live)
    metrics = module.train_step(prepared)
    torch.cuda.synchronize()
    got = _launches()
    for key, v in got.items():
        out["launches"][key] += v
    if got["periodic"] != 2 or got["forced"] != 1 or got["pairs"] or got["matrix"]:
        raise AssertionError(f"the live MGDA batch launched {got}: want periodic 2, forced 1, "
                             f"pairs 0")
    cpu_vis = module.vis_input({k: v[:1].cpu() for k, v in bt.items()})  # scene 0 on the CPU
    differ = int((vis[:1].cpu() != cpu_vis).sum())
    if differ or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"visibility fallback: scene 0 differs from the CPU in {differ} cells, "
                             f"loss {float(metrics['loss'])}")
    log(f"[12] live batch at B={BATCH} (no baked targets or maps): launches {got}; the visibility "
        f"fallback carves {BATCH * cfg.num_agents} clouds ({spec.points_per_agent} points x 384 "
        f"samples, chunks of 8), scene 0 equal to the CPU's in every cell; prepare_batch "
        f"(fallback, voxelize, assign, teacher input) and an MGDA step: loss "
        f"{float(metrics['loss']):.4f} [{card}]")
    del module, bt, vis, prepared, metrics, cpu_vis
    torch.cuda.empty_cache()
    loss = _finite_step(make(torch.bfloat16, device), live, "MGDA + use_vis + KD bf16")
    log(f"[12] live batch, bf16 prepare + MGDA step: loss {loss:.4f}, grads finite")
    torch.cuda.empty_cache()
    return out


def _vis_track(device, cfg, spec, tmp: str, card: str) -> dict:
    """Phase 12 (c): a generated sequence saved as a cache with gt_ids;
    test_det --use_vis 1 --save_dets on the card and on the CPU (fixed
    random weights, the visibility fallback), then tools/track.py over
    each: kept sets per frame and agent equal, and so the tracking results
    (tracking is host code: equal kept sets give equal results, and random
    weights' boxes match no GT at IoU 0.5). Then track.py over the
    sequence's GT jittered by a seeded noise, where SORT associates and the
    scorers match: its results against TRACK_JITTER_WANT."""
    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.datasets.cache import save_frame
    from v2x_sim_tpu_torch.datasets.synthetic import generate_sequence
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import test_det, track
    from v2x_sim_tpu_torch.train.checkpoint import save_checkpoint
    from v2x_sim_tpu_torch.train.det_module import DetModule

    seq = os.path.join(tmp, "seq")
    frames = generate_sequence(cfg, spec, seed=70, num_frames=TRACK_FRAMES)
    for i, frame in enumerate(frames):
        save_frame(seq, f"frame{i:03d}", frame)
    module = DetModule(cfg, "disco", device="cpu", use_vis=True)
    module.load_flax_variables(random_flax_variables(DetModel(cfg, "disco", use_vis=True), seed=71))
    ckpt = save_checkpoint(os.path.join(tmp, "trk_run"), module, 0)
    del module
    results, dumps, secs = {}, {}, {}
    out = {"launches": {}}
    for where in ("card", "cpu"):
        dumps[where] = os.path.join(tmp, f"dets_{where}")
        argv = ["--data", seq, "--com", "disco", "--batch", str(TRACK_FRAMES), "--num_batches", "1",
                "--resume", ckpt, "--use_vis", "1", "--save_dets", dumps[where]]
        iou_cu.reset_launches()
        _, secs[where] = _run_tool(test_det, argv + (["--cpu"] if where == "cpu" else []), tag="[12]")
        torch.cuda.synchronize()
        if where == "card":
            out["launches"] = _launches()
        results[where], _ = _run_tool(track, ["--dets", dumps[where]], tag="[12]")
    got = out["launches"]
    want = 1 + 2 * cfg.num_agents
    if got["matrix"] != want or got["pairs"] or got["periodic"] or got["forced"]:
        raise AssertionError(f"test_det --use_vis 1 launched {got}: want matrix {want} (NMS, 2 "
                             f"thresholds x {cfg.num_agents} agents)")
    card_z, cpu_z = (_load_npz(os.path.join(dumps[w], "dets_00000.npz")) for w in ("card", "cpu"))
    if not np.array_equal(card_z["gt_ids"], np.stack([f["gt_ids"] for f in frames])):
        raise AssertionError("the dumps do not carry the sequence's gt_ids")
    differ = []
    for f, a in np.ndindex(*card_z["valid"].shape[:2]):
        boxes = [torch.from_numpy(z["boxes"][f, a][z["valid"][f, a]]) for z in (card_z, cpu_z)]
        scores = [torch.from_numpy(z["scores"][f, a][z["valid"][f, a]]) for z in (card_z, cpu_z)]
        same, _ = _same_kept_set(boxes[0], scores[0], boxes[1], scores[1])
        if not same:
            differ.append(f"frame {f} agent {a} ({len(boxes[0])} kept on the card, {len(boxes[1])} "
                          f"on the CPU)")
    if differ:
        raise AssertionError("kept sets differ card vs CPU at " + "; ".join(differ))
    card_r, cpu_r = results["card"], results["cpu"]
    counts = ("id_switches", "misses", "false_positives", "num_gt", "matches", "mota")
    close = lambda k, x, y: x == y if k in counts else abs(x - y) <= 1e-4
    bad = [(ag, k) for ag in cpu_r for k in cpu_r[ag]
           if not close(k, card_r.get(ag, {}).get(k, np.nan), cpu_r[ag][k])]
    unequal = sum(card_r[ag][k] != cpu_r[ag][k] for ag in cpu_r for k in cpu_r[ag])
    if card_r.keys() != cpu_r.keys() or bad:
        raise AssertionError(f"tracking results card vs CPU differ at {bad}: {card_r} vs {cpu_r}")
    kept = int(card_z["valid"].sum())
    matched = int(sum(r["matches"] for ag, r in card_r.items() if ag != "global"))
    log(f"[12] tracking: {TRACK_FRAMES}-frame sequence (gt_ids), test_det --use_vis 1 --save_dets on "
        f"the card in {secs['card']:.2f} s (K1 launches {got}: NMS and mAP) and on the CPU in "
        f"{secs['cpu']:.1f} s; {kept} boxes kept, the same set at every frame and agent; track.py: "
        f"global MOTA {card_r['global']['mota']}, HOTA {card_r['global']['hota']} on both, "
        f"{unequal} printed values apart (counts and MOTA exact, IoU means within 1e-4); "
        f"{matched} detections match GT at IoU 0.5, so this equality follows from the kept sets "
        f"[{card}]")
    jitter = _track_jittered_gt(card_z, os.path.join(tmp, "dets_gt"))
    out.update({"mota": card_r["global"]["mota"], "hota": card_r["global"]["hota"], "kept": kept,
                "unequal": unequal, "matched": matched, "jitter": jitter})
    return out


# track.py's results over phase 12's sequence (seed 70, TRACK_FRAMES frames,
# production geometry) with its GT boxes jittered by TRACK_JITTER_SIGMA
# (numpy default_rng(72)): the JAX package's tools/track.py reads the same
# numbers from the same dump, and tests/test_torch_tracking.py holds the
# port's track.py to that tool.
TRACK_JITTER_SIGMA = (0.1, 0.1, 0.0, 0.0, 0.02)  # m, m, -, -, rad
TRACK_JITTER_WANT = {"mota": 0.4653, "hota": 0.5316, "matches": 264, "id_switches": 33,
                     "misses": 184, "false_positives": 21, "num_gt": 448}


def _track_jittered_gt(seq_dump: dict, out_dir: str) -> dict:
    """track.py over one dump of the sequence's GT boxes, jittered, as the
    detections (score 0.9): SORT's association and the MOT/HOTA matching
    run on boxes that do match. Global MOTA and HOTA within 1e-4 and the
    summed counts exactly as TRACK_JITTER_WANT."""
    from v2x_sim_tpu_torch.tools import track

    gt, mask = seq_dump["gt_boxes"], seq_dump["gt_mask"]
    noise = np.random.default_rng(72).normal(size=gt.shape) * np.asarray(TRACK_JITTER_SIGMA)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "dets_00000.npz"), boxes=(gt + noise).astype(np.float32),
        scores=np.where(mask, 0.9, 0.0).astype(np.float32), valid=mask, gt_boxes=gt,
        gt_mask=mask, agent_mask=seq_dump["agent_mask"], gt_ids=seq_dump["gt_ids"])
    res, secs = _run_tool(track, ["--dets", out_dir], tag="[12]")
    got = {k: res["global"][k] for k in ("mota", "hota")}
    got.update({k: int(sum(r[k] for ag, r in res.items() if ag != "global"))
                for k in ("matches", "id_switches", "misses", "false_positives", "num_gt")})
    bad = [k for k, want in TRACK_JITTER_WANT.items()
           if (abs(got[k] - want) > 1e-4 if isinstance(want, float) else got[k] != want)]
    if bad:
        raise AssertionError(f"track.py over the jittered GT: {got}, want {TRACK_JITTER_WANT} "
                             f"(apart at {bad})")
    log(f"[12] track.py over the sequence's GT jittered by {TRACK_JITTER_SIGMA}: {got}, as the "
        f"JAX package's tool reads them, in {secs:.2f} s (host)")
    return got


def phase_vis_mgda_track(device, cfg, spec, card: str) -> dict:
    """Visibility input, MGDA training and tracking at full width: (a) the
    bake with --vis, (b) MGDA training with use_vis and KD, (c) tracking
    the card's detections against the CPU's. Kernel launches summed over
    the phase."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vis_") as tmp:
        bake = _vis_bake(tmp, card)
        train = _vis_mgda_train(device, cfg, spec, bake["cache"], card)
        trk = _vis_track(device, cfg, spec, tmp, card)
    launches = {k: bake["launches"][k] + train["launches"][k] + trk["launches"][k]
                for k in bake["launches"]}
    log(f"[12] kernel launches over the phase: {launches}")
    return {"bake": bake, "train": train, "track": trk, "launches": launches}


def _finite_values(record, what: str) -> None:
    """Every number of a JSON record (nested lists and dicts too) finite."""
    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, (int, float)) and not isinstance(v, bool) and not np.isfinite(v):
            raise AssertionError(f"{what}: a value is not finite: {record}")
    walk(record)


def _probe_keeps_state(device) -> str:
    """diag_upperbound's probe on the card, after one training step on a
    baked pool batch: parameters, buffers and Adam state bit-identical."""
    import torch

    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.tools import bench_table, diag_upperbound
    from v2x_sim_tpu_torch.train.det_module import DetModule

    args = diag_upperbound.parse_args(["--grid", TOOLS_GRID, "--batch", "2", "--data_pool", "1",
                                       "--eval_batches", "1"])
    args.device = device
    cfg, spec = bench_table.build_config(args), bench_table.build_spec(args)
    mod = DetModule(cfg, "upperbound", device=device, learning_rate=args.lr)
    mod.init_weights(0)
    stream = bench_table._train_stream(args, cfg, spec, 0, {})
    mod.train_step(mod.prepare_batch(stream(0)))
    held = [generate_batch(cfg, spec, batch_size=2, seed=900_000)]
    state = {k: v.clone() for k, v in mod.model.state_dict().items()}
    opt = [{k: v.clone() for k, v in st.items()} for st in mod.optimizer.state.values()]
    rec = diag_upperbound.probe_record(mod, held, [mod.prepare_batch(h) for h in held], [stream(0)],
                                       args)
    _finite_values(rec, "diag_upperbound probe")
    moved = [k for k, v in mod.model.state_dict().items() if not torch.equal(v, state[k])]
    moved += [f"adam {i}.{k}" for i, st in enumerate(mod.optimizer.state.values())
              for k, v in st.items() if not torch.equal(v, opt[i][k])]
    if moved:
        raise AssertionError(f"diag_upperbound's probe moved {moved[:5]} ({len(moved)} in all)")
    return (f"a probe after one step moved none of {len(state)} state entries and "
            f"{len(opt)} Adam states (held BN gap: cls {rec['held_cls_loss_run']} running vs "
            f"{rec['held_cls_loss_bat']} batch stats)")


def phase_tools(device, card: str) -> dict:
    """Phase 13: the benchmark-table, diagnostic and profiling tools through
    their main(argv) at full width (Config(): 256x256x13, 6 agents), in a
    temporary directory. Returns the summed kernel launches and the xprof
    reports."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import (
        bench_table,
        bench_table_assemble,
        bench_table_merge,
        bench_table_track,
        diag_upperbound,
        diag_v2v,
        xprof_det,
    )

    cpu = ["--cpu"] if device.type == "cpu" else []
    grid = ["--grid", TOOLS_GRID, "--agents", "6"] + cpu
    total = {"matrix": 0, "pairs": 0, "periodic": 0, "forced": 0}
    out = {}

    def run(tool, argv, check=lambda c: True):
        """``tool.main(argv)``; its launches, held to ``check`` on the card."""
        iou_cu.reset_launches()
        result, secs = _run_tool(tool, argv, tag="[13]")
        counts = _launches()
        if device.type == "cuda":
            torch.cuda.synchronize()
            if not check(counts):
                raise AssertionError(f"{tool.__name__} launched {counts}")
        for key, v in counts.items():
            total[key] += v
        return result, secs, counts

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        # (a) The det sweep: a baked pool on the card, four modes, disco+kd on
        # the upperbound row's state. K2 runs in the bake (2 a pool batch)
        # and in each mode's warmup step on live targets (2), as the JAX
        # tool's; never in a training step.
        states, table = os.path.join(tmp, "states"), os.path.join(tmp, "BT.md")
        bake_counts = []
        bake = bench_table._bake_pool_targets

        def counted_bake(*a, **kw):
            before = _launches()
            n = bake(*a, **kw)
            bake_counts.append({k: v - before[k] for k, v in _launches().items()})
            return n

        bench_table._bake_pool_targets = counted_bake
        try:
            rows, secs, counts = run(bench_table, grid + [
                "--modes", ",".join(TOOLS_MODES), "--steps", "4", "--batch", "4", "--data_pool",
                str(TOOLS_POOL), "--bake_pool", "1", "--cosine", "--eval_at", "2", "--eval_batches",
                "1", "--save_states", states, "--out", table],
                check=lambda c: c["periodic"] == 2 * TOOLS_POOL + 2 * len(TOOLS_MODES)
                and c["forced"] == TOOLS_POOL + len(TOOLS_MODES) and not c["pairs"]
                and c["matrix"] > 0)
        finally:
            bench_table._bake_pool_targets = bake
        if device.type == "cuda" and [c["periodic"] for c in bake_counts] != [2 * TOOLS_POOL]:
            raise AssertionError(f"the pool bake launched {bake_counts}: want one bake, "
                                 f"periodic {2 * TOOLS_POOL}")
        curves_path = os.path.join(tmp, "BT_curves.jsonl")
        with open(curves_path) as f:
            curves = [json.loads(line) for line in f if line.strip()]
        if [r["mode"] for r in rows] != list(TOOLS_MODES) or rows[-1]["teacher_s"] != 0.0:
            raise AssertionError(f"bench_table rows {rows}: want {TOOLS_MODES}, disco+kd's teacher_s 0")
        if [[e["step"] for e in c["curve"]] for c in curves] != [[2, 4]] * len(TOOLS_MODES):
            raise AssertionError(f"bench_table curves {curves}")
        _finite_values(rows, "bench_table rows")
        _finite_values(curves, "bench_table curves")
        log(f"[13] bench_table det {','.join(TOOLS_MODES)} at B=4, pool {TOOLS_POOL} baked, 4 cosine "
            f"steps, eval at 2 and 4: {secs:.1f} s, launches {counts} (the bake {bake_counts}, "
            f"K2's rest in the {len(TOOLS_MODES)} warmup steps, none in a training step); "
            + "; ".join(f"{r['mode']} {r['steps_per_s']} steps/s, compile_s {r['compile_s']}"
                        for r in rows) + f" [{card}]")
        out["bench_table"] = {"rows": rows, "s": secs, "launches": counts}
        # (b) The seg sweep: no kernel of the port on its path.
        seg_rows, secs, counts = run(bench_table, grid + [
            "--task", "seg", "--modes", "disco", "--steps", "2", "--batch", "4", "--eval_batches",
            "1", "--out", os.path.join(tmp, "BTS.md")],
            check=lambda c: not any(c.values()))
        _finite_values(seg_rows, "bench_table seg rows")
        log(f"[13] bench_table seg disco, 2 steps at B=4: {secs:.1f} s, mIoU {seg_rows[0]['mIoU']}, "
            f"launches {counts}")
        # (c) The tracking table over the saved states: one 4-frame sequence.
        track_rows, secs, counts = run(bench_table_track, grid + [
            "--states", states, "--seqs", "1", "--frames", "4", "--out", os.path.join(tmp, "BTT.md")],
            check=lambda c: c["matrix"] > 0 and c["periodic"] == 0)
        if [r["mode"] for r in track_rows] != list(TOOLS_MODES):
            raise AssertionError(f"bench_table_track rows {[r['mode'] for r in track_rows]}")
        _finite_values([{k: v for k, v in r.items() if k != "streams"} for r in track_rows],
                       "bench_table_track rows")
        log(f"[13] bench_table_track over {len(track_rows)} saved states, 1 sequence x 4 frames: "
            f"{secs:.1f} s, launches {counts}; MOTA "
            + ", ".join(f"{r['mode']} {r['mota']}" for r in track_rows))
        # (d) Merge and assemble over those outputs (host only).
        merged = os.path.join(tmp, "M.md")
        run(bench_table_merge, ["--curves", curves_path, "--out", merged],
            check=lambda c: not any(c.values()))
        log_path = os.path.join(tmp, "rows.log")
        with open(log_path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
        assembled = os.path.join(tmp, "A.md")
        run(bench_table_assemble, ["--logs", log_path, "--curves", curves_path, "--header",
                                   "chip_smoke phase 13", "--out", assembled, "--curves_out",
                                   os.path.join(tmp, "A_curves.jsonl")],
            check=lambda c: not any(c.values()))
        for path in (merged, assembled):
            with open(path) as f:
                text = f.read()
            missing = [m for m in TOOLS_MODES if f"**{m}**" not in text and f"| {m} |" not in text]
            if missing:
                raise AssertionError(f"{os.path.basename(path)} lacks {missing}")
        log("[13] bench_table_merge and bench_table_assemble: every mode in both tables")
        # (e) diag_v2v: the GRU tap, one row a round at every probe.
        records, secs, counts = run(diag_v2v, grid + ["--steps", "2", "--probe_every", "1",
                                                      "--batch", "2"])
        if [r["step"] for r in records] != [0, 1, 2] or any(len(r["gru_rounds"]) != 3 for r in records):
            raise AssertionError(f"diag_v2v records {records}")
        _finite_values(records, "diag_v2v")
        log(f"[13] diag_v2v 2 steps at B=2: {secs:.1f} s, 3 probes x 3 rounds of finite gate stats; "
            f"last round at step 2: {records[-1]['gru_rounds'][-1]}")
        # (f) diag_upperbound; then its probe against a run's state.
        diag, secs, counts = run(diag_upperbound, grid + [
            "--modes", "upperbound", "--steps", "2", "--probe_every", "2", "--data_pool", "2",
            "--batch", "2", "--eval_batches", "1", "--out", os.path.join(tmp, "diag.jsonl")])
        if [r["step"] for r in diag] != [0, 2]:
            raise AssertionError(f"diag_upperbound records {diag}")
        _finite_values(diag, "diag_upperbound")
        log(f"[13] diag_upperbound 2 steps at B=2: {secs:.1f} s, launches {counts}; "
            f"{_probe_keeps_state(device)}")
        out["diag_upperbound"] = diag[-1]
        # (g) The profiler at B=16, bf16.
        prof = ["--grid", PROFILE_GRID, "--batch", str(BATCH)] + cpu
        out["xprof"] = {}
        for what in ("train", "prepare", "predict"):
            rep, secs, counts = run(xprof_det, prof + ["--what", what, "--top", "15",
                                                       "--trace_dir", os.path.join(tmp, "xt")])
            if device.type == "cuda":
                if not 0.0 < rep["busy"] <= 1.0:
                    raise AssertionError(f"xprof_det {what}: busy share {rep['busy']}")
                if what == "prepare" and rep["categories_ms"]["rotated_iou (K1, K2)"] <= 0.0:
                    raise AssertionError("xprof_det prepare: no rotated_iou kernel in the trace")
                # The entry's device time is its child spans' (each launch
                # credited to the span open when it began), and K2's two
                # launches land in the assignment's IoU span.
                spans = rep["spans"]
                entry = next(iter(spans))
                kids = sum(r["device_ms"] for p, r in spans.items() if p.count("/") == 1)
                if abs(kids - spans[entry]["device_ms"]) > 0.05 * spans[entry]["device_ms"]:
                    raise AssertionError(f"xprof_det {what}: child spans {kids} ms of {entry}'s "
                                         f"{spans[entry]['device_ms']} ms")
                iou = spans.get("det.prepare_batch/det.assign/det.assign.iou", {})
                if what == "prepare" and iou.get("launches", 0) < 2:
                    raise AssertionError(f"xprof_det prepare: the IoU span launched {iou}")
            out["xprof"][what] = rep
        log(f"[13] xprof_det busy / idle share at B={BATCH}: "
            + "; ".join(f"{w} {r.get('busy', float('nan')):.4f} / {r.get('idle', float('nan')):.4f} "
                        f"of {r.get('window_ms', float('nan')):.3f} ms"
                        for w, r in out["xprof"].items()) + f" [{card}]")
        log(f"[13] xprof_det device ms a call by span at B={BATCH}: "
            + "; ".join(f"{p} {r['device_ms']}" for rep in out["xprof"].values()
                        for p, r in rep["spans"].items() if p.count("/") <= 1) + f" [{card}]")
    out["launches"] = total
    log(f"[13] kernel launches over the phase: {total}")
    return out



#: Phase 14: data parallelism and row sharding, two gloo ranks sharing the
#: card. The DP steps run in float64 so that the 2-rank step can be held
#: to the single-process step by the parity tests' rules.
DP_RANKS = 2
DP_SEED = 50
DP_DEVICE = "cuda:0"
DP_CASES = (("disco", "disco", {}), ("disco+kd", "disco", {"kd_weight": KD_WEIGHT}),
            ("mgda+use_vis", "disco", {"mgda": True, "use_vis": True}))
DP_LR = 1e-3
DP_LOSS_RTOL = 1e-5  # the loss terms are float32 sums, also in a float64 step
DP_STATS_TOL = 1e-8  # running stats, float64
SPATIAL_TOL = 1e-10  # the row-sharded encoder and stem step (float64), relative to the max
#: Phase 14 (b): train_det --dp 1 (NCCL) against --dp 0.
DP_TOOL_BATCH = 4
DP_TOOL_TIMEOUT_S = 300.0  # a --dp run's ranks, and each of their collectives


def _dp_record(module, metrics) -> dict:
    """A task module after a step, on the device: metrics, parameters,
    floating buffers and Adam's first moment, by name."""
    named = dict(module.model.named_parameters())
    return {"metrics": {k: v.detach() for k, v in metrics.items()},
            "params": {n: p.detach().clone() for n, p in named.items()},
            "buffers": {n: b.clone() for n, b in module.model.named_buffers() if b.is_floating_point()},
            "exp_avg": {n: module.optimizer.state[p]["exp_avg"].clone() for n, p in named.items()}}


def _same_on_every_rank(record: dict) -> bool:
    """Whether every tensor of the record is bit-identical to rank 0's."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).double() for part in record.values() for t in part.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    return bool(torch.equal(flat, ref))


def _dp_compare(got: dict, want: dict) -> dict:
    """The DP step's record against the single-process step's: the largest
    error of each part, under tests/test_torch_train.py's rules (grads:
    1e-4 x a leaf's max; Adam: 1e-8 where the gradient is clear of
    rounding, 2 lr elsewhere). Raises where a rule fails."""
    gmax = max(g.abs().max().item() for g in want["exp_avg"].values())
    err = {"loss_rel": 0.0, "mgda_w": 0.0, "grad_rel": 0.0, "param_clear": 0.0, "param": 0.0,
           "stats": 0.0}
    for k, w in want["metrics"].items():
        g, w = got["metrics"][k].item(), w.item()
        if k.startswith("mgda_w_"):
            err["mgda_w"] = max(err["mgda_w"], abs(g - w))
        else:
            err["loss_rel"] = max(err["loss_rel"], abs(g - w) / max(abs(w), 1e-30))
    for n, w in want["exp_avg"].items():
        scale = max(w.abs().max().item(), 1e-6 * gmax)
        err["grad_rel"] = max(err["grad_rel"], (got["exp_avg"][n] - w).abs().max().item() / scale)
        clear = w.abs() > 1e-3 * scale
        d = (got["params"][n] - want["params"][n]).abs()
        err["param"] = max(err["param"], d.max().item())
        if clear.any():
            err["param_clear"] = max(err["param_clear"], d[clear].max().item())
    for n, w in want["buffers"].items():
        err["stats"] = max(err["stats"], ((got["buffers"][n] - w).abs() / (w.abs() + 1.0)).max().item())
    ok = (err["loss_rel"] <= DP_LOSS_RTOL and err["mgda_w"] <= 1e-6 and err["grad_rel"] <= 1e-4
          and err["param_clear"] <= 1e-8 and err["param"] <= 2 * DP_LR and err["stats"] <= DP_STATS_TOL)
    if not ok or sorted(got["metrics"]) != sorted(want["metrics"]):
        raise AssertionError(f"DP step against the single-process step: {err}")
    return err


def _dp_spatial(mesh, cfg, batch, seed: int) -> dict:
    """Phase 14 (c) on one rank: the row-sharded 5-stage encoder (inference
    BatchNorm, random running stats) against the unsharded STPNEncoder on
    scene 0's 6 maps at 256 rows, and one SGD step of the sharded stem
    against the unsharded one, in float64. Returns the relative errors."""
    import copy

    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables, state_dict_from_flax
    from v2x_sim_tpu_torch.models.backbone import fold_agents
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.voxelize import voxelize_batch
    from v2x_sim_tpu_torch.parallel.spatial import (
        make_spatial_encoder,
        make_spatial_stem_train_step,
        shard_rows,
    )

    model = DetModel(cfg, "disco")
    model.load_state_dict(state_dict_from_flax(random_flax_variables(model, seed=seed), "disco"))
    encoder = model.encoder.to(mesh.device, torch.float64)
    pts = torch.from_numpy(batch["points"][:1]).to(mesh.device)
    pmask = torch.from_numpy(batch["point_mask"][:1]).to(mesh.device)
    x = fold_agents(voxelize_batch(pts, pmask, cfg.grid, torch.float64)).permute(0, 3, 1, 2)
    x = x.contiguous()
    out = {}
    with torch.no_grad():
        want = encoder(x)
        got = make_spatial_encoder(mesh, encoder)(shard_rows(x, mesh))
    out["encoder"] = max((g - shard_rows(w, mesh)).abs().max().item() / w.abs().max().item()
                         for g, w in zip(got, want))
    out["rows"] = x.shape[2]
    sharded, plain = copy.deepcopy(encoder.blocks[0]), copy.deepcopy(encoder.blocks[0])
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    target = torch.randn((x.shape[0], plain.conv1.out_channels) + tuple(x.shape[2:]),
                         generator=gen, device=mesh.device, dtype=torch.float64)
    loss = make_spatial_stem_train_step(mesh, sharded, learning_rate=0.1)(
        shard_rows(x, mesh), shard_rows(target, mesh))
    ref = ((plain(x, train=True) - target) ** 2).mean()
    ref.backward()
    with torch.no_grad():
        for p in plain.parameters():
            p.sub_(0.1 * p.grad)
    out["stem_loss"] = abs(loss.item() - ref.item()) / ref.item()
    out["stem_state"] = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                            for a, b in zip(sharded.state_dict().values(), plain.state_dict().values())
                            if b.is_floating_point())
    return out


def _dp_rank(rank: int, world: int, init_method: str, cfg, spec, batch_size: int,
             device: str) -> dict:
    """Phase 14 on one of the ranks that share the card over gloo. (a) Each
    DP case's float64 step on this rank's 8 of the 16 scenes; rank 0 then
    takes the single-process step on the 16 and holds the DP step to it.
    (c) The row-sharded encoder and stem step."""
    import torch
    import torch.distributed as dist

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world, rank=rank, init_method=init_method, backend="gloo", device=device)
    batch = generate_batch(cfg, spec, batch_size, seed=DP_SEED)
    batch = {k: v for k, v in batch.items() if k != "visible"}
    local = shard_batch(batch, mesh)

    def det(mode, opts, dtype, group):
        kd = opts.get("kd_weight", 0.0) > 0.0
        module = DetModule(cfg, mode, dtype, mesh.device, learning_rate=DP_LR, process_group=group,
                           **opts)
        module.model.to(dtype)
        model = DetModel(cfg, mode, kd=kd, use_vis=opts.get("use_vis", False))
        module.load_flax_variables(random_flax_variables(model, seed=DP_SEED))
        if kd:
            module.init_teacher_weights(DP_SEED + 1)
        return module

    def seg(dtype, group):
        module = SegModule(cfg, "disco", dtype, mesh.device, learning_rate=DP_LR, process_group=group)
        module.model.to(dtype)
        module.load_flax_variables(random_flax_variables(module.model, seed=DP_SEED))
        return module

    makers = {name: (lambda group, m=mode, o=opts: det(m, o, torch.float64, group))
              for name, mode, opts in DP_CASES}
    makers["seg"] = lambda group: seg(torch.float64, group)
    out = {"identical": {}, "errors": {}, "secs": {}}
    iou_cu.reset_launches()
    for name, make in makers.items():
        t0 = time.perf_counter()
        module = make(mesh.data_group)
        record = _dp_record(module, module.train_step(module.prepare_batch(local)))
        out["identical"][name] = _same_on_every_rank(record)
        del module
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:  # the single-process step on the 16 scenes
            module = make(None)
            want = _dp_record(module, module.train_step(module.prepare_batch(batch)))
            del module
            out["errors"][name] = _dp_compare(record, want)
            del want
        del record
        torch.cuda.empty_cache()
        dist.barrier()
        out["secs"][name] = time.perf_counter() - t0

    out["fp32_loss"] = _finite_step(det("disco", {}, torch.float32, mesh.data_group), local,
                                    f"rank {rank}: fp32 DP step")
    torch.cuda.empty_cache()
    dist.barrier()
    out["launches"] = {"pairs": iou_cu.rotated_iou_pairs_soa.launches,
                       "periodic": iou_cu.rotated_iou_pairs_soa_periodic.launches,
                       "forced": iou_cu.forced_anchor.launches}
    smesh = make_mesh(world, spatial=world, backend="gloo", device=device)
    out["spatial"] = _dp_spatial(smesh, cfg, batch, DP_SEED)
    return out


def _dp_tool(card: str) -> dict:
    """Phase 14 (b): train_det --dp 1 (one rank, NCCL) for 2 steps against
    --dp 0's 2 steps from the same seed, and --dp 1 resumed from its first
    epoch's checkpoint against its uninterrupted second step."""
    import shutil
    import tempfile

    import torch

    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import train_det

    argv = ["--com", "disco", "--batch", str(DP_TOOL_BATCH), "--batches_per_epoch", "1",
            "--log_every", "1", "--lr", str(DP_LR), "--nepoch", "2"]
    train_det.DP_TIMEOUT = DP_TOOL_TIMEOUT_S
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        one, dp, res = (os.path.join(tmp, d) for d in ("dp0", "dp1", "resumed"))
        iou_cu.reset_launches()
        _, secs0 = _run_tool(train_det, argv + ["--logpath", one], tag="[14]")
        launches = {"pairs": iou_cu.rotated_iou_pairs_soa.launches,
                    "periodic": iou_cu.rotated_iou_pairs_soa_periodic.launches,
                    "forced": iou_cu.forced_anchor.launches}
        whole, secs1 = _run_tool(train_det, argv + ["--dp", "1", "--logpath", dp], tag="[14]")
        os.makedirs(res)
        shutil.copy(os.path.join(dp, "epoch_0"), res)
        resumed, secs2 = _run_tool(train_det, argv + ["--dp", "1", "--resume", "auto",
                                                      "--logpath", res], tag="[14]")
        files = sorted(os.listdir(dp))
        losses = [[json.loads(ln)["loss"] for ln in open(os.path.join(d, "metrics.jsonl"))]
                  for d in (one, dp, res)]
        want, got, again = (torch.load(os.path.join(d, "epoch_1"), map_location="cpu",
                                       weights_only=True)["model"] for d in (one, dp, res))
    params = [k for k in want if want[k].is_floating_point() and "running_" not in k]
    diff = max((got[k].double() - want[k].double()).abs().max().item() for k in params)
    # Resumed against uninterrupted: equal but where the card's
    # nondeterministic weight gradients tip an entry's Adam step.
    moved = torch.cat([(again[k].double() - got[k].double()).abs().flatten() for k in params])
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    loss_rel = [rel(losses[1][0], losses[0][0]), rel(losses[1][-1], losses[0][-1])]
    resumed_rel = max(rel(a, b) for a, b in zip(losses[2], losses[1][2:]))
    if ((whole.step, resumed.start_epoch, resumed.start_step, resumed.step) != (2, 1, 1, 2)
            or files != ["epoch_0", "epoch_1", "log.txt", "metrics.jsonl"]
            or len(losses[1]) != len(losses[0]) or len(losses[2]) != len(losses[1]) - 2
            or max(loss_rel) > DP_LOSS_RTOL or resumed_rel > 1e-6
            or diff > 2 * 2 * DP_LR or moved.max().item() > 2 * DP_LR
            or (moved > 1e-6).double().mean().item() > 1e-3 or not np.isfinite(losses[1]).all()):
        raise AssertionError(f"train_det --dp 1: runs {whole} / {resumed}, files {files}, losses "
                             f"{losses}, parameter difference {diff}, resumed vs uninterrupted "
                             f"{moved.max().item()}")
    log(f"[14] (b) train_det --dp 1 (NCCL, cuda:0) at B={DP_TOOL_BATCH}, 2 steps: {secs1:.1f} s; "
        f"--dp 0: {secs0:.1f} s; loss rel {loss_rel[0]:.2e} (first), {loss_rel[1]:.2e} (second); "
        f"parameters after 2 steps within {diff:.3e} (bound 4 lr). Resumed from epoch_0 for the "
        f"second step ({secs2:.1f} s): loss rel {resumed_rel:.2e} to the uninterrupted run's, "
        f"parameters within {moved.max().item():.3e}, {(moved > 1e-6).double().mean().item():.2e} "
        f"of them beyond 1e-6 [{card}]")
    return launches


#: Phase 14 (d): whole-model row sharding on a (data 2, spatial 2) mesh of
#: 4 gloo ranks sharing the card. The float64 steps held to one process run
#: at B=4: rank 0 also takes the single-process step, and float64 needs
#: about twice fp32's 23.48 GiB at B=16.
SPATIAL_RANKS = 4
SPATIAL_SIZE = 2
SPATIAL_CHECK_BATCH = 4
SPATIAL_CASES = (("disco", "disco", {}), ("disco+kd", "disco", {"kd_weight": KD_WEIGHT}))


def _spatial_rank(rank: int, world: int, init_method: str, cfg, spec, device: str) -> dict:
    """Phase 14 (d) on one of the 4 ranks of a (data 2, spatial 2) mesh
    sharing the card over gloo: the row-sharded float64 det (disco, disco
    + KD) and seg steps on this data rank's 2 of 4 scenes, each held by
    rank 0 to the single-process step on the 4; the sharded predict against
    the unsharded one on this data rank's scenes, in fp32 (8 of B=16) and
    float64 (2).
    Kernel launches are counted on the sharded runs only."""
    import torch
    import torch.distributed as dist

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from v2x_sim_tpu_torch.parallel.spatial import gather_rows, take_rows
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world, SPATIAL_SIZE, rank=rank, init_method=init_method, backend="gloo",
                     device=device)
    groups = {"process_group": mesh.data_group, "spatial_group": mesh.spatial_group}
    small, batch = ({k: v for k, v in generate_batch(cfg, spec, b, seed=DP_SEED).items()
                     if k != "visible"} for b in (SPATIAL_CHECK_BATCH, BATCH))
    launches = {"pairs": 0, "periodic": 0, "matrix": 0, "forced": 0}

    def count(fn, *args):
        """fn(*args) on the sharded path, its kernel launches counted."""
        iou_cu.reset_launches()
        result = fn(*args)
        launches["pairs"] += iou_cu.rotated_iou_pairs_soa.launches
        launches["forced"] += iou_cu.forced_anchor.launches
        launches["periodic"] += iou_cu.rotated_iou_pairs_soa_periodic.launches
        launches["matrix"] += iou_cu.rotated_iou_matrix.launches
        return result

    def free():
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()

    def det(mode, opts, dtype, **g):
        kd = opts.get("kd_weight", 0.0) > 0.0
        module = DetModule(cfg, mode, dtype, mesh.device, learning_rate=DP_LR, **g, **opts)
        module.model.to(dtype)
        module.load_flax_variables(random_flax_variables(DetModel(cfg, mode, kd=kd), seed=DP_SEED))
        if kd:
            module.init_teacher_weights(DP_SEED + 1)
        return module

    def seg(dtype, **g):
        module = SegModule(cfg, "disco", dtype, mesh.device, learning_rate=DP_LR, **g)
        module.model.to(dtype)
        module.load_flax_variables(random_flax_variables(module.model, seed=DP_SEED))
        return module

    makers = {name: (lambda m=mode, o=opts, **g: det(m, o, torch.float64, **g))
              for name, mode, opts in SPATIAL_CASES}
    makers["seg"] = lambda **g: seg(torch.float64, **g)
    out = {"identical": {}, "errors": {}, "secs": {}}
    local = shard_batch(small, mesh)
    for name, make in makers.items():
        t0 = time.perf_counter()
        module = make(**groups)
        record = _dp_record(module, count(lambda: module.train_step(module.prepare_batch(local))))
        out["identical"][name] = _same_on_every_rank(record)
        del module
        free()
        dist.barrier()
        if rank == 0:  # the single-process step on the 4 scenes
            module = make()
            want = _dp_record(module, module.train_step(module.prepare_batch(small)))
            del module
            out["errors"][name] = _dp_compare(record, want)
            del want
        del record
        free()
        dist.barrier()
        out["secs"][name] = time.perf_counter() - t0

    module = det("disco", {}, torch.float32, **groups)
    out["fp32_loss"] = count(_finite_step, module, shard_batch(batch, mesh),
                             f"rank {rank}: fp32 sharded step")
    del module
    free()
    dist.barrier()

    # Predict, sharded then unsharded on the same scenes and weights. In
    # fp32 (B=16, 8 scenes a data rank) the sharded heads, gathered, against
    # the unsharded heads, and the kept sets counted: the random weights
    # give flat score regions whose exact ties the 3x3 peak filter keeps,
    # and a one-ulp change of the conv's rounding can break one. In
    # float64 (B=4) the kept sets must be equal.
    g = mesh.spatial_group

    def heads(module, scenes, sharded):
        with torch.inference_mode():
            bt = module.to_device(scenes)
            occ = module.model_input(bt)
            out = module.model(take_rows(occ, g) if sharded else occ, bt["trans"],
                               bt["agent_mask"].to(torch.bool))
            if not sharded:
                return out.cls_logits, out.reg
            return gather_rows(out.cls_logits, g), gather_rows(out.reg, g)

    out["predict"] = {}
    for dtype, scenes in ((torch.float32, shard_batch(batch, mesh)),
                          (torch.float64, shard_batch(small, mesh))):
        sharded = det("disco", {}, dtype, spatial_group=g)
        got = count(sharded.predict, scenes, MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)
        got_heads = heads(sharded, scenes, True)
        del sharded
        free()
        plain = det("disco", {}, dtype)
        want = plain.predict(scenes, MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)
        want_heads = heads(plain, scenes, False)
        del plain
        differ, d_scores, agents = [], 0.0, 0
        for b in range(want.valid.shape[0]):
            for a in range(want.valid.shape[1]):
                kg, kw = got.valid[b, a], want.valid[b, a]
                ok, ds = _same_kept_set(got.boxes[b, a][kg], got.scores[b, a][kg],
                                        want.boxes[b, a][kw], want.scores[b, a][kw])
                agents += 1
                d_scores = max(d_scores, ds)
                if not ok:
                    differ.append((b, a))
        out["predict"][str(dtype).split(".")[-1]] = {
            "differ": differ, "d_scores": d_scores, "agents": agents,
            "kept": int(want.valid.sum()),
            "d_logit": max(float((u - v).abs().max()) for u, v in zip(got_heads, want_heads))}
        del got, want, got_heads, want_heads
        free()
    out["launches"] = launches
    free()
    return out


def _spatial(device, cfg, spec, card: str) -> dict:
    """Phase 14 (d): _spatial_rank on 4 ranks sharing the card; checks and
    logs their records. Returns the sharded runs' launches, all ranks'."""
    import tempfile

    from v2x_sim_tpu_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as store:
        ranks = spawn(_spatial_rank, SPATIAL_RANKS,
                      (cfg, spec, DP_DEVICE if device.type == "cuda" else "cpu"),
                      store_dir=store, timeout=900)
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    bad = [(i, k) for i, r in enumerate(ranks) for k, same in r["identical"].items() if not same]
    if bad:
        raise AssertionError(f"ranks whose state differs from rank 0's after the sharded step: {bad}")
    shape = f"(data {SPATIAL_RANKS // SPATIAL_SIZE}, spatial {SPATIAL_SIZE})"
    rows = cfg.grid.bev_shape[0]
    for name, err in r0["errors"].items():
        log(f"[14] (d) {name}: {shape} ranks, {SPATIAL_CHECK_BATCH // 2} scenes x "
            f"{rows // SPATIAL_SIZE} of {rows} rows a rank vs 1 process x {SPATIAL_CHECK_BATCH} "
            f"scenes, float64: loss terms rel {err['loss_rel']:.2e}, Adam's first moment "
            f"{err['grad_rel']:.2e} of a leaf's max, new params {err['param_clear']:.2e} where the "
            f"gradient is clear ({err['param']:.2e} anywhere), running stats {err['stats']:.2e}; "
            f"4 ranks bit-identical; {r0['secs'][name]:.1f} s")
    pred = {k: {"differ": [(i, d) for i, r in enumerate(ranks) for d in r["predict"][k]["differ"]],
                **{q: max(r["predict"][k][q] for r in ranks) for q in ("d_scores", "d_logit")},
                **{q: sum(r["predict"][k][q] for r in ranks) for q in ("agents", "kept")}}
            for k in ("float32", "float64")}
    f32, f64 = pred["float32"], pred["float64"]
    if (not f32["d_logit"] <= LOGIT_TOL or f64["differ"] or not f64["d_scores"] <= 1e-9
            or not f64["d_logit"] <= 1e-9):
        raise AssertionError(f"sharded predict against the unsharded: {pred}")
    log(f"[14] (d) sharded predict ({MAX_BOXES} candidates, the peak filter and NMS on the "
        f"gathered heads) against the unsharded on the same scenes and weights. fp32, "
        f"{BATCH // 2} scenes a data rank: heads within {f32['d_logit']:.2e} (bound "
        f"{LOGIT_TOL}); kept sets equal at {f32['agents'] - len(f32['differ'])} of "
        f"{f32['agents']} (rank, agent) pairs"
        + (f" (not at {f32['differ']}: a tie of the random weights' flat scores broken by "
           f"rounding)" if f32["differ"] else "") + f", max |d score| of matched boxes "
        f"{f32['d_scores']:.2e}. float64, {SPATIAL_CHECK_BATCH // 2} scenes a data rank: heads "
        f"within {f64['d_logit']:.2e}, kept sets equal at all {f64['agents']} pairs "
        f"({f64['kept']} kept), scores within {f64['d_scores']:.2e} [{card}]")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("pairs", "periodic", "matrix", "forced")}
    prepares = len(SPATIAL_CASES) + 1  # a rank's sharded prepares: the float64 cases, the fp32
    if device.type == "cuda" and any(
            r["launches"]["periodic"] < 2 * prepares or r["launches"]["forced"] < prepares
            or r["launches"]["pairs"] or r["launches"]["matrix"] < 2 for r in ranks):
        raise AssertionError(f"the sharded ranks' K1/K2 launches: {[r['launches'] for r in ranks]}")
    log(f"[14] (d) kernel launches on the sharded path (all 4 ranks): {launches}; ranks "
        f"{secs:.1f} s in all")
    return launches


def phase_dp(device, cfg, spec, card: str) -> dict:
    """Phase 14: data parallelism and row sharding at Config(), TF32 off.
    (a) Two ranks sharing the card over gloo: one float64 DP step at
    B=16 (8 a rank) of disco, disco + KD and disco MGDA + use_vis, and of
    the seg model, each held to the single-process step on the same 16
    scenes; every rank's parameters, buffers and Adam moments bit-identical.
    (b) train_det --dp 1 on NCCL. (c) The row-sharded encoder and stem step
    at 2 ranks. (d) The whole model row-sharded on 4 ranks. Returns the
    launches."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.parallel.mesh import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as store:
        ranks = spawn(_dp_rank, DP_RANKS,
                      (cfg, spec, BATCH, DP_DEVICE if device.type == "cuda" else "cpu"),
                      store_dir=store, timeout=900)
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    bad = [(i, k) for i, r in enumerate(ranks) for k, same in r["identical"].items() if not same]
    if bad:
        raise AssertionError(f"ranks whose state differs from rank 0's after the DP step: {bad}")
    where = "the card" if device.type == "cuda" else "the CPU"
    for name, err in r0["errors"].items():
        log(f"[14] (a) {name}: {DP_RANKS} ranks x {BATCH // DP_RANKS} scenes vs 1 process x "
            f"{BATCH}, float64, on {where}: "
            f"loss terms rel {err['loss_rel']:.2e}, mgda_w {err['mgda_w']:.2e}, Adam's first moment "
            f"{err['grad_rel']:.2e} of a leaf's max, new params {err['param_clear']:.2e} where the "
            f"gradient is clear ({err['param']:.2e} anywhere), running stats {err['stats']:.2e}; "
            f"ranks bit-identical; {r0['secs'][name]:.1f} s")
    sp = r0["spatial"]
    rows = sp.pop("rows")
    if max(sp.values()) > SPATIAL_TOL or not all(np.isfinite(list(r["spatial"].values())).all()
                                                  for r in ranks):
        raise AssertionError(f"row-sharded encoder / stem step against the unsharded: {sp}")
    log(f"[14] (c) row-sharded encoder, {DP_RANKS} ranks x {rows // DP_RANKS} of {rows} rows, "
        f"5 stages, float64: "
        f"{sp['encoder']:.2e} of each level's max from the unsharded STPNEncoder; stem SGD step: "
        f"loss rel {sp['stem_loss']:.2e}, state {sp['stem_state']:.2e}; ranks {secs:.1f} s in all")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ("pairs", "periodic", "forced")}
    if device.type == "cuda":
        tool = _dp_tool(card)
        launches = {k: launches[k] + tool[k] for k in launches}
        per_rank = len(DP_CASES) + 1  # prepares a rank: the DP cases and the fp32 step
        if any(r["launches"]["periodic"] < 2 * per_rank or r["launches"]["forced"] < per_rank
               or r["launches"]["pairs"] for r in ranks):
            raise AssertionError(f"the ranks' K1/K2 launches: {[r['launches'] for r in ranks]}")
    log(f"[14] kernel launches (both ranks, and the --dp 0 run of (b)): {launches}")
    sharded = _spatial(device, cfg, spec, card)
    launches = {"matrix": sharded["matrix"],
                **{k: launches[k] + sharded[k] for k in ("pairs", "periodic", "forced")}}
    return {"launches": launches}


BF16_FACTOR = 1.25  # card bf16 vs CPU fp32, against the port's CPU bf16 vs CPU fp32
NUSC_FRAMES = 2  # phase 15's nuScenes-format root: 1 scene x 2 frames


def _dist(u, v):
    """(max, mean) of |u - v| in float64."""
    d = (u.double() - v.double()).abs()
    return float(d.max()), float(d.mean())


def _layouts_vs_cpu(device, cfg, batch, card: str) -> dict:
    """Phase 15 (a): the dense and flat layouts on the card against the
    CPU for one scene, and the dense loss against the sparse one."""
    import torch

    from v2x_sim_tpu_torch.ops.anchors import anchor_grid
    from v2x_sim_tpu_torch.ops.assign import assign_targets_batched
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.utils.losses import smooth_l1_loss_sparse_sum, smooth_l1_loss_sum

    total = {"matrix": 0, "pairs": 0, "periodic": 0, "forced": 0}
    gt, mask = torch.from_numpy(batch["gt_boxes"][0]), torch.from_numpy(batch["gt_mask"][0])
    anchors = torch.from_numpy(anchor_grid(cfg))
    thr = torch.tensor([cfg.anchors.neg_iou_threshold, cfg.anchors.pos_iou_threshold])
    for flat in (False, True):
        want = assign_targets_batched(gt, mask, anchors, cfg, flat=flat)
        iou_cu.reset_launches()
        got = assign_targets_batched(gt.to(device), mask.to(device), anchors.to(device), cfg,
                                     flat=flat)
        torch.cuda.synchronize()
        launches = _launches()
        for key in total:
            total[key] += launches[key]
        if (launches["periodic"] != 2 or launches["forced"] != 1 or launches["pairs"]
                or launches["matrix"]):
            raise AssertionError(f"flat={flat}: launched {launches}: want periodic 2, forced 1, "
                                 f"pairs 0")
        got = [t.cpu() for t in got]
        near = ((want.best_iou[..., None] - thr).abs() <= NEAR_THRESHOLD).any(-1)
        differ = got[0] != want.labels
        if bool((differ & ~near).any()):
            raise AssertionError(f"flat={flat}: labels differ card vs CPU away from the thresholds")
        same = ~differ
        reg_g, reg_w = got[1], want.reg_targets
        if flat:  # field-major (B, 6, n)
            reg_g, reg_w = reg_g.transpose(1, 2), reg_w.transpose(1, 2)
        reg_err = float((reg_g[same] - reg_w[same]).abs().max())
        iou_err = float((got[3] - want.best_iou).abs().max())
        if (reg_err > REG_TOL or iou_err > IOU_TOL
                or not torch.equal(got[2][same], want.reg_mask[same])):
            raise AssertionError(f"flat={flat}: targets card vs CPU: reg {reg_err:.2e}, best_iou "
                                 f"{iou_err:.2e}, or reg_mask")
        log(f"[15] (a) assign_targets_batched(flat={flat}) on the card, one scene of "
            f"{gt.shape[0]} agents: launches {launches}; {int((want.labels == 1).sum())} positives; "
            f"vs the CPU: {int(differ.sum())} labels differ (all within {NEAR_THRESHOLD} of a "
            f"threshold), reg {reg_err:.2e}, best_iou {iou_err:.2e} [{card}]")

    module = DetModule(cfg, "disco", device=device)
    bt = module.to_device({k: batch[k][:1] for k in ("gt_boxes", "gt_mask")})
    iou_cu.reset_launches()
    full = module.targets_from_gt(bt["gt_boxes"], bt["gt_mask"])
    prep = module.targets(bt)
    torch.cuda.synchronize()
    for key, n in _launches().items():
        total[key] += n
    if int(prep["overflow"].sum()):
        raise AssertionError("the scene overflows the sparse capacity: dense and sparse differ")
    b, a, h, w, k = full.labels.shape
    gen = torch.Generator(device=device).manual_seed(15)
    pred = 0.2 * torch.randn((b, a, h, w, k, 6), generator=gen, device=device)
    dense, dense_n = smooth_l1_loss_sum(pred, full.reg_targets, full.reg_mask)
    sparse, sparse_n = smooth_l1_loss_sparse_sum(pred.reshape(b, a, h * w, k * 6), prep["reg_cell"],
                                                 prep["reg_lane"], prep["reg_sp_t"], prep["reg_sp_w"])
    rel = abs(float(dense) - float(sparse)) / abs(float(sparse))
    if float(dense_n) != float(sparse_n) or rel > 1e-5:
        raise AssertionError(f"dense loss {float(dense)} ({float(dense_n)}) vs sparse "
                             f"{float(sparse)} ({float(sparse_n)})")
    log(f"[15] (a) dense vs sparse smooth-L1 on the card over {int(dense_n)} positives: "
        f"{float(dense):.6f} vs {float(sparse):.6f} (rel {rel:.2e}, tol 1e-5) [{card}]")
    del module, bt, full, prep, pred
    torch.cuda.empty_cache()
    return total


def _bf16_vs_fp32(device, cfg, variables, batch, card: str) -> None:
    """Phase 15 (b): one scene's bf16 forward on the card against the
    CPU's fp32, held to 1.25 x the port's own CPU bf16 distance."""
    import torch

    from v2x_sim_tpu_torch.bridge import random_flax_variables
    from v2x_sim_tpu_torch.models.seg.unet import SegModel
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    scene = {k: v[:1] for k, v in batch.items()}
    seg_variables = random_flax_variables(SegModel(cfg, "disco"), seed=40)
    runs = {}
    for where, dev, dtype in (("cpu fp32", "cpu", torch.float32), ("cpu bf16", "cpu", torch.bfloat16),
                              ("card bf16", device, torch.bfloat16)):
        det = DetModule(cfg, "disco", dtype, device=dev)
        det.load_flax_variables(variables)
        bt = det.to_device(scene)
        occ, am = det.model_input(bt), bt["agent_mask"].to(torch.bool)
        seg = SegModule(cfg, "disco", dtype, device=dev)
        seg.load_flax_variables(seg_variables)
        sp = seg.prepare_batch(scene)
        with torch.no_grad():
            runs[where] = {
                "predict logits": det.model(occ, bt["trans"], am).cls_logits,
                "train-mode logits": det.model(occ, bt["trans"], am, train=True).cls_logits,
                "seg logits": seg.model(sp["occupancy"], sp["trans"], sp["agent_mask"].to(torch.bool)).logits,
                "seg train-mode logits": seg.model(sp["occupancy"], sp["trans"],
                                                   sp["agent_mask"].to(torch.bool), train=True).logits,
            }
            runs[where] = {k: v.float().cpu() for k, v in runs[where].items()}
        del det, seg, bt, occ, sp
    torch.cuda.empty_cache()
    for name, ref in runs["cpu fp32"].items():
        own = _dist(runs["cpu bf16"][name], ref)
        got = _dist(runs["card bf16"][name], ref)
        allowed = tuple(BF16_FACTOR * o for o in own)
        line = (f"{name}: card bf16 vs CPU fp32 {got[0]:.4f}/{got[1]:.5f} (max/mean; allowed "
                f"{allowed[0]:.4f}/{allowed[1]:.5f} = {BF16_FACTOR} x the CPU bf16's "
                f"{own[0]:.4f}/{own[1]:.5f})")
        if not (got[0] <= allowed[0] and got[1] <= allowed[1]):
            raise AssertionError(f"bf16 on the card, one scene, disco: {line}")
        log(f"[15] (b) one scene, disco, TF32 off: {line} [{card}]")


def _nuscenes_root_tools(cfg, card: str) -> dict:
    """Phase 15 (c): a nuScenes-format root from the port's writer, then
    create_data_det, train_det (1 step), test_det and create_data_seg on
    it."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.datasets.nuscenes_writer import write_synthetic_nuscenes
    from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec
    from v2x_sim_tpu_torch.ops.cuda import iou_cu
    from v2x_sim_tpu_torch.tools import create_data_det, create_data_seg, test_det, train_det

    total = {"matrix": 0, "pairs": 0, "periodic": 0, "forced": 0}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "nusc")
        write_synthetic_nuscenes(root, cfg, SyntheticSpec(points_per_agent=8192, max_gt=32),
                                 num_scenes=1, frames_per_scene=NUSC_FRAMES, seed=15)
        steps = (
            ("create_data_det", create_data_det, ["--root", root, "--split", "all", "--targets", "1",
                                                  "--savepath", os.path.join(tmp, "det")]),
            ("train_det", train_det, ["--data", root, "--com", "disco", "--batch", str(NUSC_FRAMES),
                                      "--nepoch", "1", "--batches_per_epoch", "1",
                                      "--logpath", os.path.join(tmp, "run")]),
            ("test_det", test_det, ["--data", root, "--com", "disco", "--batch", str(NUSC_FRAMES),
                                    "--num_batches", "1", "--resume", "auto",
                                    "--logpath", os.path.join(tmp, "run")]),
            ("create_data_seg", create_data_seg, ["--root", root, "--split", "all",
                                                  "--savepath", os.path.join(tmp, "seg")]),
        )
        for name, tool, argv in steps:
            iou_cu.reset_launches()
            result, secs = _run_tool(tool, argv, tag="[15]")
            torch.cuda.synchronize()
            launches = _launches()
            for key in total:
                total[key] += launches[key]
            if name.startswith("create_data"):
                ok, what = result == NUSC_FRAMES, f"{result} frames"
                if name == "create_data_det":
                    ok &= (launches["periodic"] == 2 * NUSC_FRAMES
                           and launches["forced"] == NUSC_FRAMES and not launches["pairs"])
            elif name == "train_det":
                loss = float(result.metrics["loss"])
                ok, what = result.step == 1 and np.isfinite(loss), f"step {result.step}, loss {loss:.4f}"
                ok &= launches["periodic"] == 2
            else:
                what = ", ".join(f"{k} {v:.4f}" for k, v in result.metrics.items()
                                 if k.startswith("mAP"))
                ok = launches["matrix"] > 0 and all(np.isfinite(v) for v in result.metrics.values()
                                                    if isinstance(v, float))
            if not ok:
                raise AssertionError(f"{name} on the nuScenes-format root: {what}, launches {launches}")
            log(f"[15] (c) {name} on a 1 x {NUSC_FRAMES}-frame root of the port's writer: {what}; "
                f"launches {launches}; {secs:.1f} s [{card}]")
    return total


def _reference_pth(device, cfg, variables, batch, card: str) -> None:
    """Phase 15 (d): the card model saved as the reference's .pth and
    reloaded through train/torch_convert.py gives bit-equal logits."""
    import tempfile

    import torch

    from v2x_sim_tpu_torch.train import torch_convert
    from v2x_sim_tpu_torch.train.det_module import DetModule

    module = DetModule(cfg, "disco", device=device)
    module.load_flax_variables(variables)
    again = DetModule(cfg, "disco", device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pth")
        torch.save({"model_state_dict": module.model.state_dict(), "epoch": 0}, path)
        torch_convert.load_reference(again.model, path)
    bt = module.to_device({k: v[:1] for k, v in batch.items()})
    occ, am = module.model_input(bt), bt["agent_mask"].to(torch.bool)
    with torch.no_grad():
        want = module.model(occ, bt["trans"], am).cls_logits
        got = again.model(occ, bt["trans"], am).cls_logits
    if not torch.equal(got, want):
        raise AssertionError(f"reloaded .pth logits differ by {float((got - want).abs().max()):.3e}")
    log(f"[15] (d) the card model saved as {{'model_state_dict': ...}} and reloaded through "
        f"torch_convert.load_reference: one scene's logits bit-equal [{card}]")


def phase_bf16_host(device, cfg, variables, batch, card: str) -> dict:
    """Phase 15: the dense and flat anchor-target layouts, bf16 against
    fp32, a nuScenes-format root of the port's writer through the tools,
    and the reference's .pth."""
    launches = _layouts_vs_cpu(device, cfg, batch, card)
    _bf16_vs_fp32(device, cfg, variables, batch, card)
    for key, n in _nuscenes_root_tools(cfg, card).items():
        launches[key] += n
    _reference_pth(device, cfg, variables, batch, card)
    return {"launches": launches}


#: Phase 16: the keys of the bench's JSON line (the JAX bench's, plus the
#: reference graph's own rate on the card), and the bench subprocess's time
#: limit.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "tflops", "mfu_pct",
              "train_scenes_per_sec", "train_tflops", "train_mfu_pct",
              "train_e2e_scenes_per_sec", "train_cached_scenes_per_sec",
              "baseline_scenes_per_sec")
BENCH_TIMEOUT_S = 600
ENTRY_TOL = 1e-4  # entry()'s logits and regression, card vs CPU (fp32, TF32 off)
DRYRUN_RANKS = 4
DRYRUN_LINES = ("dryrun disco+kd ok:", "dryrun mgda ok:", "dryrun gspmd dp x spatial ok:",
                "dryrun seg dp ok:", "dryrun gspmd seg dp x spatial ok:")


def _bench(card: str) -> None:
    """Phase 16 (a): ``python bench_torch.py --run`` in a subprocess bounded
    by BENCH_TIMEOUT_S (the measurement without main()'s preflight and
    wrapping subprocess); its line's keys and ranges, and its launches."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), "--run"],
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, cwd=ROOT)
    for line in proc.stderr.strip().splitlines():
        log(f"[16]   | {line}")
    lines = proc.stdout.strip().splitlines()
    log(f"[16]   | {lines[-1] if lines else '(no stdout)'}")
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}")
    rec = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in rec]
    if missing or "error" in rec:
        raise AssertionError(f"the bench's line lacks {missing} or has an error: {rec}")
    rates = ("value", "train_scenes_per_sec", "train_e2e_scenes_per_sec",
             "train_cached_scenes_per_sec", "baseline_scenes_per_sec", "vs_baseline")
    if not all(rec[k] > 0 for k in rates):
        raise AssertionError(f"a rate of the bench is not positive: {rec}")
    if not all(0 < rec[k] <= 100 for k in ("mfu_pct", "train_mfu_pct")):
        raise AssertionError(f"an MFU share of the bench lies outside (0, 100]: {rec}")
    launch_line = [ln for ln in proc.stderr.splitlines() if "kernel launches" in ln]
    launches = json.loads(launch_line[-1].split("kernel launches ")[1].split(";")[0])
    if not (launches["matrix"] >= 1 and launches["forced"] >= 1 and launches["periodic"] >= 2
            and launches["pairs"] == 0):
        raise AssertionError(f"the bench's path did not go through the kernels: {launches}")
    log(f"[16] (a) bench_torch.py --run: {time.perf_counter() - t0:.1f} s, rc 0, all "
        f"{len(BENCH_KEYS)} keys; vs_baseline {rec['vs_baseline']:.4f} over the reference graph's "
        f"{rec['baseline_scenes_per_sec']:.2f} scenes/s; mfu_pct {rec['mfu_pct']:.4f}, "
        f"train_mfu_pct {rec['train_mfu_pct']:.4f}; launches {launches} [{card}]")


def _entry_vs_cpu(card: str) -> None:
    """Phase 16 (b): ``graft_entry.entry()`` on the card against the CPU."""
    import torch

    from v2x_sim_tpu_torch.graft_entry import entry

    fn, args = entry()
    cfn, cargs = entry(device="cpu")
    if not torch.equal(args[1].cpu(), cargs[1]):
        raise AssertionError("entry()'s occupancy differs between the card and the CPU")
    got, want = fn(*args), cfn(*cargs)
    errs = [float((g.float().cpu() - w).abs().max()) for g, w in zip(got, want)]
    log(f"[16] (b) entry(): cls_logits {tuple(got[0].shape)} and reg {tuple(got[1].shape)}, "
        f"card vs CPU max |d| {errs[0]:.3e} and {errs[1]:.3e} (bound {ENTRY_TOL}) [{card}]")
    if not all(bool(torch.isfinite(g).all()) for g in got) or max(errs) > ENTRY_TOL:
        raise AssertionError(f"entry() on the card is {errs} from the CPU")


def _dryrun(card: str) -> None:
    """Phase 16 (c): ``graft_entry.dryrun_multichip`` on DRYRUN_RANKS gloo
    ranks sharing the card; all five variants' lines."""
    import contextlib
    import io

    from v2x_sim_tpu_torch.graft_entry import dryrun_multichip

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(DRYRUN_RANKS)
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"[16]   | {line}")
    missing = [want for want in DRYRUN_LINES if not any(ln.startswith(want) for ln in lines)]
    if missing:
        raise AssertionError(f"dryrun_multichip({DRYRUN_RANKS}) printed no {missing}")
    log(f"[16] (c) dryrun_multichip({DRYRUN_RANKS}): all {len(DRYRUN_LINES)} variants stepped, "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def phase_bench_entry(card: str) -> None:
    """Phase 16: the root entry points' counterparts: the bench, the
    flagship forward and the multi-device dry run."""
    _bench(card)
    _entry_vs_cpu(card)
    _dryrun(card)


BN_SUM_RTOL = 1e-5  # a pass's float32 sums against the plain version's, of |terms|


def _bn_step_shapes(device, cfg, variables, batch, card: str) -> list:
    """Phase 17's launch counts: one bf16 disco train step at B (18
    launches of each pass) and a bf16 eval forward (18 of normalize_relu,
    none of the others); returns the shapes of the step's BatchNorm maps
    in call order."""
    import torch

    from v2x_sim_tpu_torch.ops.cuda import bn_cu
    from v2x_sim_tpu_torch.train.det_module import DetModule

    module = DetModule(cfg, "disco", torch.bfloat16, device=device)
    module.load_flax_variables(variables)
    prepared = module.prepare_batch(batch)
    shapes = []
    fused = bn_cu.batch_norm_relu

    def recording(x, *args):
        shapes.append(tuple(x.shape))
        return fused(x, *args)

    bn_cu.reset_launches()
    bn_cu.batch_norm_relu = recording
    try:
        metrics = module.train_step(prepared)
    finally:
        bn_cu.batch_norm_relu = fused
    torch.cuda.synchronize()
    step = bn_cu.launches()
    if step != {name: 18 for name in step} or len(shapes) != 18:
        raise AssertionError(f"a bf16 train step launched {step} over {len(shapes)} maps, not 18 "
                             "of each pass")
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError("non-finite bf16 training loss")
    bn_cu.reset_launches()
    with torch.no_grad():
        module.model(prepared["occupancy"], prepared["trans"],
                     prepared["agent_mask"].to(torch.bool))
    torch.cuda.synchronize()
    evaluated = bn_cu.launches()
    if evaluated != {**{name: 0 for name in evaluated}, "normalize_relu": 18}:
        raise AssertionError(f"a bf16 eval forward launched {evaluated}, not 18 normalize_relu")
    log(f"[17] a bf16 disco train step at B={batch['points'].shape[0]} launched {step} "
        f"(synchronized), an eval forward {evaluated}; maps (N, C, H, W): {shapes} [{card}]")
    del module, prepared, metrics
    torch.cuda.empty_cache()
    return shapes


def phase_batchnorm(device, cfg, variables, batch, card: str) -> dict:
    """Phase 17: the fused BatchNorm's passes at a bf16 train step's shapes,
    held once to their plain versions and timed beside their byte bounds,
    the plain versions and the unfused layer. Returns each pass's step
    totals and its largest gap from the plain version for the record."""
    import collections

    import torch

    from v2x_sim_tpu_torch.models.backbone import BN_MOMENTUM, _bn
    from v2x_sim_tpu_torch.ops.cuda import bn_cu

    shapes = _bn_step_shapes(device, cfg, variables, batch, card)
    passes = tuple(bn_cu.PASS_BYTES)
    total = {p: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for p in passes}
    layer = {"fused_fwd": 0.0, "fused_bwd": 0.0, "unfused_fwd": 0.0, "unfused_bwd": 0.0}
    err = {p: 0.0 for p in passes}
    for (n, c, h, w), mult in collections.Counter(shapes).items():
        gen = torch.Generator(device=device).manual_seed(c)
        loc = torch.randn(c, device=device, generator=gen) * 0.8
        scale = torch.rand(c, device=device, generator=gen) * 1.7 + 0.3
        x = (torch.randn(n, h, w, c, device=device, generator=gen) * scale + loc).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        dy = torch.randn(n, h, w, c, device=device, generator=gen).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        weight = torch.rand(c, device=device, generator=gen) + 0.5
        bias = torch.randn(c, device=device, generator=gen) * 0.3
        count = n * h * w

        # Each pass once against its plain version: outputs bit-equal, the
        # float32 sums within BN_SUM_RTOL of their terms' magnitudes.
        stats = bn_cu.moments(x)
        xf = x.float()
        gap = (stats - bn_cu.moments_plain(x)).abs()
        mag = torch.stack([xf.abs().mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
        mean, msq = stats.unbind()
        rstd = torch.rsqrt((msq - mean * mean).clamp(min=0.0) + 1e-5)
        inv = weight * rstd
        y = bn_cu.normalize_relu(x, mean, inv, bias)
        y_gap = (y.float() - bn_cu.normalize_relu_plain(x, mean, inv, bias).float()).abs().max()
        sums = bn_cu.backward_reduce(dy, y, x, mean)
        g = bn_cu._relu_grad(dy, y)
        gap_b = (sums - bn_cu.backward_reduce_plain(dy, y, x, mean)).abs()
        mag_b = torch.stack([g.abs().sum((0, 2, 3)),
                             (g * (xf - mean[:, None, None])).abs().sum((0, 2, 3))])
        del g, xf
        c1 = (sums[0] / count).contiguous()
        c2 = torch.where(msq - mean * mean >= 0, rstd * rstd * sums[1] / count, 0.0)
        dx = bn_cu.backward_dx(dy, y, x, mean, inv, c1, c2)
        dx_plain = bn_cu.backward_dx_plain(dy, y, x, mean, inv, c1, c2)
        dx_gap = (dx.float() - dx_plain.float()).abs().max()
        worst = max(float((gap / mag).max()), float((gap_b / mag_b).max()))
        for p, e in (("moments", gap.max()), ("normalize_relu", y_gap),
                     ("backward_reduce", gap_b.max()), ("backward_dx", dx_gap)):
            err[p] = max(err[p], float(e))
        if not (float(y_gap) == 0.0 and float(dx_gap) == 0.0 and worst <= BN_SUM_RTOL):
            raise AssertionError(f"bn passes at {(n, c, h, w)} against plain: normalize_relu "
                                 f"max |d| {float(y_gap)}, backward_dx {float(dx_gap)}, sums "
                                 f"{worst:.2e} of their terms (limit {BN_SUM_RTOL})")
        del sums, dx, dx_plain, stats, gap, gap_b, mag, mag_b
        calls = {
            "moments": (lambda: bn_cu.moments(x), lambda: bn_cu.moments_plain(x)),
            "normalize_relu": (lambda: bn_cu.normalize_relu(x, mean, inv, bias),
                               lambda: bn_cu.normalize_relu_plain(x, mean, inv, bias)),
            "backward_reduce": (lambda: bn_cu.backward_reduce(dy, y, x, mean),
                                lambda: bn_cu.backward_reduce_plain(dy, y, x, mean)),
            "backward_dx": (lambda: bn_cu.backward_dx(dy, y, x, mean, inv, c1, c2),
                            lambda: bn_cu.backward_dx_plain(dy, y, x, mean, inv, c1, c2)),
        }
        row = []
        for p, (kernel, plain) in calls.items():
            ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 3, warmup=1)
            bound_ms = bn_cu.PASS_BYTES[p] * x.numel() / PEAK_HBM_BYTES * 1e3
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                total[p][key] += mult * v
            row.append(f"{p} {ms:.4f} ms (bound {bound_ms:.4f}, {100 * bound_ms / ms:.1f}%; "
                       f"plain {plain_ms:.3f})")
        del y

        # The whole layer: the Function (its small (C,) ops included) and
        # the unfused PyTorch layer, forward and backward under autograd.
        bn = torch.nn.BatchNorm2d(c, eps=1e-5).to(device)
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        xg = x.clone().requires_grad_(True)
        forms = {
            "fused": lambda: bn_cu.batch_norm_relu(xg, bn.weight, bn.bias, bn.running_mean,
                                                   bn.running_var, bn.eps, BN_MOMENTUM),
            "unfused": lambda: torch.relu(_bn(xg, bn, True)),
        }
        times = {}
        for form, fwd in forms.items():
            times[f"{form}_fwd"] = time_ms(fwd, 5)
            out = fwd()
            times[f"{form}_bwd"] = time_ms(lambda: torch.autograd.grad(
                out, (xg, bn.weight, bn.bias), dy, retain_graph=True), 5)
            del out
            torch.cuda.empty_cache()
        for key, v in times.items():
            layer[key] += mult * v
        log(f"[17] ({n}, {c}, {h}, {w}) x{mult}: {'; '.join(row)}; the layer fused fwd "
            f"{times['fused_fwd']:.3f} / bwd {times['fused_bwd']:.3f} ms, unfused fwd "
            f"{times['unfused_fwd']:.3f} / bwd {times['unfused_bwd']:.3f} ms [{card}]")
        del x, dy, xg, bn, mean, msq, rstd, inv, c1, c2
        torch.cuda.empty_cache()
    kernels = sum(t["ms"] for t in total.values())
    bound = sum(t["bound_ms"] for t in total.values())
    log(f"[17] a step's 18 layers: the four passes {kernels:.3f} ms against the byte bound "
        f"{bound:.3f} ms ({100 * bound / kernels:.1f}%; "
        + ", ".join(f"{p} {t['ms']:.3f}/{t['bound_ms']:.3f}" for p, t in total.items())
        + f"); the Function fwd {layer['fused_fwd']:.3f} + bwd {layer['fused_bwd']:.3f} ms, "
        f"the unfused layer fwd {layer['unfused_fwd']:.3f} + bwd {layer['unfused_bwd']:.3f} ms "
        f"[{card}]")
    return {"passes": total, "layer": layer, "err": err, "launches": {p: 18 for p in passes}}


def _upsample_stages(cfg, batch: int) -> list:
    """(N, C, h, w, Cs) of the decoder's four stage inputs at ``batch``
    scenes: x the deeper stage's map, its skip Cs channels at twice h, w."""
    from v2x_sim_tpu_torch.models.backbone import STAGE_CHANNELS

    n, size = batch * cfg.num_agents, cfg.grid.grid_shape[0]
    deep = len(STAGE_CHANNELS) - 1
    return [(n, STAGE_CHANNELS[s], size >> s, size >> s, STAGE_CHANNELS[s - 1])
            for s in range(deep, 0, -1)]


def _upsample_main_path(device, cfg, variables, batch, card: str) -> dict:
    """Phase 18's launch counts on the main path: one bf16 disco train step
    at B (4 of each entry, one a decoder stage) and one bf16 predict (4
    forward), each counted from zero and synchronized. Returns the step's
    counts and the predict's forward count."""
    import torch

    from v2x_sim_tpu_torch.ops.cuda import upsample_cu
    from v2x_sim_tpu_torch.train.det_module import DetModule

    module = DetModule(cfg, "disco", torch.bfloat16, device=device)
    module.load_flax_variables(variables)
    prepared = module.prepare_batch(batch)
    upsample_cu.reset_launches()
    metrics = module.train_step(prepared)
    torch.cuda.synchronize()
    step = upsample_cu.launches()
    if step != {"forward": 4, "backward": 4}:
        raise AssertionError(f"a bf16 train step launched {step}, not 4 of each entry")
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError("non-finite bf16 training loss")
    upsample_cu.reset_launches()
    module.predict({k: batch[k] for k in ("points", "point_mask", "trans", "agent_mask")},
                   MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)
    torch.cuda.synchronize()
    predict = upsample_cu.launches()
    if predict != {"forward": 4, "backward": 0}:
        raise AssertionError(f"a bf16 predict launched {predict}, not 4 forward")
    log(f"[18] a bf16 disco train step at B={batch['points'].shape[0]} launched {step}, a bf16 "
        f"predict {predict} (each from zero, synchronized) [{card}]")
    del module, prepared, metrics
    torch.cuda.empty_cache()
    return {"forward": step["forward"] + predict["forward"], "backward": step["backward"]}


def phase_upsample(device, cfg, variables, batch, card: str) -> dict:
    """Phase 18: the fused upsample and concatenation's launches on the
    main path, then at a B=16 call's stage inputs, held once to its plain
    versions and timed beside its byte bounds, the plain versions and the
    two ops. Returns each entry's totals, its largest gap from the plain
    version and its main-path launches for the record."""
    import torch

    from v2x_sim_tpu_torch.models.backbone import upsample_bilinear
    from v2x_sim_tpu_torch.ops.cuda import upsample_cu

    launches = _upsample_main_path(device, cfg, variables, batch, card)
    entries = tuple(upsample_cu.PASS_ELEMENTS)
    total = {e: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for e in entries}
    layer = {"fused_fwd": 0.0, "fused_bwd": 0.0, "ops_fwd": 0.0, "ops_bwd": 0.0}
    err = {e: 0.0 for e in entries}
    for n, c, h, w, cs in _upsample_stages(cfg, BATCH):
        gen = torch.Generator(device=device).manual_seed(c)
        x = torch.randn(n, h, w, c, device=device, generator=gen).to(torch.bfloat16)
        skip = torch.randn(n, 2 * h, 2 * w, cs, device=device, generator=gen).to(torch.bfloat16)
        dy = torch.randn(n, 2 * h, 2 * w, c + cs, device=device, generator=gen).to(torch.bfloat16)
        x, skip, dy = (t.permute(0, 3, 1, 2) for t in (x, skip, dy))

        # Both entries once against their plain versions (bit-equal), the
        # forward also against upsample + cat, the backward run to run.
        out = upsample_cu.forward(x, skip)
        d_fwd = float((out.float() - upsample_cu.forward_plain(x, skip).float()).abs().max())
        same_ops = torch.equal(out, torch.cat([upsample_bilinear(x, (2 * h, 2 * w)), skip], 1))
        dx, again = upsample_cu.backward(dy, c), upsample_cu.backward(dy, c)
        d_bwd = float((dx.float() - upsample_cu.backward_plain(dy, c).float()).abs().max())
        same_runs = torch.equal(dx.view(torch.int16), again.view(torch.int16))
        err = {"forward": max(err["forward"], d_fwd), "backward": max(err["backward"], d_bwd)}
        if not (d_fwd == 0.0 and same_ops and d_bwd == 0.0 and same_runs):
            raise AssertionError(f"upsample at {(n, c, h, w, cs)}: forward max |d| from plain "
                                 f"{d_fwd}, equal to upsample + cat {same_ops}; backward max |d| "
                                 f"from plain {d_bwd}, equal run to run {same_runs}")
        del out, dx, again
        calls = {
            "forward": (lambda: upsample_cu.forward(x, skip),
                        lambda: upsample_cu.forward_plain(x, skip)),
            "backward": (lambda: upsample_cu.backward(dy, c),
                         lambda: upsample_cu.backward_plain(dy, c)),
        }
        row = []
        for e, (kernel, plain) in calls.items():
            ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 3, warmup=1)
            bound_ms = 2 * upsample_cu.PASS_ELEMENTS[e] * x.numel() / PEAK_HBM_BYTES * 1e3
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                total[e][key] += v
            row.append(f"{e} {ms:.4f} ms (bound {bound_ms:.4f}, {100 * bound_ms / ms:.1f}%; "
                       f"plain {plain_ms:.3f})")

        # The whole stage input under autograd: the Function, and the
        # upsample and cat it replaces.
        xg, sg = x.clone().requires_grad_(True), skip.clone().requires_grad_(True)
        forms = {
            "fused": lambda: upsample_cu.UpsampleCat.apply(xg, sg),
            "ops": lambda: torch.cat([upsample_bilinear(xg, (2 * h, 2 * w)), sg], 1),
        }
        times = {}
        for form, fwd in forms.items():
            times[f"{form}_fwd"] = time_ms(fwd, 10)
            out = fwd()
            times[f"{form}_bwd"] = time_ms(lambda: torch.autograd.grad(
                out, (xg, sg), dy, retain_graph=True), 10)
            del out
        for key, v in times.items():
            layer[key] += v
        log(f"[18] ({n}, {c}, {h}, {w}) + skip {cs}: {'; '.join(row)}; the stage input fused "
            f"fwd {times['fused_fwd']:.3f} / bwd {times['fused_bwd']:.3f} ms, upsample + cat "
            f"fwd {times['ops_fwd']:.3f} / bwd {times['ops_bwd']:.3f} ms [{card}]")
        del x, skip, dy, xg, sg
        torch.cuda.empty_cache()
    log(f"[18] the four stage inputs: "
        + ", ".join(f"{e} {t['ms']:.4f} ms against the byte bound {t['bound_ms']:.4f} "
                    f"({100 * t['bound_ms'] / t['ms']:.1f}%)" for e, t in total.items())
        + f"; the Function fwd {layer['fused_fwd']:.3f} + bwd {layer['fused_bwd']:.3f} ms, "
        f"upsample + cat fwd {layer['ops_fwd']:.3f} + bwd {layer['ops_bwd']:.3f} ms [{card}]")
    return {"entries": total, "layer": layer, "err": err, "launches": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one card.")
    parser.add_argument("--baseline", type=Path, help="another version of csrc/rotated_iou.cu "
                        "(same C entry points) to time against this one on the main path's operands")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from v2x_sim_tpu_torch.bridge import random_flax_variables
        from v2x_sim_tpu_torch.configs.config import Config
        from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec
        from v2x_sim_tpu_torch.models.det.net import DetModel
        from v2x_sim_tpu_torch.ops.cuda import build, iou_cu
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this script: {e}", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    cfg = Config()  # production geometry: 256x256x13, 6 agents, fusion at stage 3
    spec = SyntheticSpec(points_per_agent=8192, num_vehicles=12, max_gt=32)
    t_run = time.perf_counter()

    def timed(name, fn, *fargs):
        t0 = time.perf_counter()
        result = fn(*fargs)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return result

    timed("build", phase_build)
    base = None
    if args.baseline is not None:
        path = args.baseline.resolve()
        base = iou_cu.declare(build.load(path.stem, path.parent))
        log(f"[1] baseline {args.baseline} built")
    k = timed("kernels", phase_kernel, device, card, BATCH * cfg.num_agents, 1 << 20,
              spec.max_gt * cfg.anchors.num_anchors)

    variables = random_flax_variables(DetModel(cfg, "disco"), seed=0)
    main_path = timed("predict", phase_main_path, device, cfg, spec, BATCH, variables, card, base)
    predict_launches, nms = main_path["launches"], main_path["nms_matrix"]
    predict_batch = main_path["batches"][0]
    del main_path
    train = timed("train", phase_train, device, cfg, spec, BATCH, variables)
    assign = timed("assign kernels", phase_assign_kernels, device, cfg, train["batch"], card, base)
    per = {key: float(np.mean([c[key] for c in assign["periodic"]]))
           for key in ("ms", "plain_ms", "bound_ms")}
    timed("modes", phase_modes, device, cfg, predict_batch, card)
    late = timed("late fusion", phase_late_fusion, device, cfg, variables, predict_batch, card)
    timed("kd", phase_kd, device, cfg, variables, train["batch"], card)
    flow = timed("workflow", phase_workflow, device, cfg, card)
    bake = flow["bake"]
    timed("seg", phase_seg, device, cfg, spec, BATCH, card)
    vis = timed("vis, MGDA, track", phase_vis_mgda_track, device, cfg, spec, card)["launches"]
    tools = timed("tools", phase_tools, device, card)["launches"]
    dp = timed("dp", phase_dp, device, cfg, spec, card)["launches"]
    p15 = timed("bf16, layouts, nuScenes, pth", phase_bf16_host, device, cfg, variables,
                train["batch"], card)["launches"]
    timed("bench, entry, dry run", phase_bench_entry, card)
    bn = timed("batchnorm", phase_batchnorm, device, cfg, variables, train["batch"], card)
    up = timed("upsample", phase_upsample, device, cfg, variables, train["batch"], card)
    log(f"[time] all phases: {time.perf_counter() - t_run:.1f} s")

    source = "v2x_sim_tpu_torch/csrc/rotated_iou.cu"
    # Launches over the other phases' runs, logged beside the record.
    other = {key: flow["launches"][key] + vis[key] + tools[key] + dp[key] + p15[key]
             for key in ("matrix", "pairs", "forced", "periodic")}
    other["matrix"] += late["launches"]
    log(f"[time] rotated-IoU launches over phases 8 and 10-15 (late fusion, the workflow, vis/MGDA/"
        f"track, the tools, both DP ranks and the sharded ranks, phase 15): {other}")
    # Times and bounds on the main path's own operands: predict's NMS
    # candidates; the training batch's forced-anchor test (through the
    # forced-anchor entry, and through the aligned-pairs entry, which the
    # main path no longer launches: its count is 0); the mean of the
    # periodic entry's two launches (candidates c1 and c2). Launches are the
    # main path's own, each counted from zero: phase 3's two fp32 predicts
    # and phase 5's prepare_batch. Errors include late fusion's and the
    # workflow's (phase 10), whose times are on the [8] and [10] lines.
    kernels = [{
        "name": "rotated_iou_matrix",
        "route": "cuda",
        "source": source,
        "replaces": "v2x_sim_tpu/ops/pallas/iou_pl.py:149",
        "launches": predict_launches,
        "max_abs_err": max(k["err_mat"], nms["err"], late["err"], flow["map_matrix"]["err"]),
        "ms": nms["ms"],
        "plain_ms": nms["plain_ms"],
        "bound_ms": nms["bound_ms"],
        "bound_by": nms["bound_by"],
        "library_ms": None,
    }, {
        "name": "rotated_iou_pairs",
        "route": "cuda",
        "source": source,
        "replaces": "v2x_sim_tpu/ops/pallas/iou_pl.py:149",
        "launches": train["launches"]["pairs"],
        "max_abs_err": max(k["err_pairs"], assign["pairs"]["err"], bake["pairs"]["err"]),
        "ms": assign["pairs"]["ms"],
        "plain_ms": assign["pairs"]["plain_ms"],
        "bound_ms": assign["pairs"]["bound_ms"],
        "bound_by": assign["pairs"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "forced_anchor",
        "route": "cuda",
        "source": source,
        "replaces": "v2x_sim_tpu/ops/pallas/iou_pl.py:149",
        "launches": train["launches"]["forced"],
        "max_abs_err": max(assign["forced"]["err"], bake["forced"]["err"]),
        "ms": assign["forced"]["ms"],
        "plain_ms": assign["forced"]["plain_ms"],
        "bound_ms": assign["forced"]["bound_ms"],
        "bound_by": assign["forced"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "rotated_iou_pairs_periodic",
        "route": "cuda",
        "source": source,
        "replaces": "v2x_sim_tpu/ops/pallas/iou_pl.py:199",
        "launches": train["launches"]["periodic"],
        "max_abs_err": max([k["err_per"]] + [c["err"] for c in assign["periodic"] + bake["periodic"]]),
        "ms": per["ms"],
        "plain_ms": per["plain_ms"],
        "bound_ms": per["bound_ms"],
        "bound_by": assign["periodic"][0]["bound_by"],
        "library_ms": None,
    }]
    # The fused BatchNorm's passes: totals over a bf16 train step's 18
    # layers and the largest gap from the plain version over their shapes
    # (phase 17); launches of phase 17's step.
    kernels += [{
        "name": f"bn_{name}",
        "route": "cuda",
        "source": "v2x_sim_tpu_torch/csrc/batchnorm.cu",
        "replaces": None,
        "launches": bn["launches"][name],
        "max_abs_err": bn["err"][name],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    } for name, t in bn["passes"].items()]
    # The fused upsample and concatenation: totals over a call's four
    # decoder stages (phase 18); launches of phase 18's bf16 train step and
    # predict (4 + 4 forward, 4 backward).
    kernels += [{
        "name": f"upsample_cat_{name}",
        "route": "cuda",
        "source": "v2x_sim_tpu_torch/csrc/upsample.cu",
        "replaces": None,
        "launches": up["launches"][name],
        "max_abs_err": up["err"][name],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": up["layer"]["ops_fwd" if name == "forward" else "ops_bwd"],
    } for name, t in up["entries"].items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
