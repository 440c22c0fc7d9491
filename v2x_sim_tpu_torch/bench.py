"""Headline benchmark of the port: collaborative BEV detection on one card.

The counterpart of the JAX package's root ``bench.py``, on the same
workload: DiscoNet (``mode="disco"``) at ``Config()``'s production
geometry (256 x 256 x 13 BEV, 6 agents, widths 32..512, fusion at stage
3), B synthetic scenes (``V2X_BENCH_BATCH``, 16 by default), bf16
activations over float32 parameters, flax-default weights from seed 0,
TF32 off. ``python bench_torch.py`` at the repository's root runs
:func:`main`; ``--run`` runs :func:`run` in that process.

Measured, each on the host clock over calls bracketed by
``torch.cuda.synchronize()`` after a warm-up:

  * ``value``: predict end to end, points in -> NMS'd boxes out
    (``DetModule.predict(batch, 128, 0.1, 0.3)``: voxelize, the model,
    the top-K decode with its 3x3 peak filter, rotated NMS through the
    matrix IoU kernel), on a batch uploaded once, over ``STEPS`` calls.
    The port's top-K is exact; the JAX package's default is
    ``approx_max_k``.
  * ``train_scenes_per_sec``: ``train_step`` alone on one prepared batch
    (the reference's loop reads targets baked offline);
    ``train_e2e_scenes_per_sec``: ``prepare_batch`` of the next batch
    (voxelize and the anchor assignment, through the forced-anchor and
    periodic IoU kernels) alternating with ``train_step``.
  * ``train_cached_scenes_per_sec``: the disk pipeline, 2·B frames baked
    with their targets into an ``.npz`` cache, read, uploaded and
    prepared in the prefetch thread (``datasets/loader.py``), then
    stepped; one warm epoch, two timed. Its serial stage decomposition
    goes to stderr.
  * ``baseline_scenes_per_sec``: the reference's own graph
    (``baselines/torch_ref.py::measure``: float32, eval mode, forward
    only, PyTorch's default TF32 settings) on the same card at the same
    B, on the bench batch's occupancy; ``vs_baseline`` = value / it.
  * ``tflops``, ``mfu_pct``, ``train_tflops``, ``train_mfu_pct``: FLOPs
    of one ``predict`` and one ``train_step`` counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (outside the timed
    windows), times the calls per second, over the card's dense bf16
    tensor peak (:data:`PEAK_BF16_FLOPS`). The count covers convolutions
    and matrix products, forward and backward (the fusion's 1x1 edge
    convs run as matrix products); the warp, BatchNorm, elementwise work,
    the decode and the IoU kernels are not counted. JAX's figure
    (XLA's cost analysis of its s2d executable) counts other work and
    is not comparable.

No stage is guarded: a failure anywhere raises, and the run exits
non-zero. :func:`main` runs a 90 s preflight, then one bounded attempt of
``python bench_torch.py --run``, and always prints one JSON line, with
``error`` (and exit code 1) when the attempt failed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Union

import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.baselines import torch_ref
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.cache import NpzCacheDataset, save_frame
from v2x_sim_tpu_torch.datasets.loader import device_prefetch
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch, generate_scene
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.cuda import iou_cu
from v2x_sim_tpu_torch.tools.common import device_label, strip_stale_targets, synchronize
from v2x_sim_tpu_torch.tools.create_data_det import add_targets
from v2x_sim_tpu_torch.train.det_module import BATCH_KEYS, DetModule

BATCH = int(os.environ.get("V2X_BENCH_BATCH", "16"))
STEPS = 20
TRAIN_STEPS = 10
METRIC_NAME = "6-agent BEV det scenes/sec/chip (disco, e2e infer)"
ATTEMPT_TIMEOUT_S = int(os.environ.get("V2X_BENCH_TIMEOUT", "1500"))
PREFLIGHT_TIMEOUT_S = 90
#: predict's arguments, as the JAX bench calls it: 128 NMS candidates an
#: agent, NMS IoU 0.1, score threshold 0.3.
MAX_BOXES, NMS_IOU, SCORE_THRESHOLD = 128, 0.1, 0.3
#: Dense bf16 tensor-core peak by ``torch.cuda.get_device_name()``, FLOP/s
#: (NVIDIA H100 datasheet: SXM5, 989.4 TFLOP/s without sparsity).
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def peak_flops_of(name: str) -> float:
    """The dense bf16 peak of the card named ``name``; raises for a card
    the table does not list (there is no default)."""
    if name not in PEAK_BF16_FLOPS:
        raise ValueError(f"no bf16 peak is known for {name!r}; add it to PEAK_BF16_FLOPS "
                         "or pass peak_flops")
    return PEAK_BF16_FLOPS[name]


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one call of ``fn`` as ``FlopCounterMode`` counts them
    (convolutions and matrix products, forward and backward); raises when
    it counts none, since there is no MFU without a count."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    flops = counter.get_total_flops()
    if flops <= 0:
        raise RuntimeError("FlopCounterMode counted no FLOPs")
    return flops


def _rate(fn: Callable[[], object], calls: int, scenes: int, device: torch.device) -> float:
    """Scenes per second of ``calls`` calls of ``fn``, each over ``scenes``
    scenes: the host clock bracketed by synchronizes."""
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    synchronize(device)
    return scenes * calls / (time.perf_counter() - t0)


def run(config: Optional[Config] = None, spec: Optional[SyntheticSpec] = None, batch: int = BATCH,
        steps: int = STEPS, train_steps: int = TRAIN_STEPS,
        device: Optional[Union[str, torch.device]] = None,
        peak_flops: Optional[float] = None) -> dict:
    """The measurement (see the module docstring). Prints the card line on
    stderr, then the JSON line on stdout; returns its dict. On the CPU
    (tests) the caller passes ``peak_flops``."""
    device = resolve_device(device)
    if peak_flops is None:
        if device.type != "cuda":
            raise ValueError("on the CPU pass peak_flops: the bf16 peak is a card's")
        peak_flops = peak_flops_of(torch.cuda.get_device_name(device))
    config = Config() if config is None else config
    spec = SyntheticSpec(points_per_agent=8192, num_vehicles=12, max_gt=32) if spec is None else spec
    print(f"bench: {device_label(device)}; bf16 peak {peak_flops / 1e12:.1f} TFLOP/s",
          file=sys.stderr, flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        result = _measure(config, spec, batch, steps, train_steps, device, peak_flops)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(json.dumps(result), flush=True)
    return result


def _measure(config, spec, batch, steps, train_steps, device, peak_flops) -> dict:
    iou_cu.reset_launches()
    module = DetModule(config, "disco", compute_dtype=torch.bfloat16, device=device)
    module.init_weights(0)
    dev_batch = module.to_device(generate_batch(config, spec, batch, seed=0))

    def predict():
        return module.predict(dev_batch, MAX_BOXES, NMS_IOU, SCORE_THRESHOLD)

    for _ in range(2):
        predict()
    infer_flops = count_flops(predict)
    scenes_per_sec = _rate(predict, steps, batch, device)
    res = predict()
    if not (bool(torch.isfinite(res.boxes).all()) and bool(torch.isfinite(res.scores).all())):
        raise RuntimeError("non-finite predict output")

    # Training: fresh weights, as the JAX bench's second init.
    module.init_weights(1)
    prepared = module.prepare_batch(dev_batch)
    module.train_step(prepared)
    train_flops = count_flops(lambda: module.train_step(prepared))
    train_sps = _rate(lambda: module.train_step(prepared), train_steps, batch, device)

    # Streaming: the next batch's prepare alternates with the step.
    nxt = [prepared]

    def stream():
        cur, nxt[0] = nxt[0], module.prepare_batch(dev_batch)
        return module.train_step(cur)

    train_e2e_sps = _rate(stream, train_steps, batch, device)
    loss = float(stream()["loss"])
    if loss != loss or abs(loss) == float("inf"):
        raise RuntimeError(f"non-finite training loss {loss}")
    train_cached_sps = _cached_pipeline_sps(module, config, spec, device, batch)

    baseline = torch_ref.measure(prepared["occupancy"], dev_batch["trans"],
                                 dev_batch["agent_mask"], device, steps, config=config)
    launches = {"matrix": iou_cu.rotated_iou_matrix.launches,
                "forced": iou_cu.forced_anchor.launches,
                "pairs": iou_cu.rotated_iou_pairs_soa.launches,
                "periodic": iou_cu.rotated_iou_pairs_soa_periodic.launches}
    print(f"bench: kernel launches {json.dumps(launches)}; FLOPs counted: predict "
          f"{infer_flops}, train step {train_flops}", file=sys.stderr, flush=True)
    tflops = infer_flops * scenes_per_sec / batch / 1e12
    train_tflops = train_flops * train_sps / batch / 1e12
    return {
        "metric": METRIC_NAME,
        "value": scenes_per_sec,
        "unit": "scenes/sec",
        "vs_baseline": scenes_per_sec / baseline,
        "tflops": tflops,
        "mfu_pct": 100 * tflops * 1e12 / peak_flops,
        "train_scenes_per_sec": train_sps,
        "train_tflops": train_tflops,
        "train_mfu_pct": 100 * train_tflops * 1e12 / peak_flops,
        "train_e2e_scenes_per_sec": train_e2e_sps,
        "train_cached_scenes_per_sec": train_cached_sps,
        "baseline_scenes_per_sec": baseline,
    }


def _cached_pipeline_sps(module: DetModule, config: Config, spec: SyntheticSpec,
                         device: torch.device, batch: int = BATCH) -> float:
    """The training path from disk, end to end: 2·``batch`` synthetic
    frames baked with their sparse targets on ``device``
    (``create_data_det --targets 1``'s ``add_targets``) into an ``.npz``
    cache, read in shuffled batches, stale targets dropped, uploaded and
    prepared in the prefetch thread (``device_prefetch``, depth 2), and
    stepped by ``module``. Returns scenes/s over 2 epochs after a warm
    one; prints the serial per-stage rates of one epoch on stderr."""
    tmpdir = tempfile.mkdtemp(prefix="v2x_bench_cache_")
    try:
        anchors = torch.from_numpy(anchor_grid(config)).to(device)
        caps: dict = {}  # one label-index capacity for every frame: they stack
        for i in range(2 * batch):
            frame = generate_scene(config, spec, seed=50_000 + i)
            for k in ("visible", "gt_vehicle", "seg_labels"):
                frame.pop(k, None)
            save_frame(tmpdir, f"f{i:05d}", add_targets(frame, config, anchors, caps))
        ds = NpzCacheDataset(tmpdir)

        def epochs(n):
            for e in range(n):
                for raw in ds.batches(batch, shuffle=True, seed=e):
                    raw = strip_stale_targets(raw, config)
                    yield {k: v for k, v in raw.items() if k in BATCH_KEYS}

        def consume(n):
            steps = 0
            for prepared in device_prefetch(epochs(n), module.prepare_batch, depth=2,
                                            device=device):
                module.train_step(prepared)
                steps += 1
            synchronize(device)
            return steps

        consume(1)
        t0 = time.perf_counter()
        steps = consume(2)
        sps = batch * steps / (time.perf_counter() - t0)

        # Serial stage rates over one epoch (stderr; stdout keeps one line).
        t = time.perf_counter()
        raws = list(epochs(1))
        t_read = time.perf_counter() - t
        t = time.perf_counter()
        devs = [module.to_device(raw) for raw in raws]
        synchronize(device)
        t_xfer = time.perf_counter() - t
        t = time.perf_counter()
        preps = [module.prepare_batch(b) for b in devs]
        synchronize(device)
        t_prep = time.perf_counter() - t
        t = time.perf_counter()
        for b in preps:
            module.train_step(b)
        synchronize(device)
        t_step = time.perf_counter() - t
        n = batch * len(raws)
        print("cached-pipeline decomposition (serial, scenes/sec): "
              f"read+decompress {n / t_read:.1f}, host->device {n / t_xfer:.1f}, "
              f"prepare {n / t_prep:.1f}, train_step {n / t_step:.1f}; overlapped e2e {sps:.1f}",
              file=sys.stderr, flush=True)
        return sps
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _preflight() -> str:
    """A CUDA matmul and a pull of its result to the host, in a subprocess
    bounded by PREFLIGHT_TIMEOUT_S. Returns '' when healthy, else why not."""
    code = ("import torch; x = torch.ones(128, 128, device='cuda'); "
            "print('OK', float((x @ x)[0, 0].cpu()))")
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=PREFLIGHT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return f"preflight: a CUDA matmul and its pull did not finish in {PREFLIGHT_TIMEOUT_S} s"
    if proc.returncode != 0 or "OK" not in proc.stdout:
        return f"preflight failed rc={proc.returncode}: {proc.stderr[-300:]}"
    return ""


def _attempt() -> tuple:
    """One run of ``bench_torch.py --run`` bounded by ATTEMPT_TIMEOUT_S; its
    stderr is passed on. Returns (the JSON line or None, why not)."""
    try:
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), "--run"],
                              capture_output=True, text=True, timeout=ATTEMPT_TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        out = e.stderr.decode(errors="replace") if isinstance(e.stderr, bytes) else e.stderr or ""
        return None, f"timeout after {ATTEMPT_TIMEOUT_S} s; stderr tail: {out[-800:]}"
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        try:
            obj = json.loads(lines[-1])
        except json.JSONDecodeError:
            obj = {}
        if "metric" in obj:
            return lines[-1], ""
    return None, f"rc={proc.returncode}; stderr tail: {proc.stderr[-800:]}"


def main() -> int:
    """Preflight, one bounded attempt, one JSON line either way; returns
    the exit code (1 with an ``error`` line on failure)."""
    err = _preflight()
    line = None
    if not err:
        line, err = _attempt()
    if line is None:
        print(json.dumps({"metric": METRIC_NAME, "value": 0.0, "unit": "scenes/sec",
                          "vs_baseline": 0.0, "error": err}), flush=True)
        return 1
    print(line, flush=True)
    return 0
