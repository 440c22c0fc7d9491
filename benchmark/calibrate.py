"""Readings that set a cell's limits, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--fault-seeds 4,5,6] [--seconds 2] [--out <file.jsonl>]

For each program seed: a sound run of the cell (``harness/cell.py``, a
short window), its numbers. For each control seed: the plain reference
put in the program's place and computed in float8 (e4m3, per-tensor
scaled: the precision below the configurations' bfloat16), its numbers
against the float32 reference; for a training cell also the fault of
half the batch left out, the loss's mean taken over the rest (the
float32 reference stepping on the first half of each batch), and of a
state left unchanged (the float32 reference at learning rate 0). For each
fault seed: a prediction cell's run with the port's NMS keeping every
valid candidate; a training cell's sound run and, against the same
reference, half the batch left out. With
``--witness-seeds``, sound runs of the program with its activations in
float32 instead of the configuration's bfloat16: a second witness that
the reference computes what the program does. Each reading is one JSON
line. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def control_readings(name: str, seed: int, device, tweak=None) -> dict:
    """The control's (and a training cell's fault's) numbers on ``seed``."""
    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import check
    from benchmark.harness.weights import make_state_dict
    from benchmark.reference import detect, train
    from benchmark.reference.model import fp8_round

    c = C.load_cell(name)
    if tweak is not None:
        tweak(c)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    pool = C.make_pool(c, seed, device)
    sd = make_state_dict(C.skeleton(c), seed, device)
    out = {}
    if c.kind == "train":
        steps = c.traffic["check_steps"]
        ref = train.train_steps(C.reference_model(c, sd, device), pool[:steps], c.config)
        low = train.train_steps(C.reference_model(c, sd, device, fp8_round), pool[:steps],
                                c.config)
        out["control"] = check.train_numbers(low.losses, low.grads, low.deltas, ref)
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in pool[:steps]]
        cut = train.train_steps(C.reference_model(c, sd, device), half, c.config)
        out["fault:half_batch"] = check.train_numbers(cut.losses, cut.grads, cut.deltas, ref)
        c.config["optimizer"]["lr"] = 0.0
        still = train.train_steps(C.reference_model(c, sd, device), pool[:steps], c.config)
        out["fault:unchanged"] = check.train_numbers(still.losses, still.grads, still.deltas, ref)
        return out
    t = c.traffic
    args = (t["max_boxes"], t["nms_iou"], t["score_threshold"])
    ref_model = C.reference_model(c, sd, device).eval()
    low_model = C.reference_model(c, sd, device, fp8_round).eval()
    refs, dense, lows = [], [], []
    for batch in pool:
        r, d = detect.predict(ref_model, batch, c.config, *args)
        refs.append(r)
        dense.append(d)
        lows.append(detect.predict(low_model, batch, c.config, *args)[0])
    out["control"] = check.predict_numbers(lows, refs, dense, c.config, t)
    return out


def fault_readings(name: str, seed: int, seconds: float, device, peaks=None, tweak=None) -> dict:
    """A fault seed's numbers (see the module docstring), by kind."""
    from unittest import mock

    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import check, program
    from benchmark.harness.weights import make_state_dict
    from benchmark.reference import train

    c = C.load_cell(name)
    if c.kind == "predict":
        numbers: dict = {}
        with program.nms_keeping_all():
            C.run_cell(name, seed, seconds, False, device, time.time(), peaks=peaks,
                       tweak=tweak, numbers_out=numbers)
        return {"fault:nms_keeps_all": numbers}
    seen = {}
    judge = check.train_numbers

    def kept(*args):
        seen["args"] = args
        return judge(*args)

    sound: dict = {}
    with mock.patch.object(check, "train_numbers", kept):
        C.run_cell(name, seed, seconds, False, device, time.time(), peaks=peaks, tweak=tweak,
                   numbers_out=sound)
    ref = seen["args"][-1]
    if tweak is not None:
        tweak(c)
    steps = c.traffic["check_steps"]
    pool = C.make_pool(c, seed, device)
    sd = make_state_dict(C.skeleton(c), seed, device)
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in pool[:steps]]
    cut = train.train_steps(C.reference_model(c, sd, device), half, c.config)
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return {"program": sound,
            "fault:half_batch": judge(cut.losses, cut.grads, cut.deltas, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import roofline

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    peaks = roofline.PEAKS.get(torch.cuda.get_device_name(device))
    sink = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def float32(cell):
        cell.config["precision"]["activations"] = "float32"

    runs = [(s, "program", None) for s in _seeds(args.program_seeds)]
    runs += [(s, "witness:float32", float32) for s in _seeds(args.witness_seeds)]
    for seed, kind, tweak in runs:
        t0 = time.time()
        numbers: dict = {}
        r = C.run_cell(args.workload, seed, args.seconds, False, device, t0, peaks=peaks,
                       tweak=tweak, numbers_out=numbers)
        emit({"cell": args.workload, "kind": kind, "seed": seed, "correct": r["correct"],
              "numbers": numbers,
              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
              "seconds": time.time() - t0})
        torch.cuda.empty_cache()
    for seed in _seeds(args.control_seeds):
        t0 = time.time()
        for kind, numbers in control_readings(args.workload, seed, device).items():
            emit({"cell": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
                  "seconds": time.time() - t0})
        torch.cuda.empty_cache()
    for seed in _seeds(args.fault_seeds):
        t0 = time.time()
        for kind, numbers in fault_readings(args.workload, seed, args.seconds, device,
                                            peaks).items():
            emit({"cell": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
                  "seconds": time.time() - t0})
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
