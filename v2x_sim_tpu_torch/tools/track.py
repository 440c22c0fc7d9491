"""Tracking CLI: SORT over dumped detections, then CLEAR-MOT and HOTA.

Port of ``v2x_sim_tpu/tools/track.py`` (the reference's tracking
pipeline: dump detections, convert, ``sort.py``, TrackEval). Its input is
the ``.npz`` dumps that ``test_det --save_dets`` writes, in file order;
each agent's detections over the dumps' samples form one sequence, which
is tracked and scored against the GT on its own. When every dump carries
``gt_ids`` (the nuScenes reader's instance identities, or
``generate_sequence``'s vehicle indices) they are the MOT ground truth;
otherwise ``link_gt_ids`` links the GT boxes frame to frame by nearest
neighbour.

    python -m v2x_sim_tpu_torch.tools.track --dets DUMPS

Tracking runs on the host in numpy and SciPy, as the JAX tool does: it
uses no device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from v2x_sim_tpu_torch.tracking.mot_metrics import evaluate_hota, evaluate_mot
from v2x_sim_tpu_torch.tracking.sort import track_sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dets", required=True, help="dir of test_det --save_dets dumps")
    p.add_argument("--max_age", type=int, default=3)
    p.add_argument("--min_hits", type=int, default=2)
    p.add_argument("--iou_threshold", type=float, default=0.1)
    p.add_argument("--eval_iou", type=float, default=0.5)
    return p.parse_args(argv)


def link_gt_ids(gt_frames: List[np.ndarray]) -> List[np.ndarray]:
    """Stable ids for per-frame (G, 5) GT boxes by nearest-neighbour
    linking: each box, nearest first, takes the id of the closest unclaimed
    box of the previous frame within 3 m, else a new id. Returns per-frame
    (G, 6) arrays [x, y, l, w, yaw, id]."""
    out = []
    prev = None  # (boxes, ids)
    next_id = 1
    for boxes in gt_frames:
        ids = np.zeros(len(boxes), np.int64)
        used = set()
        if prev is not None and len(prev[0]) and len(boxes):
            d = np.linalg.norm(boxes[:, None, :2] - prev[0][None, :, :2], axis=-1)
            for i in np.argsort(d.min(1)):
                for j in np.argsort(d[i]):
                    j = int(j)
                    if d[i, j] >= 3.0:
                        break
                    if j not in used:
                        ids[i] = prev[1][j]
                        used.add(j)
                        break
        for i in range(len(boxes)):
            if ids[i] == 0:
                ids[i] = next_id
                next_id += 1
        out.append(np.concatenate([boxes, ids[:, None]], -1))
        prev = (boxes, ids)
    return out


def read_sequences(dets_dir: str):
    """Per-agent sequences from the dumps: (detections, GT boxes, GT ids or
    None when a dump lacks them), each a dict agent -> list over frames.
    A dump holds (B, A, ...) arrays; its samples are consecutive frames."""
    files = sorted(os.path.join(dets_dir, f) for f in os.listdir(dets_dir) if f.endswith(".npz"))
    if not files:
        raise FileNotFoundError(f"no det dumps under {dets_dir}")
    det_seq: Dict[int, list] = {}
    gt_seq: Dict[int, list] = {}
    gtid_seq: Dict[int, list] = {}
    have_ids = True
    for f in files:
        with np.load(f) as z:
            b, a = z["boxes"].shape[:2]
            have_ids = have_ids and "gt_ids" in z
            for bi in range(b):
                for ai in range(a):
                    if not z["agent_mask"][bi, ai]:
                        continue
                    keep = z["gt_mask"][bi, ai]
                    det_seq.setdefault(ai, []).append(z["boxes"][bi, ai][z["valid"][bi, ai]])
                    gt_seq.setdefault(ai, []).append(z["gt_boxes"][bi, ai][keep])
                    if "gt_ids" in z:
                        gtid_seq.setdefault(ai, []).append(z["gt_ids"][bi, ai][keep])
    return det_seq, gt_seq, (gtid_seq if have_ids else None)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Track and score every agent's sequence; prints the results as JSON
    (values rounded to 4 places) and returns them."""
    args = parse_args(argv)
    det_seq, gt_seq, gtid_seq = read_sequences(args.dets)
    if gtid_seq is None:
        print("note: dumps carry no gt_ids; GT identities NN-linked (synthetic)")
    results = {}
    for agent, frames in sorted(det_seq.items()):
        tracks = track_sequence(frames, max_age=args.max_age, min_hits=args.min_hits,
                                iou_threshold=args.iou_threshold)
        if gtid_seq is not None:
            gt = [np.concatenate([boxes, ids[:, None].astype(np.float64)], -1)
                  for boxes, ids in zip(gt_seq[agent], gtid_seq[agent])]
        else:
            gt = link_gt_ids(gt_seq[agent])
        m = evaluate_mot(gt, tracks, iou_threshold=args.eval_iou)
        m.update(evaluate_hota(gt, tracks))
        results[f"agent{agent}"] = {k: round(v, 4) for k, v in m.items()}
    motas = [r["mota"] for r in results.values()]
    hotas = [r["hota"] for r in results.values()]
    results["global"] = {"mota": round(float(np.mean(motas)), 4),
                         "hota": round(float(np.mean(hotas)), 4)}
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
