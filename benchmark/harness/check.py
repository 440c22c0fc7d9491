"""What decides ``correct``: the program's outputs against the plain
reference's, number by number, each against a limit of its cell's
(``limits/<cell>.json``).

Training (the window's own first steps, on three distinct batches):

  * ``loss_gap``: the largest |loss - reference loss| / |reference loss|
    over the steps (``loss_gap_first``: the first step's);
  * ``grad_gap``: the first step's gradient, as Adam holds it after one
    step (exp_avg / (1 - beta1)), leaf by leaf: the largest |norm -
    reference norm| / max(reference norm, median leaf's reference norm);
  * ``delta_gap``: the same of each leaf's change over the steps;
  * ``grad_gap_median``, ``delta_gap_median``: the median leaf's gaps;
    ``grad_gap_p75``, ``grad_gap_p90``: the leaf's at those quantiles.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's are left out of both (under a softmax over agents, the bias of
DiscoNet's edge score gets none and moves under Adam by round-off alone).

Prediction (a sample of the window's calls, drawn from the seed, one on
each pool batch), over the ``max_boxes`` candidates the program returns
for every agent (its NMS returns them all, score-sorted, with the kept
ones marked valid and scored):

  * each candidate is found among the reference's candidates of the same
    agent (every anchor of every cell whose logit difference lies within
    SELECT_MARGIN of the reference's own cut) as the one that explains it
    best: the least max(|dx|, |dy|, |log(l / l')|, |log(w / w')|,
    rho |dyaw|, and for a kept candidate |dscore|): centres in m, sizes
    by the log ratio they are coded by (a size's rounding error is
    relative: random weights decode widths of tens of metres), the yaw's
    difference (wrapped) scaled by the length rho of the reference's
    (sin, cos) code, since the yaw is atan2 of that code and its rounding
    error grows as the code shortens, and scores as probabilities;
  * ``box_gap``: the largest gap of a candidate's box from its match in
    the units of the box code, each field over 1 + the size of the
    reference's code (``_code_gap``);
  * ``score_gap``: over the kept candidates, the largest |score - the
    reference's score of that anchor|;
  * ``select_gap``: the largest margin by which the reference ranks that
    anchor below its own selection, in logit units: below its
    ``max_boxes``-th candidate, or below the best anchor of its 3x3 cell
    window where the peak filter runs;
  * ``nms_errors``: NMS's keep decisions that the reference's greedy NMS
    (its plain IoU on the program's own boxes, in the program's order)
    makes otherwise, each given the program's decisions before it, so one
    difference does not cascade: a kept candidate that an earlier kept one
    overlaps by more than ``nms_iou``, or a dropped valid one that none
    does. A candidate is valid where it lies before the program's last
    kept one (the sort puts every valid candidate first), or where its
    agent is real and the reference's probability of its anchor passes
    the score threshold. Left out: a decision whose IoU with an earlier
    kept candidate lies within NMS_MARGIN of ``nms_iou`` (the kernel's
    rounding against the plain IoU's), and a dropped candidate past the
    last kept one whose probability lies within SCORE_MARGIN of the
    threshold (``nms_left_out``, not compared);
  * ``count_gap``: the sum over the agent-scenes of |boxes kept - the
    reference's| over the sum of the reference's (not compared: random
    weights decode boxes tens of metres wide, so NMS walks near-tied
    scores in another order under bf16);
  * ``<gap>_mean``: the mean of each of the first three, steadier than
    the widest.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from benchmark.reference.detect import Dense, Detections, anchor_grid, peak_window
from benchmark.reference.iou import rotated_iou

#: Leaves under this share of the median leaf's reference gradient norm
#: are not compared.
DEAD_LEAF = 1e-3
#: Port candidates located at once.
LOCATE_CHUNK = 32
#: How far (logit units) under the reference's own max_boxes-th candidate
#: a candidate may lie and still be where a program candidate is sought:
#: a program candidate found nowhere in that set reads a large box gap.
SELECT_MARGIN = 1.0
#: IoU within this of ``nms_iou``: a keep decision not judged.
NMS_MARGIN = 1e-3
#: A probability within this of the score threshold: a dropped candidate
#: past the last kept one is not judged (the widest score gap of sound
#: runs is 0.1).
SCORE_MARGIN = 0.15
#: Agent-scenes whose candidates' IoU matrix is computed at once.
IOU_ROWS = 24


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
              counted: List[str]) -> List[float]:
    """Each counted leaf's |norm - reference norm| over max(its reference
    norm, the median counted leaf's), sorted."""
    p, r = _norms({k: program[k] for k in counted}), _norms({k: reference[k] for k in counted})
    med = sorted(r.values())[len(counted) // 2]
    return sorted(abs(p[k] - r[k]) / max(r[k], med) for k in counted)


def counted_leaves(ref_grads: Mapping[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_grads)
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= DEAD_LEAF * med]


def train_numbers(losses: List[float], grads: Mapping[str, torch.Tensor],
                  deltas: Mapping[str, torch.Tensor], ref) -> Dict[str, float]:
    """The training cell's numbers; ``ref`` is ``reference.train.Steps``."""
    counted = counted_leaves(ref.grads)
    each = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(losses, ref.losses)]
    grad, delta = leaf_gaps(grads, ref.grads, counted), leaf_gaps(deltas, ref.deltas, counted)
    at = lambda q: int(q * (len(counted) - 1) + 0.5)
    mid = len(counted) // 2
    return {"loss_gap": max(each), "loss_gap_first": each[0],
            "grad_gap": grad[-1], "delta_gap": delta[-1],
            "grad_gap_median": grad[mid], "delta_gap_median": delta[mid],
            "grad_gap_p75": grad[at(0.75)], "grad_gap_p90": grad[at(0.9)]}


def _box_gap(a: torch.Tensor, b: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """max(|dx|, |dy|, |log(l / l')|, |log(w / w')|, rho |dyaw|) of
    broadcastable (..., 5) boxes: centres in m, sizes as the log ratios
    they are coded by, the yaw's difference wrapped to [-pi, pi] and
    scaled by the length of the reference's (sin, cos) code. The search's
    distance."""
    pos = (a[..., :2] - b[..., :2]).abs().amax(dim=-1)
    size = (torch.log(a[..., 2:4].clamp(min=1e-6)) - torch.log(b[..., 2:4].clamp(min=1e-6)))
    yaw = torch.remainder(a[..., 4] - b[..., 4] + math.pi, 2 * math.pi) - math.pi
    return torch.maximum(torch.maximum(pos, size.abs().amax(dim=-1)), yaw.abs() * rho)


def _code_gap(box: torch.Tensor, ref: torch.Tensor, anchors: torch.Tensor,
              rho: torch.Tensor) -> torch.Tensor:
    """The gap of (..., 5) boxes from the reference's, field by field in
    the units of the box code, each over 1 + the reference code's size:
    (dx, dy) over the anchor's diagonal, log size ratios, and rho |dyaw|
    (the chord between the (sin, cos) codes, over 1 + rho). The rounding
    of a code is relative to its size, and random weights give some
    candidates codes of 10 and more (centres tens of metres from their
    anchor), so an absolute gap would read their rounding alone."""
    diag = torch.sqrt(anchors[..., 2] ** 2 + anchors[..., 3] ** 2)
    log = lambda t: torch.log(t.clamp(min=1e-6))
    gaps = []
    for f in (0, 1):
        code = (ref[..., f] - anchors[..., f]) / diag
        gaps.append((box[..., f] - ref[..., f]).abs() / diag / (1.0 + code.abs()))
    for f in (2, 3):
        code = log(ref[..., f]) - log(anchors[..., f])
        gaps.append((log(box[..., f]) - log(ref[..., f])).abs() / (1.0 + code.abs()))
    yaw = torch.remainder(box[..., 4] - ref[..., 4] + math.pi, 2 * math.pi) - math.pi
    gaps.append(yaw.abs() * rho / (1.0 + rho))
    return torch.stack(gaps, dim=-1).amax(dim=-1)


def nms_decisions(boxes: torch.Tensor, keep: torch.Tensor, prob: torch.Tensor,
                  real: torch.Tensor, nms_iou: float, score_threshold: float):
    """The keep decisions of (G, K) score-sorted candidates that greedy NMS
    makes otherwise (``nms_errors`` in the module docstring), and those
    left out: two (G, K) bool tensors. ``boxes`` (G, K, 5) and ``keep``
    are the program's, ``prob`` the reference's probability of each
    candidate's anchor, ``real`` (G,) whether its agent is real."""
    g, k = keep.shape
    iou = torch.cat([rotated_iou(boxes[s:s + IOU_ROWS, :, None], boxes[s:s + IOU_ROWS, None, :])
                     for s in range(0, g, IOU_ROWS)])
    earlier = torch.ones(k, k, dtype=torch.bool, device=keep.device).triu(diagonal=1)
    by_kept = keep[:, :, None] & earlier  # [g, i, j]: i is kept and precedes j
    over = (by_kept & (iou > nms_iou + NMS_MARGIN)).any(dim=1)
    near = (by_kept & ((iou - nms_iou).abs() <= NMS_MARGIN)).any(dim=1)
    pos = torch.arange(k, device=keep.device)
    last = torch.where(keep, pos, torch.full_like(pos, -1)).amax(dim=1)
    before_last = pos < last[:, None]
    real = real[:, None]
    passes = real & (prob > score_threshold + SCORE_MARGIN)
    unsure = ~before_last & real & ((prob - score_threshold).abs() <= SCORE_MARGIN)
    dropped = ~keep & ~over & ~near
    errors = (keep & over) | (dropped & (before_last | passes) & ~unsure)
    left_out = (near & ~over) | (dropped & unsure)
    return errors, left_out


def predict_numbers(samples: List[Detections], refs: List[Detections], dense: List[Dense],
                    config: dict, traffic: Mapping) -> Dict[str, float]:
    """The prediction cell's numbers over sampled calls, each beside the
    reference's prediction (``refs``) and dense view (``dense``) of the
    same batch: the widest gaps and their means, and NMS's decisions."""
    max_boxes = traffic["max_boxes"]
    h, w, _ = config["grid"]["shape"]
    k = len(config["anchors"]["sizes"])
    win = peak_window(config)
    flat_anchors = anchor_grid(config, dense[0].boxes.device).reshape(-1, 5)
    gaps: Dict[str, List[torch.Tensor]] = {"box_gap": [], "score_gap": [], "select_gap": []}
    miss = total = wrong = left_out = 0
    for out, ref, dn in zip(samples, refs, dense):
        boxes = out.boxes.reshape(-1, out.boxes.shape[-2], 5).float()
        scores = out.scores.reshape(boxes.shape[:2]).float()
        valid = out.valid.reshape(boxes.shape[:2])
        n_ref = ref.valid.reshape(boxes.shape[:2]).sum(dim=1)
        miss += int((valid.sum(dim=1) - n_ref).abs().sum())
        total += int(n_ref.sum())
        kth = torch.topk(dn.peak, max_boxes, dim=1).values[:, -1]
        kth = torch.where(torch.isfinite(kth), kth, torch.full_like(kth, -1e30))
        if win:
            cell_max = dn.diff.reshape(-1, 1, h, w, k).amax(dim=-1)
            pooled = F.max_pool2d(cell_max, win, stride=1, padding=win // 2).reshape(-1, h * w)
        matched_prob = []
        for n in range(boxes.shape[0]):
            # The reference's plausible candidates: within SELECT_MARGIN of its cut.
            near = (dn.diff[n] >= kth[n] - SELECT_MARGIN).nonzero()[:, 0]
            ref_boxes, ref_diff = dn.boxes[n][near], dn.diff[n][near]
            ref_prob, rho = torch.sigmoid(ref_diff), dn.rho[n][near]
            # Kept candidates carry their score; the others (suppressed or
            # under the threshold) only their box.
            prob = torch.where(valid[n], scores[n], torch.full_like(scores[n], float("nan")))
            idx = []
            for s in range(0, boxes.shape[1], LOCATE_CHUNK):
                c, p = boxes[n, s:s + LOCATE_CHUNK, None], prob[s:s + LOCATE_CHUNK, None]
                d = _box_gap(c, ref_boxes[None], rho[None])
                d = torch.maximum(d, torch.nan_to_num((p - ref_prob[None]).abs(), nan=0.0))
                idx.append(d.argmin(dim=1))
            idx = torch.cat(idx)
            matched_prob.append(ref_prob[idx])
            box = _code_gap(boxes[n], ref_boxes[idx], flat_anchors[near[idx]], rho[idx])
            d_ref = ref_diff[idx]
            below = (kth[n] - d_ref).clamp(min=0.0)
            if win:
                below = torch.maximum(below, pooled[n][near[idx] // k] - d_ref)
            gaps["box_gap"].append(box)
            gaps["score_gap"].append((scores[n] - ref_prob[idx])[valid[n]].abs())
            gaps["select_gap"].append(below)
        errors, unjudged = nms_decisions(boxes, valid, torch.stack(matched_prob), dn.real,
                                         traffic["nms_iou"], traffic["score_threshold"])
        wrong += int(errors.sum())
        left_out += int(unjudged.sum())
    out: Dict[str, float] = {}
    for name, parts in gaps.items():
        v = torch.cat(parts)
        v = v if v.numel() else torch.zeros(1)
        out[name] = float(v.max())
        out[f"{name}_mean"] = float(v.mean())
    out["count_gap"] = miss / max(total, 1)
    out["nms_errors"] = float(wrong)
    out["nms_left_out"] = float(left_out)
    return out


def judge(numbers: Dict[str, float], limits: Mapping[str, dict]) -> Dict[str, dict]:
    """Each number that has a limit beside it, in the limits file's order;
    a limit without its number is an error in the cell's files."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no number for the limits {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}


def failed_names(checks: Mapping[str, dict]) -> List[str]:
    """The numbers over their limit (a number that is not finite fails)."""
    return [k for k, c in checks.items()
            if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]


def passed(checks: Mapping[str, dict]) -> bool:
    return not failed_names(checks)
