"""MOT evaluation: CLEAR-MOT (MOTA, MOTP, ID switches) and HOTA.

The port's own copy of ``v2x_sim_tpu/tracking/mot_metrics.py``, which
stands in for the reference's vendored TrackEval: Hungarian matching on
the exact rotated IoU of ``ops/iou_host.py``, on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from v2x_sim_tpu_torch.ops.iou_host import rotated_iou_matrix_np


def evaluate_mot(
    gt_frames: List[np.ndarray],
    trk_frames: List[np.ndarray],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """CLEAR-MOT over one sequence.

    Args:
      gt_frames: per frame (G, 6) [x, y, l, w, yaw, gt_id].
      trk_frames: per frame (T, 6) [x, y, l, w, yaw, track_id].
      iou_threshold: match acceptance threshold.

    Returns:
      {"mota", "motp", "id_switches", "misses", "false_positives",
       "num_gt", "matches"}.
    """
    assert len(gt_frames) == len(trk_frames)
    misses = fps = idsw = matches = num_gt = 0
    motp_sum = 0.0
    last_match: Dict[int, int] = {}  # gt_id -> track_id from previous frames

    for gt, trk in zip(gt_frames, trk_frames):
        gt = np.asarray(gt).reshape(-1, 6)
        trk = np.asarray(trk).reshape(-1, 6)
        num_gt += len(gt)
        if len(gt) == 0:
            fps += len(trk)
            continue
        if len(trk) == 0:
            misses += len(gt)
            continue
        iou = rotated_iou_matrix_np(gt[:, :5], trk[:, :5])
        rows, cols = linear_sum_assignment(-iou)
        matched_g, matched_t = set(), set()
        for r, c in zip(rows, cols):
            if iou[r, c] >= iou_threshold:
                gid, tid = int(gt[r, 5]), int(trk[c, 5])
                if gid in last_match and last_match[gid] != tid:
                    idsw += 1
                last_match[gid] = tid
                matches += 1
                motp_sum += iou[r, c]
                matched_g.add(r)
                matched_t.add(c)
        misses += len(gt) - len(matched_g)
        fps += len(trk) - len(matched_t)

    mota = 1.0 - (misses + fps + idsw) / max(num_gt, 1)
    motp = motp_sum / max(matches, 1)
    return {
        "mota": float(mota),
        "motp": float(motp),
        "id_switches": float(idsw),
        "misses": float(misses),
        "false_positives": float(fps),
        "num_gt": float(num_gt),
        "matches": float(matches),
    }


def evaluate_hota(
    gt_frames: List[np.ndarray],
    trk_frames: List[np.ndarray],
    alphas: np.ndarray = np.arange(0.05, 0.96, 0.05),
) -> Dict[str, float]:
    """HOTA (Higher Order Tracking Accuracy), averaged over IoU alphas.

    TrackEval-fidelity two-pass algorithm (TrackEval's
    trackeval/metrics/hota.py, the evaluator the reference defers to):

      pass 1 — accumulate, per (gt_id, track_id) pair, the Jaccard-
        normalized per-frame similarity (iou / (row_sum + col_sum - iou))
        into `potential_matches`, plus per-id frame counts; the global
        alignment score is potential / (gt_count + tr_count - potential).
      pass 2 — per frame, Hungarian-match on
        global_alignment * iou (NOT raw iou: ambiguous detections are
        steered toward the track they associate with sequence-wide), then
        threshold the chosen matches at each alpha for TP/FN/FP and the
        per-alpha matches_count used by AssA.

    HOTA_a = sqrt(DetA_a * AssA_a); DetA_a = TP/(TP+FN+FP); AssA_a =
    mean over TPs of A(c) = TPA/(TPA+FNA+FPA) computed from the matched
    pair counts. Also reports LocA (mean matched IoU).
    """
    assert len(gt_frames) == len(trk_frames)
    eps = float(np.finfo("float").eps)
    # Precompute per-frame IoU matrices + id arrays once.
    frames = []
    for gt, trk in zip(gt_frames, trk_frames):
        gt = np.asarray(gt).reshape(-1, 6)
        trk = np.asarray(trk).reshape(-1, 6)
        iou = rotated_iou_matrix_np(gt[:, :5], trk[:, :5])
        frames.append((gt[:, 5].astype(int), trk[:, 5].astype(int), iou))

    # Pass 1: per-id frame counts + Jaccard-accumulated potential matches.
    gt_count: Dict[int, int] = {}
    tr_count: Dict[int, int] = {}
    potential: Dict[tuple, float] = {}
    for gids, tids, iou in frames:
        for g in gids:
            gt_count[g] = gt_count.get(g, 0) + 1
        for t in tids:
            tr_count[t] = tr_count.get(t, 0) + 1
        if iou.size:
            denom = iou.sum(0)[None, :] + iou.sum(1)[:, None] - iou
            sim = np.where(denom > eps, iou / np.maximum(denom, eps), 0.0)
            for r, g in enumerate(gids):
                for c, t in enumerate(tids):
                    if sim[r, c] > 0:
                        key = (g, t)
                        potential[key] = potential.get(key, 0.0) + sim[r, c]

    def _alignment(key):
        p = potential.get(key, 0.0)
        return p / (gt_count[key[0]] + tr_count[key[1]] - p)

    # Pass 2: one Hungarian per frame on alignment-weighted IoU; threshold
    # the chosen matches per alpha.
    n_alpha = len(alphas)
    tp = np.zeros(n_alpha)
    fn = np.zeros(n_alpha)
    fp = np.zeros(n_alpha)
    loc_sum = np.zeros(n_alpha)
    pair_count = [dict() for _ in range(n_alpha)]  # per alpha: (g,t) -> TPA
    for gids, tids, iou in frames:
        if iou.size:
            score = np.array(
                [[_alignment((g, t)) for t in tids] for g in gids]
            ) * iou
            rows, cols = linear_sum_assignment(-score)
            msim = iou[rows, cols]
            for a, alpha in enumerate(alphas):
                ok = msim >= alpha - eps
                n_match = int(ok.sum())
                tp[a] += n_match
                fn[a] += len(gids) - n_match
                fp[a] += len(tids) - n_match
                loc_sum[a] += float(msim[ok].sum())
                pc = pair_count[a]
                for r, c in zip(rows[ok], cols[ok]):
                    key = (gids[r], tids[c])
                    pc[key] = pc.get(key, 0) + 1
        else:
            fn += len(gids)
            fp += len(tids)

    hotas, detas, assas, locas = [], [], [], []
    for a in range(n_alpha):
        total = tp[a] + fn[a] + fp[a]
        if total == 0:
            continue
        det_a = tp[a] / total
        if tp[a]:
            ass = 0.0
            for (g, t), tpa in pair_count[a].items():
                ass += tpa * (tpa / (gt_count[g] + tr_count[t] - tpa))
            ass_a = ass / tp[a]
            locas.append(loc_sum[a] / tp[a])
        else:
            ass_a = 0.0
            # TrackEval's LocA is loc_sum / max(eps, TP): an alpha with
            # detections but zero TPs contributes 0, not a skipped entry
            # (skipping made loc_a read optimistically high on sequences
            # whose high-alpha TPs vanish).
            locas.append(0.0)
        detas.append(det_a)
        assas.append(ass_a)
        hotas.append(float(np.sqrt(det_a * ass_a)))

    return {
        "hota": float(np.mean(hotas)) if hotas else 0.0,
        "det_a": float(np.mean(detas)) if detas else 0.0,
        "ass_a": float(np.mean(assas)) if assas else 0.0,
        "loc_a": float(np.mean(locas)) if locas else 0.0,
    }
