"""SORT multi-object tracker over BEV detections.

The port's own copy of ``v2x_sim_tpu/tracking/sort.py`` (the reference's
``tools/track/sort.py``): per-track Kalman prediction, a rotated-IoU cost
matrix against the frame's detections, Hungarian assignment (SciPy), and
track spawn and kill by ``max_age`` / ``min_hits``. Tracking is a
host-side pass over dumped detections, in numpy and SciPy as in the JAX
package, with the exact IoU of ``ops/iou_host.py``.

State per track: (x, y, vx, vy) under a constant-velocity Kalman filter
in the BEV plane; l, w and yaw are smoothed exponentially (yaw along the
shortest angular difference).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from v2x_sim_tpu_torch.ops.iou_host import rotated_iou_matrix_np as _iou_matrix


@dataclasses.dataclass
class KalmanBoxTracker:
    """Constant-velocity Kalman filter for one BEV box track."""

    box: np.ndarray  # (5,) x, y, l, w, yaw
    track_id: int
    dt: float = 1.0

    def __post_init__(self):
        # State: [x, y, vx, vy]; l/w/yaw tracked by exponential smoothing.
        self.x = np.array([self.box[0], self.box[1], 0.0, 0.0])
        self.P = np.diag([1.0, 1.0, 10.0, 10.0])
        self.F = np.eye(4)
        self.F[0, 2] = self.F[1, 3] = self.dt
        self.H = np.zeros((2, 4))
        self.H[0, 0] = self.H[1, 1] = 1.0
        self.Q = np.diag([0.1, 0.1, 0.5, 0.5])
        self.R = np.diag([0.5, 0.5])
        self.shape = self.box[2:5].copy()
        self.hits = 1
        self.age = 0
        self.time_since_update = 0

    def predict(self) -> np.ndarray:
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        self.time_since_update += 1
        return self.current_box()

    def update(self, box: np.ndarray):
        z = box[:2]
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(4) - k @ self.H) @ self.P
        self.shape[:2] = 0.7 * self.shape[:2] + 0.3 * box[2:4]
        # Yaw is circular: smooth along the shortest angular difference.
        # Linear smoothing breaks at the +/-pi wrap (detections of a
        # west-heading vehicle alternate near +pi/-pi and would average
        # toward 0 — a perpendicular box that kills the IoU match).
        dyaw = (box[4] - self.shape[2] + np.pi) % (2.0 * np.pi) - np.pi
        self.shape[2] += 0.3 * dyaw
        self.hits += 1
        self.time_since_update = 0

    def current_box(self) -> np.ndarray:
        return np.array(
            [self.x[0], self.x[1], self.shape[0], self.shape[1], self.shape[2]]
        )


class Sort:
    """Frame-by-frame SORT tracker.

    Args:
      max_age: frames a track survives without a matched detection.
      min_hits: matched frames before a track is reported.
      iou_threshold: min rotated IoU to accept an assignment.
    """

    def __init__(
        self, max_age: int = 3, min_hits: int = 2, iou_threshold: float = 0.1
    ):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.trackers: List[KalmanBoxTracker] = []
        self._next_id = 1
        self.frame_count = 0

    def update(self, detections: np.ndarray) -> np.ndarray:
        """Advance one frame.

        Args:
          detections: (N, 5) boxes (x, y, l, w, yaw) for this frame.

        Returns:
          (M, 6) array of [x, y, l, w, yaw, track_id] for confirmed tracks.
        """
        self.frame_count += 1
        predicted = np.array(
            [t.predict() for t in self.trackers]
        ).reshape(-1, 5)

        iou = _iou_matrix(predicted, detections)
        matched_t, matched_d = set(), set()
        if iou.size:
            rows, cols = linear_sum_assignment(-iou)
            for r, c in zip(rows, cols):
                if iou[r, c] >= self.iou_threshold:
                    self.trackers[r].update(detections[c])
                    matched_t.add(r)
                    matched_d.add(c)

        for d in range(len(detections)):
            if d not in matched_d:
                self.trackers.append(
                    KalmanBoxTracker(detections[d].copy(), self._next_id)
                )
                self._next_id += 1

        out = []
        alive = []
        for t in self.trackers:
            if t.time_since_update <= self.max_age:
                alive.append(t)
                reportable = t.hits >= self.min_hits or self.frame_count <= self.min_hits
                if t.time_since_update == 0 and reportable:
                    out.append(np.concatenate([t.current_box(), [t.track_id]]))
        self.trackers = alive
        return np.array(out).reshape(-1, 6)


def track_sequence(
    det_frames: List[np.ndarray], **kwargs
) -> List[np.ndarray]:
    """Run SORT over a list of per-frame (N, 5) detection arrays."""
    tracker = Sort(**kwargs)
    return [tracker.update(f) for f in det_frames]
