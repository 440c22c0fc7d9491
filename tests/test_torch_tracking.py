"""Tracking against the JAX package on the CPU: host-side numpy and SciPy
in both, so every comparison is exact (``==`` on floats and arrays).

  * ``track_sequence`` (and ``Sort`` frame by frame), ``evaluate_mot`` and
    ``evaluate_hota`` on the cases of tests/test_tracking.py and
    tests/test_hota.py, and on jittered ground truth of a generated
    sequence; ``rotated_iou_matrix_np`` on seeded boxes.
  * ``generate_sequence`` bit-equal to JAX's for two seeds (every key,
    ``gt_ids`` included), and ``generate_batch`` still bit-equal.
  * ``tools/track.py``: the same ``.npz`` dumps, with and without
    ``gt_ids``, print the same JSON as JAX's ``main()`` (run with
    ``sys.argv`` patched, its stdout captured), also on the jittered-GT
    dump of chip_smoke.py's phase 12, whose results it pins.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.datasets import synthetic as jsyn
from v2x_sim_tpu.ops.iou_host import rotated_iou_matrix_np as jax_iou
from v2x_sim_tpu.tools import track as jtrack
from v2x_sim_tpu.tracking import mot_metrics as jmot
from v2x_sim_tpu.tracking import sort as jsort
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets import synthetic as psyn
from v2x_sim_tpu_torch.ops.iou_host import rotated_iou_matrix_np
from v2x_sim_tpu_torch.tools import track
from v2x_sim_tpu_torch.tracking import mot_metrics, sort

VOXEL = (1.0, 1.0, 0.625)
CFG, JCFG = Config(grid=GridConfig(voxel_size=VOXEL)), JaxConfig(grid=JaxGrid(voxel_size=VOXEL))
SPEC = dict(points_per_agent=512)


def _moving(num_frames, starts, velocity):
    return [np.asarray([[x + velocity[0] * f, y + velocity[1] * f, 4.0, 2.0, 0.0]
                        for (x, y) in starts], np.float32) for f in range(num_frames)]


def _frames(specs):
    return [np.asarray([[x, y, 4.0, 2.0, 0.0, i] for (x, y, i) in fr], np.float32).reshape(-1, 6)
            for fr in specs]


def _sequence_case(seed=3, frames=6):
    """GT of a generated sequence (agent 0) and detections: GT jittered,
    some dropped, some false positives; seeded."""
    rng = np.random.default_rng(seed)
    seq = psyn.generate_sequence(CFG, psyn.SyntheticSpec(**SPEC), seed, frames)
    gt, det = [], []
    for fr in seq:
        keep = fr["gt_mask"][0]
        boxes = fr["gt_boxes"][0][keep].astype(np.float64)
        gt.append(np.concatenate([boxes, fr["gt_ids"][0][keep][:, None]], -1))
        d = boxes[rng.random(len(boxes)) < 0.85] + rng.normal(0, [0.2, 0.2, 0.05, 0.05, 0.02],
                                                               (1, 5))
        fp = np.concatenate([rng.uniform(-28, 28, (2, 2)), np.tile([4.4, 1.9, 0.3], (2, 1))], -1)
        det.append(np.concatenate([d, fp]).astype(np.float32))
    return gt, det


#: (name, detection frames, Sort options) of test_tracking.py and a sequence.
TRACK_CASES = {
    "two_objects": (_moving(8, [(0, 0), (15, 15)], (0.5, 0.0)), {"min_hits": 1}),
    "killed_after_max_age": (_moving(3, [(0, 0)], (0.2, 0.0)) + [np.zeros((0, 5), np.float32)] * 6,
                             {"max_age": 2, "min_hits": 1}),
    "new_track": ([np.asarray([[0, 0, 4, 2, 0]], np.float32),
                   np.asarray([[0.2, 0, 4, 2, 0], [20, 20, 4, 2, 0]], np.float32)], {"min_hits": 1}),
    "yaw_wraparound": ([np.asarray([[f * 0.3, 0.0, 4.0, 2.0,
                                     np.pi - 1e-3 if f % 2 == 0 else -np.pi + 1e-3]], np.float32)
                        for f in range(8)], {"max_age": 2, "min_hits": 1, "iou_threshold": 0.1}),
    "sequence": (_sequence_case()[1], {}),
}


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", list(TRACK_CASES))
def test_track_sequence_matches_jax(case):
    frames, opts = TRACK_CASES[case]
    _assert_frames_equal(sort.track_sequence(frames, **opts), jsort.track_sequence(frames, **opts))
    port, ref = sort.Sort(**opts), jsort.Sort(**opts)
    for f in frames:
        np.testing.assert_array_equal(port.update(f), ref.update(f))
        assert [t.track_id for t in port.trackers] == [t.track_id for t in ref.trackers]
        for a, b in zip(port.trackers, ref.trackers):
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.P, b.P)
            np.testing.assert_array_equal(a.shape, b.shape)


def _mot_cases():
    gt, trk = [], []
    for f in range(4):  # test_tracking.py's combined golden
        gt.append(np.asarray([[f * 1.0, 0, 4, 2, 0, 1], [0, 10, 4, 2, 0, 2]], np.float64))
        rows = [[f * 1.0, 0, 4, 2, 0, 10], [0, 10, 4, 2, 0, 20 if f < 2 else 21]]
        if f == 3:
            rows.append([50, 50, 4, 2, 0, 30])
        trk.append(np.asarray(rows, np.float64))
    seq_gt, seq_det = _sequence_case()
    return {
        "golden": (gt, trk),
        "perfect": (_frames([[(0, 0, 1), (10, 10, 2)]] * 5), _frames([[(0, 0, 7), (10, 10, 8)]] * 5)),
        "id_switch": (_frames([[(0, 0, 1)]] * 4),
                      _frames([[(0, 0, 10)], [(0, 0, 10)], [(0, 0, 11)], [(0, 0, 11)]])),
        "misses": (_frames([[(0, 0, 1)]] * 4), _frames([[(0, 0, 5)], [], [(0, 0, 5)], []])),
        "misses_and_fps": ([np.asarray([[0, 0, 4, 2, 0, 1]], np.float32)] * 4,
                           [np.zeros((0, 6), np.float32)] * 2
                           + [np.asarray([[0, 0, 4, 2, 0, 7], [30, 30, 4, 2, 0, 8]], np.float32)] * 2),
        "empty": ([np.zeros((0, 6))] * 3, [np.zeros((0, 6))] * 3),
        "crossing": (_frames([[(0, 0, 1), (0, 10, 2), (0, 20, 3)]] * 3
                             + [[(0, 0, 1), (0, 2.5, 2), (0, 20, 3)]]),
                     _frames([[(0, 0, 10), (0, 10, 11), (0, 20, 12)]] * 3
                             + [[(0, 1.0, 10), (0, 0.5, 11), (0, 20, 12)]])),
        "sequence": (seq_gt, jsort.track_sequence(seq_det)),
    }


MOT_CASES = _mot_cases()


@pytest.mark.parametrize("case", list(MOT_CASES))
def test_mot_and_hota_match_jax(case):
    gt, trk = MOT_CASES[case]
    for iou in (0.5, 0.3):
        assert mot_metrics.evaluate_mot(gt, trk, iou) == jmot.evaluate_mot(gt, trk, iou)
    got, want = mot_metrics.evaluate_hota(gt, trk), jmot.evaluate_hota(gt, trk)
    assert got == want
    if case == "golden":
        assert want["hota"] == pytest.approx(np.sqrt(8 / 9 * 0.75), abs=1e-9)
    if case == "sequence":
        assert 0.0 < want["hota"] < 1.0


def test_host_iou_matches_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(-5, 5, (40, 2)), rng.uniform(1, 5, (40, 2)),
                        rng.uniform(-np.pi, np.pi, (40, 1))], -1).astype(np.float32)
    b = a[rng.permutation(40)] + rng.normal(0, 0.3, a.shape).astype(np.float32)
    b[:3, 2:4] = 0.0  # zero-size boxes
    got, want = rotated_iou_matrix_np(a, b), jax_iou(a, b)
    assert got.dtype == want.dtype == np.float32 and (want > 0.1).sum() > 20
    np.testing.assert_array_equal(got, want)
    assert rotated_iou_matrix_np(a[:0], b).shape == (0, 40)


@pytest.mark.parametrize("seed", [0, 11])
def test_generate_sequence_matches_jax(seed):
    got = psyn.generate_sequence(CFG, psyn.SyntheticSpec(**SPEC), seed, 5)
    want = jsyn.generate_sequence(JCFG, jsyn.SyntheticSpec(**SPEC), seed, 5)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and "gt_ids" in g
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    ids = [set(f["gt_ids"][0][f["gt_mask"][0]]) for f in got]
    assert ids[0] & ids[-1]  # identities persist across frames


def test_generate_batch_still_matches_jax():
    got = psyn.generate_batch(CFG, psyn.SyntheticSpec(**SPEC), 2, seed=4)
    want = jsyn.generate_batch(JCFG, jsyn.SyntheticSpec(**SPEC), 2, seed=4)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _write_dumps(path, with_ids):
    """Two dumps of (B=2, A) from an 8-frame sequence: jittered GT as
    detections (some dropped), the sequence's GT and, optionally, ids."""
    rng = np.random.default_rng(5)
    seq = psyn.generate_sequence(CFG, psyn.SyntheticSpec(**SPEC), 2, 4)
    path.mkdir()
    for i in range(2):
        fr = {k: np.stack([seq[2 * i + j][k] for j in range(2)]) for k in seq[0]}
        boxes = fr["gt_boxes"] + rng.normal(0, 0.15, fr["gt_boxes"].shape).astype(np.float32)
        valid = fr["gt_mask"] & (rng.random(fr["gt_mask"].shape) < 0.9)
        fr["agent_mask"][:, -1] = i == 0  # the last agent drops out halfway
        extra = {"gt_ids": fr["gt_ids"]} if with_ids else {}
        np.savez_compressed(path / f"dets_{i:05d}.npz", boxes=boxes, scores=valid * 0.9,
                            valid=valid, gt_boxes=fr["gt_boxes"], gt_mask=fr["gt_mask"],
                            agent_mask=fr["agent_mask"], **extra)


def _run_jax_track(argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["track"] + argv
    try:
        with contextlib.redirect_stdout(out):
            jtrack.main()
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.mark.parametrize("with_ids", [True, False], ids=["gt_ids", "nn_linked"])
def test_track_cli_matches_jax(tmp_path, capsys, with_ids):
    dets = tmp_path / "dets"
    _write_dumps(dets, with_ids)
    for extra in ([], ["--min_hits", "1", "--eval_iou", "0.3"]):
        argv = ["--dets", str(dets)] + extra
        got = track.main(argv)
        printed = capsys.readouterr().out
        want = _run_jax_track(argv)
        assert printed == want
        assert got == json.loads(want[want.index("{"):])
        assert ("no gt_ids" in printed) != with_ids
        assert set(got) == {f"agent{a}" for a in range(CFG.num_agents)} | {"global"}
        assert got["global"]["mota"] > 0.3
    seqs = track.read_sequences(str(dets))
    assert len(seqs[0][CFG.num_agents - 1]) == 2 and len(seqs[0][0]) == 4
    assert (seqs[2] is not None) == with_ids
    with pytest.raises(FileNotFoundError):
        track.main(["--dets", str(tmp_path)])


def test_chip_smoke_jitter_expectation_matches_jax(tmp_path, capsys):
    """chip_smoke.py's phase 12 holds track.py over its sequence's jittered
    GT to TRACK_JITTER_WANT: the port's tool reads those numbers here, and
    JAX's tool prints the same JSON from the same dump."""
    import chip_smoke

    frames = psyn.generate_sequence(Config(), psyn.SyntheticSpec(), seed=70,
                                    num_frames=chip_smoke.TRACK_FRAMES)
    dump = {k: np.stack([f[k] for f in frames]) for k in ("gt_boxes", "gt_mask", "agent_mask",
                                                        "gt_ids")}
    dets = tmp_path / "dets"
    got = chip_smoke._track_jittered_gt(dump, str(dets))
    assert got == chip_smoke.TRACK_JITTER_WANT
    capsys.readouterr()
    track.main(["--dets", str(dets)])
    assert capsys.readouterr().out == _run_jax_track(["--dets", str(dets)])
