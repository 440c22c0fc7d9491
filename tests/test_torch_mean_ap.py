"""The port's mAP evaluator (``utils/mean_ap.py``) against the JAX package's.

  * The JAX package's golden cases (``tests/test_mean_ap.py``), each run
    through both evaluators: the same values.
  * Seeded random detections (GT boxes jittered, plus false positives,
    invalid entries and absent agents) through both ``eval_map_agents``,
    in IoU and in center matching: the same keys, values within 1e-6. The
    inputs keep every det-GT IoU at least 1e-5 from the thresholds, so the
    two packages' IoU roundings (both plain fp32 clips on the CPU) make
    the same matches.
  * The batched IoU the evaluator reads: the port's against JAX's plain
    ``rotated_iou_matrix`` within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.ops.iou_sh import rotated_iou_matrix as jax_iou_matrix
from v2x_sim_tpu.utils import mean_ap as jax_mean_ap
from v2x_sim_tpu_torch.utils import mean_ap
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

THRESHOLDS = (0.5, 0.7)


def _pad(boxes, k):
    out = np.zeros((k, 5), np.float32)
    out[: len(boxes)] = boxes
    return out


def _both(fn_name, *args, **kwargs):
    """(port, JAX) results of the evaluator function ``fn_name``; the port's
    IoU runs on the CPU."""
    got = getattr(mean_ap, fn_name)(*args, device="cpu", **kwargs)
    want = getattr(jax_mean_ap, fn_name)(*args, **kwargs)
    return got, want


def _case_perfect():
    gt = np.asarray([[0, 0, 4, 2, 0.3], [10, 5, 4, 2, -0.5]], np.float32)
    scores = np.asarray([[0.9, 0.8, 0, 0, 0, 0, 0, 0]], np.float32)
    return (_pad(gt, 8)[None], scores, scores > 0.5, gt[None], np.ones((1, 2), bool)), {}, 1.0


def _case_missed_gt():
    gt = np.asarray([[0, 0, 4, 2, 0.0], [10, 5, 4, 2, 0.0]], np.float32)
    scores = np.asarray([[0.9, 0, 0, 0]], np.float32)
    return (_pad(gt[:1], 4)[None], scores, scores > 0.5, gt[None], np.ones((1, 2), bool)), {}, 0.5


def _case_false_positive():
    gt = np.asarray([[0, 0, 4, 2, 0.0]], np.float32)
    det = np.zeros((1, 4, 5), np.float32)
    det[0, 0] = gt[0]
    det[0, 1] = [20, 20, 4, 2, 0]  # an FP scored higher than the TP
    scores = np.asarray([[0.7, 0.9, 0, 0]], np.float32)
    return (det, scores, scores > 0.5, gt[None], np.ones((1, 1), bool)), {}, 0.5


def _case_localization(thr, want):
    def case():
        gt = np.asarray([[0, 0, 4, 2, 0.0]], np.float32)
        det = np.asarray([[[1.5, 0, 4, 2, 0.0]]], np.float32)  # IoU ~ 0.45
        args = (det, np.asarray([[0.9]], np.float32), np.ones((1, 1), bool), gt[None],
                np.ones((1, 1), bool), thr)
        return args, {}, want
    return case


def _case_center(thr, want):
    def case():
        gt = np.asarray([[0, 0, 4, 2, 0.0]], np.float32)
        det = _pad(np.asarray([[1.5, 0, 4, 2, 0.0]]), 4)[None]
        scores = np.asarray([[0.9, 0, 0, 0]], np.float32)
        args = (det, scores, scores > 0.5, gt[None], np.ones((1, 1), bool), thr)
        return args, {"match": "center"}, want
    return case


def _case_center_nearest():
    # det0 (score .9) takes GT1 (1.0 m < 2.0 m); det1 then matches GT0.
    gt = np.asarray([[0, 0, 4, 2, 0.0], [3, 0, 4, 2, 0.0]], np.float32)
    det = _pad(np.asarray([[2.0, 0, 4, 2, 0.0], [0.2, 0, 4, 2, 0.0]]), 4)[None]
    scores = np.asarray([[0.9, 0.8, 0, 0]], np.float32)
    args = (det, scores, scores > 0.5, gt[None], np.ones((1, 2), bool), 2.0)
    return args, {"match": "center"}, 1.0


@pytest.mark.parametrize("case", [
    _case_perfect, _case_missed_gt, _case_false_positive, _case_localization(0.4, 1.0),
    _case_localization(0.7, 0.0), _case_center(2.0, 1.0), _case_center(1.0, 0.0),
    _case_center_nearest,
], ids=["perfect", "missed-gt", "false-positive", "loc-0.4", "loc-0.7", "center-2m",
        "center-1m", "center-nearest"])
def test_eval_map_golden_cases_match_jax(case):
    args, kwargs, want_ap = case()
    got, want = _both("eval_map", *args, **kwargs)
    assert got == want
    if want_ap == 0.5:  # the JAX cases' bounds: recall 1/2, or precision 1/2 at recall 1
        assert 0.4 < got < 0.6
    else:
        assert got == want_ap


def test_average_precision_matches_jax():
    rec = np.asarray([0.25, 0.5, 0.75, 1.0])
    prec = np.asarray([1.0, 0.5, 0.75, 0.5])
    got = mean_ap.average_precision(rec, prec)
    assert got == jax_mean_ap.average_precision(rec, prec)
    assert 0.5 <= got <= 1.0


def test_center_matching_agent_keys_match_jax():
    gt = np.zeros((1, 1, 2, 5), np.float32)
    gt[0, 0, :, 2:4] = (4, 2)
    gt[0, 0, 1, 0] = 10
    args = (gt.copy(), np.full((1, 1, 2), 0.9, np.float32), np.ones((1, 1, 2), bool), gt,
            np.ones((1, 1, 2), bool), np.ones((1, 1), bool))
    got, want = _both("eval_map_agents", *args, iou_thresholds=(1.0, 2.0), match="center")
    assert got == want
    assert got["mAP@1.0m"] == 1.0 and got["mAP@2.0m"] == 1.0


def _random_eval_inputs(seed, f=6, a=4, k=24, m=10):
    """Detections for f frames of a agents: jittered copies of most GT
    boxes, random false positives, invalid padding; some GT masked out and
    agent 1 absent from two frames."""
    rng = np.random.default_rng(seed)
    gt = np.stack([rng.uniform(-30, 30, (f, a, m)), rng.uniform(-30, 30, (f, a, m)),
                   rng.uniform(3.5, 5.0, (f, a, m)), rng.uniform(1.6, 2.2, (f, a, m)),
                   rng.uniform(-np.pi, np.pi, (f, a, m))], axis=-1).astype(np.float32)
    gt_mask = rng.random((f, a, m)) < 0.8
    det = np.stack([rng.uniform(-30, 30, (f, a, k)), rng.uniform(-30, 30, (f, a, k)),
                    rng.uniform(3.5, 5.0, (f, a, k)), rng.uniform(1.6, 2.2, (f, a, k)),
                    rng.uniform(-np.pi, np.pi, (f, a, k))], axis=-1).astype(np.float32)
    jitter = np.concatenate([rng.normal(0, 0.6, (f, a, m, 2)), rng.normal(0, 0.2, (f, a, m, 2)),
                             rng.normal(0, 0.15, (f, a, m, 1))], axis=-1)
    det[:, :, :m] = gt + jitter.astype(np.float32)
    det[..., 2:4] = np.maximum(det[..., 2:4], 0.5)
    scores = rng.random((f, a, k)).astype(np.float32)
    valid = rng.random((f, a, k)) < 0.85
    agent_mask = np.ones((f, a), bool)
    agent_mask[[1, 4], 1] = False
    return det, scores, valid, gt, gt_mask, agent_mask


@pytest.mark.parametrize("match, thresholds", [("iou", THRESHOLDS), ("center", (1.0, 2.0))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_map_agents_random_matches_jax(seed, match, thresholds):
    det, scores, valid, gt, gt_mask, agent_mask = _random_eval_inputs(seed)
    if match == "iou":
        iou = np.asarray(jax.vmap(jax_iou_matrix)(jnp.asarray(det.reshape(-1, *det.shape[2:])),
                                                  jnp.asarray(gt.reshape(-1, *gt.shape[2:]))))
        for thr in thresholds:
            assert np.abs(iou - thr).min() > 1e-5  # no match rests on a rounding
        assert (iou >= 0.5).sum() > 20  # the IoU test decides many matches
    got, want = _both("eval_map_agents", det, scores, valid, gt, gt_mask, agent_mask,
                      iou_thresholds=thresholds, match=match)
    assert got.keys() == want.keys()
    assert len(got) == 2 * (det.shape[1] + 1)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    assert 0.0 < got[f"mAP@{thresholds[0]}{'m' if match == 'center' else ''}"] < 1.0


def test_batched_iou_matches_jax():
    det, _, _, gt, _, _ = _random_eval_inputs(3, a=2, k=40, m=12)
    det, gt = det[:, 0], gt[:, 0]
    got = mean_ap.batched_iou(det, gt, torch.device("cpu"))
    want = np.asarray(jax.vmap(jax_iou_matrix)(jnp.asarray(det), jnp.asarray(gt)))
    assert got.shape == (6, 40, 12)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (want > 0).mean() > 0.01


def test_eval_map_defaults_to_the_card(monkeypatch):
    """Without ``device``, the IoU goes to the CUDA card, and raises
    without one: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, _, _ = _case_perfect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mean_ap.eval_map(*args)
    assert mean_ap.eval_map(*args, match="center") == 1.0  # center matching needs no IoU
