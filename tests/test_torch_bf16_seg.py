"""bf16 against the JAX package: SegModule disco (its train step's loss
and its evaluation's confusion matrix) and DetModule disco's predict, on
the CPU.

The seg cases run the port's ``SegModule(compute_dtype=torch.bfloat16)``
and JAX's ``SegModule`` in float32 and bfloat16, plain (``s2d=False``)
and space-to-depth, on one scene (64x64x8 grid, one padded agent, depth
4, full widths), under tests/test_torch_bf16_step.py's rules: JAX's own
bf16 error is the larger of its two executions'; rule 1 holds the port to
1.25 x that from JAX's plain float32; rule 2 holds it to max(own, JAX's
two bf16 executions apart) from JAX's plain bf16. The confusion matrix
is compared entry by entry (pixel counts).

Predict's kept boxes (exact top-K, K large enough that the top-K cut
never binds, so the score threshold is the only cut), disco at
tests/test_torch_predict.py's scene and weights: for every box one run
keeps with a score clearing the threshold by more than SCORE_TOL, the
gap 1 - IoU to the nearest box the other run keeps. A rule of partners
at IoU >= 0.99 holds for no bf16 run here, JAX's included: its bf16
kept boxes lie at a median IoU of 0.958 from its float32 ones and 1.2%
of them at 0.99 or more (random weights keep ~40 overlapping boxes an
agent, and bf16 box codes move centres by ~0.1 m through the 4.9 m
anchor diagonal). So the kept sets are held by the mean gap under the
rules above (the max gap is ~1 in every run: some box has no partner).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.seg.unet import SegModel as JaxSegModel
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.det_module import TrainState
from v2x_sim_tpu.train.seg_module import SegModule as JaxSegModule
from v2x_sim_tpu_torch.bridge import random_flax_variables
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.ops.iou_host import rotated_iou_matrix_np
from v2x_sim_tpu_torch.ops.nms import NMSResult
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.train.seg_module import SegModule
from tests.test_torch_bf16 import FACTOR, dist, hold_bf16
from tests.test_torch_model import _perturb
from tests.test_torch_train import CFG, JCFG
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

DEPTH = 4
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
#: Predict: candidates an agent (above every score that clears the threshold).
K = 256
SCORE_THRESHOLD = 0.3
NMS_IOU = 0.1
SCORE_TOL = 0.02


@pytest.fixture(scope="module")
def scene():
    batch = generate_batch(CFG, SyntheticSpec(points_per_agent=2048), batch_size=1, seed=5)
    batch["agent_mask"][0, -1] = False  # one padded agent
    return batch


def _jax_seg(scene, variables, dtype, execution):
    """(train-step loss, eval confusion matrix) of one JAX execution."""
    jmod = JaxSegModule(JCFG, mode="disco", compute_dtype=dtype, depth=DEPTH)
    jmod.model = JaxSegModel(config=JCFG, mode="disco", s2d=execution == "s2d", depth=DEPTH,
                             dtype=None if dtype == jnp.float32 else dtype)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       jmod.tx.init(params), jnp.zeros((), jnp.int32))
    prep = jmod.prepare_batch(scene)
    _, cm = jmod.eval_step(state, prep)
    _, metrics = jmod.train_step(state, prep)
    return float(metrics["loss"]), np.asarray(cm, np.int64)


def test_bf16_seg_step_and_confusion_within_jax_bf16_error(scene):
    port = SegModule(CFG, "disco", torch.bfloat16, device="cpu", depth=DEPTH)
    variables = random_flax_variables(port.model, seed=11)
    jax_runs = {(e, d): _jax_seg(scene, variables, dt, e)
                for e in ("plain", "s2d") for d, dt in DTYPES.items()}
    port.load_flax_variables(variables)
    prep = port.prepare_batch(scene)
    with torch.no_grad():
        _, cm = port.eval_step(prep)
    loss = float(port.train_step(prep)["loss"])
    for i, (name, got) in enumerate((("loss", loss), ("confusion", cm.numpy()))):
        f32, bf = jax_runs["plain", "f32"][i], jax_runs["plain", "bf16"][i]
        s2d_f32, s2d_bf = jax_runs["s2d", "f32"][i], jax_runs["s2d", "bf16"][i]
        own = tuple(max(a, b) for a, b in zip(dist(bf, f32), dist(s2d_bf, s2d_f32)))
        hold_bf16(f"seg disco {name}", got, f32, own, bf, dist(s2d_bf, bf))
    assert int(cm.sum()) == int(jax_runs["plain", "f32"][1].sum())  # the same labeled pixels


def kept_distance(x, y):
    """(max, mean) over the boxes either run keeps with a score above
    SCORE_THRESHOLD + SCORE_TOL of 1 - IoU with the nearest box the other
    run keeps for that agent (1 where it keeps none)."""
    gaps = []
    for u, v in ((x, y), (y, x)):
        for idx in np.ndindex(u.valid.shape[:2]):
            clear = u.valid[idx] & (u.scores[idx] > SCORE_THRESHOLD + SCORE_TOL)
            if not clear.any():
                continue
            other = v.boxes[idx][v.valid[idx]]
            best = (rotated_iou_matrix_np(u.boxes[idx][clear], other).max(axis=1)
                    if len(other) else np.zeros(int(clear.sum())))
            gaps.append(1.0 - best)
    gaps = np.concatenate(gaps)
    return float(gaps.max()), float(gaps.mean())


def _jax_predict(batch, state, dtype, execution):
    jmod = JaxDetModule(JCFG, mode="disco", compute_dtype=dtype)
    if execution == "plain":
        jmod._blocked = jmod._occ_blocked = False
        jmod.eval_model = JaxDetModel(config=JCFG, mode="disco", s2d=False,
                                      dtype=None if dtype == jnp.float32 else dtype)
    out = jmod.predict(state, batch, K, NMS_IOU, SCORE_THRESHOLD, True)
    return NMSResult(*(np.asarray(t, np.float32 if t.dtype != bool else bool) for t in out))


def test_bf16_predict_kept_boxes_within_jax_bf16_error():
    spec = SyntheticSpec(points_per_agent=2048, num_vehicles=12, max_gt=16)
    raw = generate_batch(CFG, spec, batch_size=2, seed=5)
    raw["agent_mask"][1, -1] = False
    batch = {k: raw[k] for k in ("points", "point_mask", "trans", "agent_mask")}
    state = JaxDetModule(JCFG, mode="disco").init(jax.random.PRNGKey(0), batch)
    variables = _perturb({"params": state.params, "batch_stats": state.batch_stats}, 0)
    state = state._replace(params=variables["params"], batch_stats=variables["batch_stats"])
    runs = {(e, d): _jax_predict(batch, state, dt, e) for e in ("plain", "s2d") for d, dt in DTYPES.items()}
    assert all((~r.valid).any(axis=-1).all() for r in runs.values())  # the K cut never binds
    port = DetModule(CFG, "disco", torch.bfloat16, device="cpu")
    port.load_flax_variables(variables)
    got = port.predict(batch, max_boxes=K, nms_iou=NMS_IOU, score_threshold=SCORE_THRESHOLD)
    got = NMSResult(*(t.float().numpy() if t.is_floating_point() else t.numpy() for t in got))
    assert got.valid.sum() > 100
    f32, bf = runs["plain", "f32"], runs["plain", "bf16"]
    own = tuple(max(a, b) for a, b in zip(kept_distance(bf, f32),
                                          kept_distance(runs["s2d", "bf16"], runs["s2d", "f32"])))
    got1, got2 = kept_distance(got, f32), kept_distance(got, bf)
    apart = kept_distance(runs["s2d", "bf16"], bf)
    line = (f"bf16 predict, kept boxes' 1 - IoU to the other run's nearest (max/mean): JAX own "
            f"{own[0]:.4f}/{own[1]:.4f}, apart {apart[0]:.4f}/{apart[1]:.4f}; port vs JAX f32 "
            f"{got1[0]:.4f}/{got1[1]:.4f}, vs JAX bf16 {got2[0]:.4f}/{got2[1]:.4f}")
    print(line)
    assert got1[1] <= FACTOR * own[1] and got2[1] <= max(own[1], apart[1]), line
