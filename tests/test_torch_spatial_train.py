"""Training and predict on a (data=2, spatial=2) mesh of 4 gloo ranks on
the CPU (tests/torch_dist.py): ``DetModule``/``SegModule(process_group=,
spatial_group=)``, JAX's dry-run variants C (the det step) and D2 (the seg
step), held to the port's single-process step on the same scenes.

tests/test_torch_parallel.py's CFG and SPEC (32x32x4, 2 agents; one
padded agent in the second data rank's rows), width_mult 0.25, float64;
a global batch of 4 scenes, 2 a data rank, 16 of the 32 rows a spatial
rank. Each rank voxelizes and assigns its data rank's scenes on the whole
grid, then keeps its rows; the sparse regression targets whose cell lies
in another rank's rows get weight 0 there.
  * DetModule disco, and disco with KD (kd_weight 1e5, a random
    upperbound teacher, itself row-sharded); SegModule disco at depth 2;
  * every rank's parameters, running stats and Adam moments bit-identical;
  * against the single process on the 4 scenes: the loss terms (float32
    sums, as in tests/test_torch_parallel.py) at rtol 1e-6, Adam's first
    moment under tests/test_torch_train.py's gradient rule, the new
    parameters under its Adam rule, the running stats at rtol 1e-10;
  * predict (float64, the 3x3 peak filter on, so it reads across the
    shard border; 64 candidates): every rank of a data rank's spatial
    group returns the same boxes, and they are the unsharded predict's
    kept boxes, scores and masks on its scenes (to 1e-9).
"""

import numpy as np
import pytest
import torch

import jax

from v2x_sim_tpu_torch.bridge import flax_from_state_dict, random_flax_variables, seg_key_map
from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests import torch_dist
from tests.test_torch_parallel import CFG, KD_WEIGHT, LR, SEG_DEPTH, SPEC, WIDTH
from tests.test_torch_train import _assert_adam_close, _assert_grads_close, _assert_tree_close
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

WORLD = 4  # (data 2, spatial 2)
BATCH = 4  # global; 2 scenes a data rank
#: case -> (mode, DetModule options); "seg" is a SegModule step.
DET_CASES = {"disco": ("disco", {}), "disco_kd": ("disco", {"kd_weight": KD_WEIGHT})}
CASES = list(DET_CASES) + ["seg"]
PREDICT_BOXES = 64


@pytest.fixture(scope="module")
def batch():
    raw = generate_batch(CFG, SPEC, batch_size=BATCH, seed=5)
    raw["agent_mask"][3, 1] = False  # a padded agent in the second data rank's rows
    return {k: v for k, v in raw.items() if k != "visible"}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (name, (mode, opts)) in enumerate(DET_CASES.items()):
        kd = opts.get("kd_weight", 0.0) > 0.0
        out[name] = {"mode": mode, "opts": {"width_mult": WIDTH, "learning_rate": LR, **opts},
                     "variables": random_flax_variables(DetModel(CFG, mode, WIDTH, kd=kd),
                                                        seed=70 + i),
                     "teacher": random_flax_variables(DetModel(CFG, "upperbound", WIDTH), seed=80)
                     if kd else None}
    out["seg"] = {"mode": "disco", "opts": {"width_mult": WIDTH, "learning_rate": LR,
                                            "depth": SEG_DEPTH},
                  "variables": random_flax_variables(SegModel(CFG, "disco", WIDTH, SEG_DEPTH),
                                                     seed=90)}
    out["predict"] = {"mode": "disco", "opts": {"width_mult": WIDTH}, "peak_window": 3,
                      "max_boxes": PREDICT_BOXES, "variables": out["disco"]["variables"]}
    return out


@pytest.fixture(scope="module")
def ranks(batch, cases, tmp_path_factory):
    det = {k: cases[k] for k in DET_CASES}
    return torch_dist.run(torch_dist.spatial_train_checks, WORLD,
                          tmp_path_factory.mktemp("spatial_train"), CFG, det, CFG,
                          {"seg": cases["seg"]}, batch, cases["predict"])


def _flax(arrays, name):
    kmap = seg_key_map("disco", SEG_DEPTH) if name == "seg" else DET_CASES[name][0]
    return flax_from_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()}, kmap)


@pytest.mark.parametrize("name", CASES)
def test_ranks_hold_identical_state(ranks, name):
    r0 = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["metrics"] == r0["metrics"]
        for part in ("state", "exp_avg", "exp_avg_sq"):
            assert sorted(r[name][part]) == sorted(r0[part])
            for k in r0[part]:
                np.testing.assert_array_equal(r[name][part][k], r0[part][k], err_msg=f"{part} {k}")


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_is_the_single_process_step(ranks, cases, batch, name):
    step = torch_dist.seg_step if name == "seg" else torch_dist.det_step
    ref = step(CFG, cases[name], batch)
    got = ranks[0][name]
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for key, w in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], w, rtol=1e-6, err_msg=key)
    mu = _flax(ref["exp_avg"], name)["params"]
    _assert_grads_close(_flax(got["exp_avg"], name)["params"], mu)
    new, want = _flax(got["state"], name), _flax(ref["state"], name)
    _assert_adam_close(new["params"], want["params"], jax.tree.map(lambda m: m / 0.1, mu))
    _assert_tree_close(new["batch_stats"], want["batch_stats"], rtol=1e-10, atol=1e-10)


def test_sharded_predict_keeps_the_unsharded_boxes(ranks, cases, batch):
    p = cases["predict"]
    module = DetModule(CFG, p["mode"], torch.float64, device="cpu", **p["opts"])
    module.model.double()
    module.load_flax_variables(p["variables"])
    module.peak_window = p["peak_window"]
    want = module.predict(batch, max_boxes=PREDICT_BOXES)
    assert int(want.valid.sum()) > 0
    half = BATCH // 2
    for rank, r in enumerate(ranks):
        got, rows = r["predict"], slice((rank // 2) * half, (rank // 2 + 1) * half)
        np.testing.assert_array_equal(got["valid"], want.valid[rows].numpy(), err_msg=f"rank {rank}")
        keep = got["valid"]
        np.testing.assert_allclose(got["boxes"][keep], want.boxes[rows].numpy()[keep], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(got["scores"][keep], want.scores[rows].numpy()[keep], rtol=0,
                                   atol=1e-9)
        if rank % 2:  # the spatial group's two ranks return the same boxes
            for k in got:
                np.testing.assert_array_equal(got[k], ranks[rank - 1]["predict"][k])
