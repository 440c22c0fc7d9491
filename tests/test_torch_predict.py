"""The whole slice: the port's DetModule.predict against the JAX
DetModule.predict(exact_topk=True) on the same points and weights.

DiscoNet at full widths (32..512) over 6 agents on 64x64x8 grids: one at
1 m voxels (no peak filter) and one at 0.5 m voxels over +-16 m, where
the 3x3 peak filter runs before top-K. Outputs are compared only where
valid, and ``valid`` exactly: top-K tie order among the -inf scores the
peak filter leaves is unspecified.

Tolerances: scores 1e-4 and boxes 2e-3 (m, rad) — the 2e-4 logit
tolerance of tests/test_torch_model.py carried through the decode, where
center deltas scale by the anchor diagonal (<= 4.5 m).
"""

import numpy as np
import pytest

import jax

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.datasets.synthetic import SyntheticSpec as JaxSpec
from v2x_sim_tpu.datasets.synthetic import generate_batch as jax_generate_batch
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.test_torch_model import _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

K = 32


@pytest.mark.parametrize(
    "voxel, extent",
    [((1.0, 1.0, 0.625), 32.0), ((0.5, 0.5, 0.625), 16.0)],
    ids=["1m-no-peak-filter", "0.5m-peak-filter"],
)
def test_predict_matches_jax(voxel, extent):
    area = ((-extent, extent), (-extent, extent), (-3.0, 2.0))
    cfg = Config(grid=GridConfig(voxel_size=voxel, area_extents=area))
    jcfg = JaxConfig(grid=JaxGrid(voxel_size=voxel, area_extents=area))
    assert cfg.grid.grid_shape == (64, 64, 8)
    spec = dict(points_per_agent=2048, num_vehicles=12, max_gt=16)
    raw = generate_batch(cfg, SyntheticSpec(**spec), batch_size=2, seed=5)
    jraw = jax_generate_batch(jcfg, JaxSpec(**spec), batch_size=2, seed=5)
    for key in raw:  # the port's copy of the generator makes the same scenes
        np.testing.assert_array_equal(raw[key], jraw[key])
    raw["agent_mask"][1, -1] = False  # one padded agent
    batch = {k: raw[k] for k in ("points", "point_mask", "trans", "agent_mask")}

    jmod = JaxDetModule(jcfg, mode="disco")
    state = jmod.init(jax.random.PRNGKey(0), batch)
    variables = _perturb({"params": state.params, "batch_stats": state.batch_stats}, 0)
    state = state._replace(params=variables["params"], batch_stats=variables["batch_stats"])
    want = jmod.predict(state, batch, K, 0.1, 0.3, True)

    port = DetModule(cfg, "disco", device="cpu")
    assert port.peak_window == jmod.peak_window
    port.load_flax_variables(variables)
    got = port.predict(batch, max_boxes=K, nms_iou=0.1, score_threshold=0.3)

    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert 0 < valid.sum() < valid[:, :5].size * K  # some kept, some suppressed
    assert not valid[1, -1].any()  # the padded agent keeps nothing
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid], atol=2e-3)
