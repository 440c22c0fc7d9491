"""Late fusion and merged occupancy: the port against the JAX package on
the same numpy inputs.

  * ``transform_boxes`` on random boxes and rigid transforms (1e-5).
  * ``late_fuse`` over 6 agents x 40 detections per agent with tied,
    quantized scores and invalid entries, truncated to ``max_out`` < A*K
    and not truncated (0): the keep masks exactly, boxes and scores at
    1e-5. The inputs keep every IoU of the merged candidates at least
    1e-4 from the NMS threshold, so both packages' IoU roundings suppress
    the same boxes; ties keep their index order in both (a stable sort in
    the port, ``lax.top_k`` and a stable argsort in JAX).
  * ``merged_occupancy`` exactly on points at least 1e-3 voxel from every
    face they meet; on the synthetic scenes, differing voxels only where
    a point lies within 1e-5 m of a face (the 4x4 transform rounds
    differently in the two packages).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.ops.postprocess import late_fuse as jax_late_fuse
from v2x_sim_tpu.ops.postprocess import transform_boxes as jax_transform_boxes
from v2x_sim_tpu.ops.voxelize import merged_occupancy as jax_merged_occupancy
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.postprocess import late_fuse, transform_boxes
from v2x_sim_tpu_torch.ops.voxelize import merged_occupancy
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

B, A, K = 2, 6, 40
NMS_IOU = 0.1


def _rigid(rng, shape, spread=10.0):
    yaw = rng.uniform(-np.pi, np.pi, shape)
    t = np.tile(np.eye(4, dtype=np.float32), shape + (1, 1))
    t[..., 0, 0], t[..., 0, 1] = np.cos(yaw), -np.sin(yaw)
    t[..., 1, 0], t[..., 1, 1] = np.sin(yaw), np.cos(yaw)
    t[..., :3, 3] = rng.uniform(-spread, spread, shape + (3,))
    return t.astype(np.float32)


def _boxes(rng, shape, spread=20.0):
    return np.stack([rng.uniform(-spread, spread, shape), rng.uniform(-spread, spread, shape),
                     rng.uniform(2.0, 5.0, shape), rng.uniform(1.0, 2.5, shape),
                     rng.uniform(-np.pi, np.pi, shape)], axis=-1).astype(np.float32)


def test_transform_boxes_matches_jax():
    rng = np.random.default_rng(0)
    boxes, t = _boxes(rng, (3, 7)), _rigid(rng, (3, 7))
    want = np.asarray(jax_transform_boxes(jnp.asarray(boxes), jnp.asarray(t)))
    got = transform_boxes(torch.from_numpy(boxes), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    identity = transform_boxes(torch.from_numpy(boxes), torch.eye(4)).numpy()
    np.testing.assert_array_equal(identity, boxes)


def _detections(seed):
    rng = np.random.default_rng(seed)
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    poses = _rigid(rng, (B, A), spread=6.0)  # agent frame -> world
    for b in range(B):
        for i in range(A):
            for j in range(A):
                trans[b, i, j] = np.linalg.inv(poses[b, i].astype(np.float64)) @ poses[b, j]
    boxes = _boxes(rng, (B, A, K))
    scores = np.round(rng.uniform(0.0, 1.0, (B, A, K)), 1).astype(np.float32)  # many ties
    valid = rng.random((B, A, K)) < 0.8
    agent_mask = np.ones((B, A), bool)
    agent_mask[1, -1] = False
    return boxes, scores, valid, trans.astype(np.float32), agent_mask


@pytest.mark.parametrize("max_out", [100, 0], ids=["max_out_100", "all"])
def test_late_fuse_matches_jax(max_out):
    boxes, scores, valid, trans, agent_mask = _detections(seed=6)
    want = jax_late_fuse(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                         jnp.asarray(trans), jnp.asarray(agent_mask), NMS_IOU, max_out)
    got = late_fuse(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
                    torch.from_numpy(trans), torch.from_numpy(agent_mask), NMS_IOU, max_out)
    n = max_out or A * K
    assert got.boxes.shape == (B, A, n, 5) and got.valid.shape == (B, A, n)
    # No IoU of the sorted candidates lies within 1e-4 of the threshold.
    iou = iou_sh.rotated_iou_matrix(got.boxes.reshape(-1, n, 5), got.boxes.reshape(-1, n, 5))
    assert float((iou - NMS_IOU).abs().min()) > 1e-4
    keep = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), keep)
    candidates = A * np.minimum(n, (valid & agent_mask[..., None]).sum(axis=(1, 2))).sum()
    assert 0 < keep.sum() < candidates  # NMS keeps some and suppresses some
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)


def _points(rng, grid, p=300):
    (x0, x1), (y0, y1), (z0, z1) = grid.area_extents
    pts = np.stack([rng.uniform(x0 - 4, x1 + 4, (B, A, p)), rng.uniform(y0 - 4, y1 + 4, (B, A, p)),
                    rng.uniform(z0 - 0.5, z1 + 0.5, (B, A, p))], axis=-1)
    return pts.astype(np.float32), rng.random((B, A, p)) < 0.9


def _moved64(points, trans):
    """Each source's points in each ego frame, float64: (B, Ai, Aj, P, 3)."""
    hom = np.concatenate([points, np.ones_like(points[..., :1])], -1).astype(np.float64)
    return np.einsum("bijxy,bjpy->bijpx", trans.astype(np.float64), hom)[..., :3]


def _face_distance(moved, grid):
    """Distance of each coordinate to its nearest voxel face, in voxels."""
    rel = (moved - np.asarray(grid.lower)) / np.asarray(grid.voxel_size)
    return np.abs(rel - np.round(rel))


def test_merged_occupancy_matches_jax_away_from_faces():
    grid, jgrid = GridConfig(voxel_size=(2.0, 2.0, 1.25)), JaxGrid(voxel_size=(2.0, 2.0, 1.25))
    rng = np.random.default_rng(2)
    points, pmask = _points(rng, grid)
    trans = _rigid(rng, (B, A, A), spread=8.0)
    agent_mask = np.ones((B, A), bool)
    agent_mask[1, -1] = False
    near = (_face_distance(_moved64(points, trans), grid) < 1e-3).any(-1).any(1)  # (B, Aj, P)
    pmask &= ~near
    want = np.asarray(jax_merged_occupancy(jnp.asarray(points), jnp.asarray(pmask), jnp.asarray(trans),
                                           jnp.asarray(agent_mask), jgrid))
    got = merged_occupancy(torch.from_numpy(points), torch.from_numpy(pmask), torch.from_numpy(trans),
                           torch.from_numpy(agent_mask), grid)
    assert got.shape == (B, A) + grid.grid_shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_merged_occupancy_on_synthetic_scenes_differs_only_at_faces():
    cfg = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
    jgrid = JaxGrid(voxel_size=(1.0, 1.0, 0.625))
    raw = generate_batch(cfg, SyntheticSpec(points_per_agent=2048, num_vehicles=12, max_gt=16), 2, 5)
    raw["agent_mask"][1, -1] = False
    args = [raw[k] for k in ("points", "point_mask", "trans", "agent_mask")]
    want = np.asarray(jax_merged_occupancy(*map(jnp.asarray, args), jgrid))
    got = merged_occupancy(*map(torch.from_numpy, args), cfg.grid, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.sum() > 1000
    differ = np.argwhere(got.float().numpy() != want)
    # Voxels touched by a real point within 1e-5 m of a face, either side of it.
    moved = _moved64(raw["points"][..., :3], raw["trans"])
    real = (raw["point_mask"] & raw["agent_mask"][..., None])[:, None]
    near = (_face_distance(moved, cfg.grid) * np.asarray(cfg.grid.voxel_size) < 1e-5).any(-1) & real
    allowed = set()
    for b, i, j, p in np.argwhere(near):
        rel = (moved[b, i, j, p] - np.asarray(cfg.grid.lower)) / np.asarray(cfg.grid.voxel_size)
        for v in {tuple(np.floor(rel - 1e-3).astype(int)), tuple(np.floor(rel + 1e-3).astype(int))}:
            allowed.add((b, i) + v)
    assert all(tuple(d) in allowed for d in differ), differ[:5]
