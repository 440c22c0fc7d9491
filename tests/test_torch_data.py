"""The port's data layer against the JAX package's, on the CPU.

  * ``target_fingerprint``: bit for bit the JAX value, for the default,
    small and changed-anchor configs (it guards caches both packages read).
  * ``sparse_label_idx`` / ``label_counts``: the JAX index lists and
    counts, caps that hold and caps that truncate.
  * ``create_data_det --targets 1`` (1 scene x 2 frames, 64x64x8 grid) run
    by both packages on one seed: the same files, integer arrays equal,
    float arrays within 1e-5; and from a nuScenes-format root.
  * A JAX-written cache through the port's ``make_batches`` and
    ``strip_stale_targets``: its targets kept, dropped under a changed
    anchor config; ``prepare_batch`` from them equals the live assignment.
  * ``V2XSimDataset`` and the native ``.pcd.bin`` reader against JAX's on
    a root written by ``v2x_sim_tpu/datasets/nuscenes_writer.py``, and on
    one written by the port's ``datasets/nuscenes_writer.py``.
  * The cache's threaded and uncompressed reads reproduce the serial,
    compressed ones.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.datasets.nuscenes import V2XSimDataset as JaxV2XSimDataset
from v2x_sim_tpu.datasets.nuscenes_writer import write_synthetic_nuscenes
from v2x_sim_tpu.datasets.synthetic import SyntheticSpec as JaxSpec
from v2x_sim_tpu.native.loader import _read_pcd_batch_numpy as jax_read_numpy
from v2x_sim_tpu.ops import assign as jax_assign
from v2x_sim_tpu.tools import create_data_det as jax_create_data_det
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.cache import NpzCacheDataset, save_frame
from v2x_sim_tpu_torch.datasets.nuscenes import V2XSimDataset
from v2x_sim_tpu_torch.datasets.nuscenes_writer import (
    write_synthetic_nuscenes as port_write_synthetic_nuscenes,
)
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec
from v2x_sim_tpu_torch.native import loader as native
from v2x_sim_tpu_torch.ops import assign
from v2x_sim_tpu_torch.tools import create_data_det
from v2x_sim_tpu_torch.tools.common import make_batches, strip_stale_targets
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = (1.0, 1.0, 0.625)
CFG = Config(grid=GridConfig(voxel_size=SMALL))
#: The JAX nuScenes tests' root: 3 agents, 2 scenes of 3 frames.
NUSC_CFG = Config(grid=GridConfig(voxel_size=SMALL), num_agents=3)


def _jax_config(cfg: Config) -> JaxConfig:
    """The JAX package's Config with the same field values."""
    return JaxConfig(**{
        f.name: (type(getattr(JaxConfig(), f.name))(**dataclasses.asdict(getattr(cfg, f.name)))
                 if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)
    })


def _changed_anchors(cfg: Config) -> Config:
    return dataclasses.replace(cfg, anchors=dataclasses.replace(cfg.anchors, pos_iou_threshold=0.55))


@pytest.mark.parametrize("cfg", [
    Config(), CFG, _changed_anchors(CFG),
    Config(grid=GridConfig(voxel_size=(0.5, 0.5, 0.625),
                           area_extents=((-16.0, 16.0), (-16.0, 16.0), (-3.0, 2.0)))),
], ids=["full", "small", "small-pos-0.55", "0.5m"])
def test_target_fingerprint_matches_jax(cfg):
    got = assign.target_fingerprint(cfg)
    assert got == jax_assign.target_fingerprint(_jax_config(cfg))
    assert 0 <= got < 2**31


def test_target_fingerprint_sees_anchor_changes():
    assert assign.target_fingerprint(CFG) != assign.target_fingerprint(_changed_anchors(CFG))


@pytest.mark.parametrize("caps", [(64, 96), (8, 16)], ids=["caps-hold", "caps-truncate"])
def test_sparse_label_idx_matches_jax(caps):
    rng = np.random.default_rng(0)
    labels = rng.choice(np.array([-1, 0, 1], np.int8), size=(6, 500), p=[0.1, 0.84, 0.06])
    labels[2] = 0  # a row with nothing to list
    got = assign.sparse_label_idx(torch.from_numpy(labels), *caps)
    want = jax_assign.sparse_label_idx(jnp.asarray(labels), *caps)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2:] == tuple(int(w) for w in want[2:])
    assert assign.label_counts(torch.from_numpy(labels)) == tuple(
        int(w) for w in jax_assign.label_counts(jnp.asarray(labels)))
    if caps == (64, 96):  # the lists expand back to the labels
        back = assign.labels_from_sparse_idx(got[0], got[1], labels.shape[1])
        np.testing.assert_array_equal(back.numpy(), labels)


def _run_jax_tool(module, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["prog"] + argv)
        module.main()


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same synthetic cache baked with targets by both packages."""
    root = tmp_path_factory.mktemp("caches")
    argv = ["--scenes", "1", "--frames", "2", "--grid", "small", "--targets", "1", "--seed", "3"]
    _run_jax_tool(jax_create_data_det, argv + ["--savepath", str(root / "jax")])
    assert create_data_det.main(argv + ["--savepath", str(root / "port"), "--cpu"]) == 2
    return root / "jax" / "train", root / "port" / "train"


def _assert_same_files(jax_dir, port_dir):
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir)) and names
    for name in names:
        with np.load(jax_dir / name) as want, np.load(port_dir / name) as got:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                w, g = want[key], got[key]
                assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, key)
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{name}:{key}")
                else:
                    np.testing.assert_array_equal(g, w, err_msg=f"{name}:{key}")


def test_create_data_det_writes_the_jax_files(caches):
    jax_dir, port_dir = caches
    _assert_same_files(jax_dir, port_dir)
    with np.load(port_dir / "scene0000_frame000.npz") as f:
        assert f["tgt_meta"].tolist()[-1] == assign.target_fingerprint(CFG)
        assert (f["tgt_pos_idx"] < f["tgt_pos_idx"].max()).any()  # some positives listed


def _args(data, batch=2):
    return argparse.Namespace(data=str(data), batch=batch, seed=0, grid="small", rsu=1)


def test_jax_cache_reads_through_make_batches(caches):
    jax_dir, _ = caches
    raw = next(make_batches(_args(jax_dir), CFG, num_batches=1, shuffle=False))
    assert raw["points"].shape[:2] == (2, CFG.num_agents)
    kept = strip_stale_targets(raw, CFG)
    assert "tgt_meta" not in kept
    assert {"tgt_pos_idx", "tgt_ign_idx", "tgt_cells", "tgt_reg", "tgt_wts"} <= kept.keys()
    stale = strip_stale_targets(raw, _changed_anchors(CFG))
    assert not any(k.startswith("tgt_") for k in stale) and "gt_boxes" in stale
    fresh = {k: v for k, v in raw.items() if not k.startswith("tgt_")}
    assert strip_stale_targets(fresh, CFG) is fresh


@pytest.mark.parametrize("baker, reg_tol", [("port", 0.0), ("jax", 1e-5)])
def test_prepare_batch_from_baked_targets_equals_live(caches, baker, reg_tol):
    """The port's own cache gives the live targets exactly; the JAX one
    gives them up to the two packages' fp32 regression encodings."""
    cache = caches[0] if baker == "jax" else caches[1]
    raw = strip_stale_targets(next(make_batches(_args(cache), CFG, num_batches=1)), CFG)
    module = DetModule(CFG, "disco", device="cpu", width_mult=0.25)
    live = module.targets(module.to_device({k: v for k, v in raw.items() if not k.startswith("tgt_")}))
    baked = module.targets(module.to_device(raw))
    for key in ("labels", "reg_cell", "reg_lane", "reg_sp_w"):
        assert torch.equal(live[key], baked[key]), key
    torch.testing.assert_close(baked["reg_sp_t"], live["reg_sp_t"], atol=reg_tol, rtol=0)
    assert int((live["labels"] == 1).sum()) > 0
    assert not any(k.startswith("tgt_") for k in module.prepare_batch(raw))


@pytest.fixture(scope="module", params=["jax", "port"], ids=["jax-writer", "port-writer"])
def nusc_root(request, tmp_path_factory):
    """The same scenes written by the JAX package's writer or the port's."""
    root = tmp_path_factory.mktemp(f"nusc-{request.param}")
    spec = dict(num_vehicles=5, points_per_agent=512, max_gt=8)
    if request.param == "jax":
        write_synthetic_nuscenes(str(root), _jax_config(NUSC_CFG), JaxSpec(**spec),
                                 num_scenes=2, frames_per_scene=3, seed=1)
    else:
        port_write_synthetic_nuscenes(str(root), NUSC_CFG, SyntheticSpec(**spec),
                                      num_scenes=2, frames_per_scene=3, seed=1)
    return root


def test_nuscenes_dataset_matches_jax(nusc_root):
    kw = dict(max_points=512, max_gt=8)
    got = V2XSimDataset(str(nusc_root), NUSC_CFG, **kw)
    want = JaxV2XSimDataset(str(nusc_root), _jax_config(NUSC_CFG), **kw)
    assert len(got) == len(want) == 6
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"frame {i}: {key}")
    for split in ("train", "val", "test"):
        assert len(V2XSimDataset(str(nusc_root), NUSC_CFG, split=split, **kw)) == len(
            JaxV2XSimDataset(str(nusc_root), _jax_config(NUSC_CFG), split=split, **kw))


def test_create_data_det_from_nuscenes_root_matches_jax(nusc_root, tmp_path):
    argv = ["--root", str(nusc_root), "--split", "all", "--grid", "small"]
    _run_jax_tool(jax_create_data_det, argv + ["--savepath", str(tmp_path / "jax")])
    assert create_data_det.main(argv + ["--savepath", str(tmp_path / "port"), "--cpu"]) == 6
    _assert_same_files(tmp_path / "jax" / "all", tmp_path / "port" / "all")


def test_native_reader_matches_jax(nusc_root, tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([100, 4096, 10000, 0]):
        p = tmp_path / f"sweep_{i}.pcd.bin"
        rng.standard_normal((n, 5)).astype(np.float32).tofile(p)
        paths.append(str(p))
    paths += sorted(str(p) for p in nusc_root.rglob("*.pcd.bin"))[:4]
    transforms = np.tile(np.eye(4, dtype=np.float32), (len(paths), 1, 1))
    transforms[:, 0, 0], transforms[:, 0, 1] = np.cos(0.7), -np.sin(0.7)
    transforms[:, 1, 0], transforms[:, 1, 1] = np.sin(0.7), np.cos(0.7)
    transforms[:, 0, 3] = 5.0
    assert native.native_available(), "g++ build of the port's libv2xloader failed"
    assert native.library_path().parent.name == "native"
    for tf, atol in ((None, 0.0), (transforms, 1e-5)):
        pts, mask = native.read_pcd_batch(paths, 8192, transforms=tf)
        want_pts, want_mask = jax_read_numpy(paths, 8192, 5, tf)
        np.testing.assert_array_equal(mask, want_mask)
        np.testing.assert_allclose(pts, want_pts, atol=atol, rtol=0)
    assert mask[:4].sum(axis=1).tolist() == [100, 4096, 8192, 0]
    with pytest.raises(FileNotFoundError):
        native.read_pcd_batch([paths[0], str(tmp_path / "missing.pcd.bin")], 128)


def test_cache_threaded_and_uncompressed_reads(tmp_path):
    rng = np.random.default_rng(0)
    frames = [{"x": rng.normal(size=(3, 4)).astype(np.float32),
               "i": rng.integers(0, 9, size=(5,), dtype=np.int32)} for _ in range(5)]
    for compress, sub in ((True, "c"), (False, "u")):
        d = str(tmp_path / sub)
        for n, f in enumerate(frames):
            save_frame(d, f"f{n:03d}", f, compress=compress)
        ds = NpzCacheDataset(d)
        serial = list(ds.batches(2, shuffle=True, seed=3, workers=0))
        threaded = list(ds.batches(2, shuffle=True, seed=3, workers=4))
        assert [len(b["x"]) for b in serial] == [2, 2, 1]  # the tail batch is yielded
        for a, b in zip(serial, threaded):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
