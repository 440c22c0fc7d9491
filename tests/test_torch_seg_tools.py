"""The port's segmentation workflow (``tools/{create_data_seg,train_seg,
test_seg}.py``) and its nuScenes seg labels on the CPU, at the 64x64x8
grid and width_mult 0.25.

  * ``create_data_seg`` writes the JAX tool's files, every array equal,
    from synthetic scenes (1 scene x 2 frames) and from a nuScenes-format
    root written by ``v2x_sim_tpu/datasets/nuscenes_writer.py``.
  * ``V2XSimDataset(with_seg_labels=True)`` gives JAX's ``seg_labels`` on
    that root, all 8 classes present (map-expansion polygons, pedestrians,
    vehicles).
  * ``train_seg`` trains 1 epoch with a checkpoint, resumes from it, and
    ``test_seg --resume auto`` prints and returns every class's IoU and
    the mIoU; ``--bf16`` evaluates in float32 (the same numbers).
"""

import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

from v2x_sim_tpu.datasets.nuscenes import V2XSimDataset as JaxV2XSimDataset
from v2x_sim_tpu.tools import create_data_seg as jax_create_data_seg
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.nuscenes import V2XSimDataset
from v2x_sim_tpu_torch.tools import create_data_seg, test_seg, train_seg
from v2x_sim_tpu_torch.train import seg_module
from v2x_sim_tpu_torch.train.checkpoint import latest_checkpoint
from tests.test_torch_data import NUSC_CFG, _jax_config, nusc_root  # noqa: F401  (a fixture)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = ["--grid", "small", "--width_mult", "0.25", "--cpu"]


def _run_jax_tool(module, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["prog"] + argv)
        module.main()


@pytest.mark.parametrize("root", ["synthetic", "nuscenes"])
def test_create_data_seg_writes_the_jax_files(root, nusc_root, tmp_path):
    src = "synthetic" if root == "synthetic" else str(nusc_root)
    argv = ["--root", src, "--scenes", "1", "--frames", "2", "--grid", "small", "--seed", "3",
            "--split", "all"]
    _run_jax_tool(jax_create_data_seg, argv + ["--savepath", str(tmp_path / "jax")])
    count = create_data_seg.main(argv + ["--savepath", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax" / "all").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "all").iterdir())
    assert len(names) == count == (2 if root == "synthetic" else 6)
    for name in names:
        with np.load(tmp_path / "jax" / "all" / name) as want, \
                np.load(tmp_path / "port" / "all" / name) as got:
            assert sorted(got.files) == sorted(want.files) and "seg_labels" in got.files
            for key in want.files:
                assert got[key].dtype == want[key].dtype, (name, key)
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}:{key}")


def test_nuscenes_seg_labels_match_jax(nusc_root):
    kw = dict(max_points=512, max_gt=8, with_seg_labels=True)
    got = V2XSimDataset(str(nusc_root), NUSC_CFG, **kw)
    want = JaxV2XSimDataset(str(nusc_root), _jax_config(NUSC_CFG), **kw)
    assert len(got) == len(want) == 6
    present = set()
    for i in range(len(want)):
        g, w = got[i]["seg_labels"], want[i]["seg_labels"]
        assert g.dtype == w.dtype == np.int32 and g.shape == (3, 64, 64)
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
        present |= set(np.unique(g).tolist())
    assert present == set(range(len(NUSC_CFG.seg_class_names)))
    assert got.nusc.map_location(got.frames[0]) == want.nusc.map_location(want.frames[0]) is not None


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("segcache")
    argv = ["--savepath", str(root), "--scenes", "1", "--frames", "4", "--grid", "small"]
    assert create_data_seg.main(argv) == 4
    return str(root / "train")


def test_train_resume_and_evaluate(cache, tmp_path, capsys, monkeypatch):
    common = SMALL + ["--data", cache, "--com", "disco", "--batch", "2", "--batches_per_epoch", "2",
                      "--logpath", str(tmp_path / "run")]
    run = train_seg.main(common + ["--nepoch", "1"])
    assert (run.start_epoch, run.start_step, run.step) == (0, 0, 2)
    assert np.isfinite(run.metrics["loss"]) and len(run.epoch_scenes_per_sec) == 1
    assert latest_checkpoint(str(tmp_path / "run")) == str(tmp_path / "run" / "epoch_0")
    resumed = train_seg.main(common + ["--nepoch", "2", "--resume", "auto"])
    assert (resumed.start_epoch, resumed.start_step, resumed.step) == (1, 2, 4)
    assert "resumed from" in (tmp_path / "run" / "log.txt").read_text()
    capsys.readouterr()

    dtypes = []
    init = seg_module.SegModule.__init__

    def record(self, config, mode="lowerbound", compute_dtype=torch.float32, *a, **kw):
        dtypes.append(compute_dtype)
        init(self, config, mode, compute_dtype, *a, **kw)

    monkeypatch.setattr(seg_module.SegModule, "__init__", record)
    evals = []
    for bf16 in ([], ["--bf16"]):
        got = test_seg.main(SMALL + ["--data", cache, "--com", "disco", "--batch", "2",
                                     "--num_batches", "2", "--logpath", str(tmp_path / "run"),
                                     "--resume", "auto", *bf16])
        out = capsys.readouterr().out
        assert "loaded checkpoint" in out and "epoch_1" in out
        printed = json.loads(out[out.index("{"):])
        assert list(got) == list(printed) == list(Config().seg_class_names) + ["miou"]
        np.testing.assert_equal(printed, {k: round(v, 4) for k, v in got.items()})
        assert 0.0 <= got["miou"] <= 1.0
        evals.append(got)
    assert dtypes == [torch.float32, torch.float32]  # --bf16 evaluates in float32
    np.testing.assert_equal(evals[1], evals[0])


def test_evaluation_without_a_checkpoint(cache, tmp_path, capsys):
    with pytest.raises(SystemExit, match="no checkpoint"):
        test_seg.main(SMALL + ["--data", cache, "--resume", "auto", "--logpath", str(tmp_path)])
    got = test_seg.main(SMALL + ["--data", cache, "--num_batches", "1", "--visualize",
                                 str(tmp_path / "vis")])
    assert "WARNING: no --resume given" in capsys.readouterr().out
    assert "miou" in got
    if importlib.util.find_spec("matplotlib"):  # the rendering needs it, the evaluation not
        assert (tmp_path / "vis" / "seg_0000.png").stat().st_size > 0
