"""The port's detection workflow (``tools/{create_data_det,train_det,
test_det}.py``) on the CPU at the 64x64x8 grid and width_mult 0.25.

  * End to end: bake a cache with targets, train 2 epochs of 2 batches
    with per-epoch checkpoints, resume from the newest, train KD against
    a fresh or an upperbound teacher, and evaluate with ``--resume auto``
    (plain and late fusion): the printed JSON has the JAX tool's keys and
    values (its ``eval_map_agents`` on the detections ``--save_dets``
    wrote, rounded as it prints them).
  * The slice against JAX: the same flax variables through both
    ``DetModule.predict`` s (exact top-K) and both ``eval_map_agents``
    over 2 evaluation batches: the mAP dicts equal within 1e-6.
  * ``test_det --bf16`` evaluates in float32, as the JAX tool does.
  * Visibility and MGDA: ``create_data_det --vis 1`` bakes int8
    ``vis_maps`` equal to the JAX tool's bake of the same frames;
    ``train_det --use_vis 1 --MGDA --kd_flag 1`` trains from them (the
    baked maps reach the module: the on-device carving never runs) and
    resumes; ``test_det --use_vis 1 --save_dets`` over a cache of a
    generated sequence (with ``gt_ids`` and baked maps) keeps the same
    boxes (in any slot order, within 2e-3) as the JAX
    ``DetModule(use_vis=True).predict`` (plain execution) on the same
    weights, and ``tools/track.py`` over its dumps prints the JSON that
    the JAX tool prints over JAX's dumps.
  * Without a card every tool that uses a device (the det tools,
    ``train_seg`` and ``test_seg``) raises unless given ``--cpu``.
  * The fusion flags (``--warp_flag``, ``--v2v_rounds``,
    ``--v2v_msg_norm``) become ``DetModule``'s ``fusion`` with only the
    settings the mode takes.

``config.max_boxes`` is cut to 64 candidates for the tool runs: the plain
IoU matrix of NMS and late fusion over 512 candidates a agent takes tens
of CPU seconds.
"""

import dataclasses
import importlib.util
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.datasets.synthetic import SyntheticSpec as JaxSpec
from v2x_sim_tpu.datasets.synthetic import generate_scene as jax_generate_scene
from v2x_sim_tpu.tools import create_data_det as jax_create_data_det
from v2x_sim_tpu.tools import track as jax_track
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.det_module import TrainState as JaxTrainState
from v2x_sim_tpu.utils.mean_ap import eval_map_agents as jax_eval_map_agents
from v2x_sim_tpu_torch.bridge import random_flax_variables
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.datasets.cache import NpzCacheDataset, save_frame
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_sequence
from v2x_sim_tpu_torch.ops.visibility import visibility_batch
from v2x_sim_tpu_torch.tools import (
    bench_table,
    common,
    create_data_det,
    test_det,
    test_seg,
    track,
    train_det,
    train_seg,
)
from v2x_sim_tpu_torch.train.checkpoint import latest_checkpoint, save_checkpoint
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.utils.mean_ap import eval_map_agents
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

MAX_BOXES = 64
SMALL = ["--grid", "small", "--width_mult", "0.25", "--cpu"]


@pytest.fixture
def small_max_boxes(monkeypatch):
    build = common.build_config
    monkeypatch.setattr(test_det, "build_config",
                        lambda args: dataclasses.replace(build(args), max_boxes=MAX_BOXES))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    argv = ["--savepath", str(root), "--scenes", "1", "--frames", "4", "--grid", "small",
            "--targets", "1", "--cpu"]
    assert create_data_det.main(argv) == 4
    return str(root / "train")


def _train(cache, logpath, *extra):
    return train_det.main(SMALL + ["--data", cache, "--com", "disco", "--batch", "2",
                                   "--batches_per_epoch", "2", "--logpath", str(logpath),
                                   *extra])


def _printed_json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_train_resume_and_evaluate(cache, tmp_path, capsys, small_max_boxes):
    run = _train(cache, tmp_path / "run", "--nepoch", "2")
    assert (run.start_epoch, run.start_step, run.step) == (0, 0, 4)
    assert np.isfinite(list(run.metrics.values())).all() and "loss" in run.metrics
    assert latest_checkpoint(str(tmp_path / "run")) == str(tmp_path / "run" / "epoch_1")
    assert (tmp_path / "run" / "epoch_0").exists() and (tmp_path / "run" / "metrics.jsonl").exists()

    resumed = _train(cache, tmp_path / "run", "--nepoch", "3", "--resume", "auto")
    assert (resumed.start_epoch, resumed.start_step, resumed.step) == (2, 4, 6)
    assert len(resumed.epoch_scenes_per_sec) == 1
    assert "resumed from" in (tmp_path / "run" / "log.txt").read_text()
    capsys.readouterr()

    for late in ([], ["--late_fusion"]):
        dets = tmp_path / ("dets_late" if late else "dets")
        ev = test_det.main(SMALL + ["--data", cache, "--com", "disco", "--batch", "2",
                                    "--num_batches", "2", "--logpath", str(tmp_path / "run"),
                                    "--resume", "auto", "--save_dets", str(dets), *late])
        out = capsys.readouterr().out
        assert "loaded checkpoint" in out and "epoch_2" in out
        printed = _printed_json(out)
        saved = [np.load(dets / f"dets_{i:05d}.npz") for i in range(2)]
        assert set(saved[0].files) == {"boxes", "scores", "valid", "gt_boxes", "gt_mask",
                                       "agent_mask"}
        assert saved[0]["boxes"].shape == (2, 6, MAX_BOXES, 5)
        cat = {k: np.concatenate([s[k] for s in saved]) for k in saved[0].files}
        want = jax_eval_map_agents(cat["boxes"], cat["scores"], cat["valid"], cat["gt_boxes"],
                                   cat["gt_mask"], cat["agent_mask"])
        assert list(printed) == list(want)
        assert printed == {k: round(v, 4) for k, v in want.items()}
        assert all(abs(ev.metrics[k] - want[k]) <= 1e-6 for k in want)


def test_kd_training_with_and_without_a_teacher(cache, tmp_path):
    run = _train(cache, tmp_path / "fresh", "--nepoch", "1", "--kd_flag", "1")
    assert "kd_loss" in run.metrics and np.isfinite(run.metrics["kd_loss"])
    assert "no --teacher" in (tmp_path / "fresh" / "log.txt").read_text()
    train_det.main(SMALL + ["--data", cache, "--com", "upperbound", "--batch", "2", "--nepoch", "1",
                            "--batches_per_epoch", "1", "--logpath", str(tmp_path / "ub")])
    teacher = latest_checkpoint(str(tmp_path / "ub"))
    run = _train(cache, tmp_path / "kd", "--nepoch", "1", "--kd_flag", "1", "--teacher", teacher)
    assert np.isfinite(run.metrics["kd_loss"])
    assert f"loaded teacher from {teacher}" in (tmp_path / "kd" / "log.txt").read_text()


def test_evaluation_without_a_checkpoint(cache, tmp_path, capsys, small_max_boxes):
    with pytest.raises(SystemExit, match="no checkpoint"):
        test_det.main(SMALL + ["--data", cache, "--resume", "auto", "--logpath", str(tmp_path)])
    ev = test_det.main(SMALL + ["--data", cache, "--num_batches", "1", "--visualize",
                                str(tmp_path / "bev")])
    assert "WARNING: no --resume given" in capsys.readouterr().out
    assert set(ev.metrics) >= {"mAP@0.5", "mAP@0.7"}
    if importlib.util.find_spec("matplotlib"):  # the rendering needs it, the evaluation not
        assert (tmp_path / "bev" / "bev_0000.png").stat().st_size > 0


def test_det_bf16_evaluates_in_float32(cache, tmp_path, capsys, small_max_boxes):
    """--bf16 is accepted and evaluates in float32, as the JAX tool does:
    the same detections and mAP dict as the run without the flag."""
    argv = SMALL + ["--data", cache, "--com", "disco", "--batch", "2", "--num_batches", "1"]
    plain = test_det.main(argv + ["--save_dets", str(tmp_path / "fp32")])
    bf16 = test_det.main(argv + ["--bf16", "--save_dets", str(tmp_path / "bf16")])
    out = capsys.readouterr().out.split("WARNING")
    assert len(out) == 3 and out[1] == out[2]  # the same printout
    assert bf16.metrics == plain.metrics and "mAP@0.5" in plain.metrics
    with np.load(tmp_path / "fp32" / "dets_00000.npz") as want, \
            np.load(tmp_path / "bf16" / "dets_00000.npz") as got:
        assert want["valid"].sum() > 0
        for key in ("boxes", "scores", "valid"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("tool, argv, vis", [
    (create_data_det, ["--savepath", "unused"], ["--vis", "1"]),
    (train_det, ["--nepoch", "1"], ["--use_vis", "1", "--MGDA"]),
    (test_det, ["--num_batches", "1"], ["--use_vis", "1"]),
    (train_seg, ["--nepoch", "1"], None),
    (test_seg, ["--num_batches", "1"], None),
], ids=["create_data_det", "train_det", "test_det", "train_seg", "test_seg"])
def test_tools_raise_without_a_card(tool, argv, vis, monkeypatch, tmp_path, capsys):
    """The det tools take their visibility (and MGDA) flags and still raise
    without a card; the seg tools reject --use_vis 1 with a usage error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv + ["--grid", "small"])
    if vis is not None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv + ["--grid", "small"] + vis)
    else:
        with pytest.raises(SystemExit):
            tool.main(argv + ["--use_vis", "1"])
        assert "the segmenter takes no visibility input" in capsys.readouterr().err


@pytest.mark.parametrize("mode, want", [
    ("disco", {}),
    ("v2v", {"rounds": 2, "msg_norm": True}),
    ("when2com", {"warp_flag": False}),
    ("who2com", {"warp_flag": False}),
])
def test_fusion_settings_from_flags(mode, want):
    flags = ["--warp_flag", "0", "--v2v_rounds", "2", "--v2v_msg_norm", "1"]
    got = common.fusion_settings(bench_table.parse_args(flags), mode)
    assert got == want and all(type(got[k]) is type(v) for k, v in want.items())
    # The det tools have --warp_flag alone: v2v keeps its defaults.
    det_args = train_det.parse_args(["--warp_flag", "0"])
    assert common.fusion_settings(det_args, mode) == {k: v for k, v in want.items()
                                                      if k == "warp_flag"}
    with torch.device("meta"):  # build_fusion takes every key it gives
        DetModel(common.build_config(det_args), mode, 0.25, fusion=got)


def test_slice_map_matches_jax():
    """predict -> mAP, the port against the JAX package on the same
    weights and evaluation batches (test_det's seeds, unshuffled)."""
    args = train_det.parse_args(["--grid", "small", "--batch", "2", "--cpu"])
    cfg = common.build_config(args)
    jcfg = JaxConfig(grid=JaxGrid(voxel_size=common.SMALL_VOXEL))
    variables = random_flax_variables(DetModel(cfg, "disco", 0.25), seed=2)
    port = DetModule(cfg, "disco", device="cpu", width_mult=0.25)
    port.load_flax_variables(variables)
    jmod = JaxDetModule(jcfg, mode="disco", width_mult=0.25)
    state = JaxTrainState(variables["params"], variables["batch_stats"], None,
                          jnp.zeros((), jnp.int32))
    got, want, gt = [], [], []
    for raw in common.make_batches(args, cfg, split_seed=2**31, num_batches=2, shuffle=False):
        batch = {k: raw[k] for k in ("points", "point_mask", "trans", "agent_mask")}
        got.append([t.numpy() for t in port.predict(batch, MAX_BOXES, 0.1, 0.3)])
        want.append([np.asarray(t) for t in jmod.predict(state, batch, MAX_BOXES, 0.1, 0.3, True)])
        gt.append((raw["gt_boxes"], raw["gt_mask"], raw["agent_mask"]))
    got = [np.concatenate(x) for x in zip(*got)]
    want = [np.concatenate(x) for x in zip(*want)]
    gt = [np.concatenate(x) for x in zip(*gt)]
    np.testing.assert_array_equal(got[2], want[2])  # the same boxes kept
    assert want[2].sum() > 20
    m_got = eval_map_agents(*got, *gt, device="cpu")
    m_want = jax_eval_map_agents(*want, *gt)
    assert m_got.keys() == m_want.keys()
    for key in m_want:
        assert abs(m_got[key] - m_want[key]) <= 1e-6, (key, m_got[key], m_want[key])
    assert m_want["mAP@0.5"] > 0.0


@pytest.fixture(scope="module")
def vis_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis_cache")
    argv = ["--savepath", str(root), "--scenes", "1", "--frames", "4", "--grid", "small",
            "--targets", "1", "--vis", "1", "--cpu"]
    assert create_data_det.main(argv) == 4
    return str(root / "train")


def test_create_data_det_bakes_vis_maps_like_jax(vis_cache):
    jcfg = JaxConfig(grid=JaxGrid(voxel_size=common.SMALL_VOXEL))
    for fi in (0, 3):
        with np.load(f"{vis_cache}/scene0000_frame{fi:03d}.npz") as z:
            got = {k: z[k] for k in z.files}
        frame = jax_generate_scene(jcfg, JaxSpec(points_per_agent=2048), seed=fi)
        want = jax_create_data_det._add_vis(frame, jcfg, None)["vis_maps"]
        assert got["vis_maps"].dtype == np.int8 and got["vis_maps"].shape == (6, 64, 64, 8)
        np.testing.assert_array_equal(got["vis_maps"], want)
        assert "tgt_pos_idx" in got and (want == 1).sum() > 1000


def test_use_vis_mgda_training_and_resume(vis_cache, tmp_path, monkeypatch):
    monkeypatch.setattr("v2x_sim_tpu_torch.train.det_module.visibility_batch",
                        lambda *a, **k: pytest.fail("carved maps despite baked vis_maps"))
    flags = ["--use_vis", "1", "--MGDA", "--kd_flag", "1"]
    run = _train(vis_cache, tmp_path / "run", "--nepoch", "2", *flags)
    assert (run.start_epoch, run.start_step, run.step) == (0, 0, 4)
    weights = [run.metrics[f"mgda_w_{k}"] for k in ("cls_loss", "loc_loss", "kd_loss")]
    assert abs(sum(weights) - 1.0) < 1e-5 and min(weights) >= 0.0
    assert np.isfinite(list(run.metrics.values())).all()
    resumed = _train(vis_cache, tmp_path / "run", "--nepoch", "3", "--resume", "auto", *flags)
    assert (resumed.start_epoch, resumed.start_step, resumed.step) == (2, 4, 6)
    assert "mgda_w_kd_loss" in resumed.metrics
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "'use_vis': 1" in log and "'mgda': True" in log


def test_use_vis_dets_track_like_jax(tmp_path, capsys, monkeypatch, small_max_boxes):
    """A 4-frame sequence cache, evaluated by test_det --use_vis 1 on fixed
    weights, then tracked; JAX predicts the same batches on the same
    weights and its track tool reads its own dumps."""
    cfg = common.build_config(train_det.parse_args(["--grid", "small"]))
    seq = tmp_path / "seq"
    for i, frame in enumerate(generate_sequence(cfg, SyntheticSpec(points_per_agent=2048), 4, 4)):
        vis = visibility_batch(torch.from_numpy(frame["points"]),
                               torch.from_numpy(frame["point_mask"]), cfg.grid)
        save_frame(str(seq), f"frame{i:03d}", dict(frame, vis_maps=vis.to(torch.int8).numpy()))
    variables = random_flax_variables(DetModel(cfg, "disco", 0.25, use_vis=True), seed=3)
    module = DetModule(cfg, "disco", device="cpu", width_mult=0.25, use_vis=True)
    module.load_flax_variables(variables)
    ckpt = save_checkpoint(str(tmp_path / "run"), module, 0)

    dets = tmp_path / "dets"
    test_det.main(SMALL + ["--data", str(seq), "--com", "disco", "--batch", "2", "--num_batches",
                           "2", "--resume", ckpt, "--use_vis", "1", "--save_dets", str(dets)])
    capsys.readouterr()
    got = track.main(["--dets", str(dets), "--min_hits", "1"])
    printed = capsys.readouterr().out

    jcfg = JaxConfig(grid=JaxGrid(voxel_size=common.SMALL_VOXEL))
    jmod = JaxDetModule(jcfg, mode="disco", width_mult=0.25, use_vis=True)
    # The plain execution: the default space-to-depth one moves logits by
    # rounding, and a kept set by one box where two candidates all but tie.
    jmod.eval_model = JaxDetModel(config=jcfg, mode="disco", s2d=False, width_mult=0.25)
    jmod._blocked = False
    state = JaxTrainState(variables["params"], variables["batch_stats"], None,
                          jnp.zeros((), jnp.int32))
    jdets = tmp_path / "jax_dets"
    jdets.mkdir()
    for bi, raw in enumerate(NpzCacheDataset(str(seq)).batches(2, workers=0)):
        batch = {k: raw[k] for k in ("points", "point_mask", "trans", "agent_mask", "vis_maps")}
        boxes, scores, valid = (np.asarray(t) for t in
                                jmod.predict(state, batch, MAX_BOXES, 0.1, 0.3, True))
        with np.load(dets / f"dets_{bi:05d}.npz") as z:
            # The same boxes kept, in any slot order (NMS's slots follow
            # candidates whose scores all but tie).
            np.testing.assert_array_equal(z["valid"].sum(-1), valid.sum(-1))
            for i in np.ndindex(*valid.shape[:2]):
                order = lambda bx: bx[np.lexsort(np.round(bx[:, :2], 2).T[::-1])]
                np.testing.assert_allclose(order(z["boxes"][i][z["valid"][i]]),
                                           order(boxes[i][valid[i]]), atol=2e-3)
            np.testing.assert_array_equal(z["gt_ids"], raw["gt_ids"])
        np.savez_compressed(jdets / f"dets_{bi:05d}.npz", boxes=boxes, scores=scores, valid=valid,
                            gt_boxes=raw["gt_boxes"], gt_mask=raw["gt_mask"],
                            agent_mask=raw["agent_mask"], gt_ids=raw["gt_ids"])
    monkeypatch.setattr("sys.argv", ["track", "--dets", str(jdets), "--min_hits", "1"])
    jax_track.main()
    want = capsys.readouterr().out
    assert valid.sum() > 10
    assert printed == want and got == json.loads(want)
    assert "agent0" in got and "no gt_ids" not in printed
