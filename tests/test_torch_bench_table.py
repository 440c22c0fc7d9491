"""The port's benchmark-table tools against the JAX package's, on the CPU.

  * The learning-rate schedule: ``warmup_cosine_decay`` equals optax's
    ``warmup_cosine_decay_schedule`` (evaluated in float64) at every step,
    and a float64 ``DetModule`` (lowerbound, 64x64x8, width 0.25) takes 3
    Adam steps under it as JAX's module does under the optax schedule;
    step 0 runs at lr 0 and leaves the weights exactly as they were. A
    ``DetModule`` or ``SegModule`` resumed from a checkpoint carries on
    with the schedule where it stopped.
  * ``_bake_pool_targets`` on a 2-batch tiny pool: index lists, cells and
    int8 weights exact, bf16 regression targets equal.
  * From one JAX init tree and with training off (``--lr 0 --steps 0``)
    on both sides, a det row's mAP (center matching) within 1e-6 of the
    JAX tool's and a seg row's confusion matrix exact; then
    ``bench_table_track`` over the states both sides saved (the port
    reading JAX's ``.pkl``) gives every stream's MOT counts, MOTA and
    HOTA as JAX's does, over 2 sequences of 4 frames.
  * A few trained steps of disco+kd (``--cosine --data_pool 2 --eval_at
    1``) against JAX's upperbound ``.pkl`` as ``--teacher_state`` give
    JAX's row and curves keys.
  * ``write_table``, merge and assemble print the JAX tools' markdown on
    the same JSON (but the ``Generated by`` line and the device line),
    and each package's merge reads the other's curves.

The tiny grid (32x32x4 at 2 m) and width 0.25 keep the JAX compiles short.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.tools import bench_table as jbt
from v2x_sim_tpu.tools import bench_table_assemble as jassemble
from v2x_sim_tpu.tools import bench_table_merge as jmerge
from v2x_sim_tpu.tools import bench_table_track as jtrack
from v2x_sim_tpu.tracking import mot_metrics as jmot
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.seg_module import SegModule as JaxSegModule
from v2x_sim_tpu_torch.bridge import adam_state_from_optax, flax_from_state_dict, random_flax_variables
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.tools import bench_table, bench_table_assemble, bench_table_merge, bench_table_track
from v2x_sim_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from v2x_sim_tpu_torch.train.det_module import DetModule, warmup_cosine_decay
from v2x_sim_tpu_torch.train.seg_module import SegModule
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

TINY = ["--grid", "tiny", "--width_mult", "0.25", "--batch", "2", "--eval_batches", "1", "--cpu"]
VOXEL = (1.0, 1.0, 0.625)  # 64x64x8
LR = 1e-3


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("steps", [7, 400, 5000])
def test_schedule_matches_optax(steps):
    ours = warmup_cosine_decay(3e-3, steps)
    warmup = max(1, min(steps // 10, 200))
    with jax.enable_x64(True):
        want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, steps, 3e-3 * 0.05)
        vals = np.asarray(jax.vmap(want)(jnp.arange(steps + 3, dtype=jnp.int64)))
    got = np.array([ours(s) for s in range(steps + 3)])
    np.testing.assert_allclose(got, vals, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[warmup] == pytest.approx(3e-3) and got[-1] == pytest.approx(1.5e-4)


def test_cosine_float64_steps_match_jax():
    """Three float64 Adam steps under the schedule, against JAX's plain
    execution with optax's schedule in its Adam."""
    cfg = Config(grid=GridConfig(voxel_size=VOXEL))
    raw = generate_batch(cfg, SyntheticSpec(points_per_agent=2048, max_gt=16), batch_size=2, seed=5)
    variables = random_flax_variables(DetModel(cfg, "lowerbound", 0.25), seed=1)
    steps = 7  # warmup 1: the three steps run at lr 0, the peak, the first decayed value
    with jax.enable_x64(True):
        jcfg = JaxConfig(grid=JaxGrid(voxel_size=VOXEL))
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, steps, LR * 0.05)
        jmod = JaxDetModule(jcfg, mode="lowerbound", compute_dtype=jnp.float64, learning_rate=sched)
        jmod.model = JaxDetModel(config=jcfg, mode="lowerbound", dtype=jnp.float64, s2d=False,
                                 width_mult=0.25)
        jmod._blocked = jmod._occ_blocked = False
        prep = jmod.prepare_batch(raw)
        grad_fn = jax.jit(jax.value_and_grad(jmod.loss_fn, has_aux=True), static_argnums=(4,))

        @jax.jit
        def update(grads, opt, params):
            updates, opt = jmod.tx.update(grads, opt, params)
            return optax.apply_updates(params, updates), opt

        v = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
        params, stats, opt = v["params"], v["batch_stats"], jmod.tx.init(v["params"])
        want = []
        for _ in range(3):
            before = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats, "opt": opt})
            (_, (stats, _)), grads = grad_fn(params, stats, prep, None, True)
            params, opt = update(grads, opt, params)
            want.append((before, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, grads)))

    # Each step from JAX's state before it: the gradients at the det
    # float64 rule (atol 1e-4 x the leaf's max |g|: both packages take
    # the losses of float32 logits), then optax's Adam under the schedule
    # applied to the port's own gradients gives the port's weights, within
    # 1e-6 of the lr: optax's schedule reads its int32 count, so its lr is
    # float32 (1e-3 is 1.00000005e-3) even in float64.
    for i, (before, _, want_grads) in enumerate(want):
        before = jax.tree.map(  # what the bridge carries: float32 values
            lambda x: np.asarray(np.asarray(x, np.float32), np.float64) if x.dtype == np.float64 else x,
            before)
        port = DetModule(cfg, "lowerbound", torch.float64, device="cpu",
                         learning_rate=warmup_cosine_decay(LR, steps), width_mult=0.25)
        port.model.double()
        port.load_flax_variables(before)
        if i:
            adam_state_from_optax(before["opt"], port)
        port.step = i
        start = {k: v.clone() for k, v in port.model.state_dict().items()}
        port.train_step(port.prepare_batch(raw))
        assert port.step == i + 1
        assert port.optimizer.param_groups[0]["lr"] == warmup_cosine_decay(LR, steps)(i)
        if i == 0:  # lr 0: Adam's moments move, the weights do not
            for name, p in port.model.named_parameters():
                assert torch.equal(p, start[name]), name
        grads = flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()})["params"]
        got_g, want_g = _leaves(grads), _leaves(want_grads)
        for k, w in want_g.items():
            np.testing.assert_allclose(got_g[k], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
        with jax.enable_x64(True):
            expect, _ = update(jax.tree.map(jnp.asarray, grads), before["opt"], before["params"])
        got = _leaves(flax_from_state_dict(port.model.state_dict())["params"])
        for k, w in _leaves(expect).items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 * LR, err_msg=(i, k))


@pytest.mark.parametrize("task", ["det", "seg"])
def test_schedule_resumes_where_it_stopped(task, tmp_path):
    """Two scheduled steps, a checkpoint, a fresh module restored from it
    and a third step: the lr of the step count carried over, and the
    weights of an uninterrupted run (bitwise, on the CPU)."""
    args = bench_table.parse_args(TINY + (["--grid", "tiny1m"] if task == "seg" else []))
    cfg, spec = bench_table.build_config(args), bench_table.build_spec(args)
    raw = generate_batch(cfg, spec, batch_size=2, seed=3)
    sched = warmup_cosine_decay(3e-3, 20)

    def module():
        if task == "det":
            m = DetModule(cfg, "disco", device="cpu", learning_rate=sched, width_mult=0.25)
        else:
            m = SegModule(cfg, "disco", device="cpu", learning_rate=sched, width_mult=0.25, depth=2)
        m.init_weights(0)
        return m

    whole, part = module(), module()
    for _ in range(3):
        whole.train_step(whole.prepare_batch(raw))
    for _ in range(2):
        part.train_step(part.prepare_batch(raw))
    path = save_checkpoint(str(tmp_path), part, 2)
    resumed = restore_checkpoint(path, module())
    assert resumed.step == 2
    resumed.train_step(resumed.prepare_batch(raw))
    assert resumed.optimizer.param_groups[0]["lr"] == sched(2) > sched(1) * 0.5
    for (name, got), want in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(got, want), name


def _tiny_args(pkg, extra):
    """Both tools' args for the tiny grid."""
    if pkg is bench_table:
        return bench_table.parse_args(TINY + extra)
    with _argv(["bench_table"] + TINY + extra):
        return jbt.parse_args()


@contextlib.contextmanager
def _argv(argv):
    saved = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = saved


def test_bake_pool_targets_matches_jax():
    jcfg = jbt.build_config(_tiny_args(jbt, []))
    cfg = bench_table.build_config(_tiny_args(bench_table, []))
    spec = bench_table.build_spec(_tiny_args(bench_table, []))
    pool = [generate_batch(cfg, spec, batch_size=2, seed=10_000 + i) for i in range(2)]
    jpool = [{k: v.copy() for k, v in raw.items()} for raw in pool]
    n = bench_table._bake_pool_targets(pool, cfg, torch.device("cpu"))
    assert n == jbt._bake_pool_targets(jpool, jcfg)
    for got, want in zip(pool, jpool):
        for key in ("pos_idx", "ign_idx", "tgt_cells", "tgt_wts"):
            assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
        assert got["tgt_wts"].dtype == torch.int8 and got["tgt_reg"].dtype == torch.bfloat16
        assert got["pos_idx"].dtype == torch.int32 and got["tgt_cells"].dtype == torch.int32
        want_reg = torch.tensor(np.asarray(want["tgt_reg"].astype(jnp.float32)))
        assert torch.equal(got["tgt_reg"].float(), want_reg)
        assert (got["pos_idx"] < n).sum() > 0


@pytest.fixture(scope="module")
def untrained(tmp_path_factory):
    """Det (upperbound) and seg (disco) rows of both tools from the JAX
    init trees, training off; the det states saved by both."""
    tmp = tmp_path_factory.mktemp("untrained")
    inits, cms = {}, {"jax": [], "port": []}

    def capture(cls):
        orig = cls.init

        def init(self, rng, batch):
            state = orig(self, rng, batch)
            inits[cls.__name__] = jax.tree.map(
                np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
            return state
        return init

    def recorder(fn, key):
        def wrapped(cm):
            cms[key].append(np.asarray(cm))
            return fn(cm)
        return wrapped

    det = ["--modes", "upperbound", "--steps", "0", "--lr", "0", "--match", "center"]
    seg = ["--task", "seg", "--modes", "disco", "--steps", "0", "--lr", "0", "--grid", "tiny1m",
           "--seg_depth", "2"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JaxDetModule, "init", capture(JaxDetModule))
        mp.setattr(JaxSegModule, "init", capture(JaxSegModule))
        mp.setattr(DetModule, "init_weights",
                   lambda self, seed: self.load_flax_variables(inits["DetModule"]))
        mp.setattr(SegModule, "init_weights",
                   lambda self, seed: self.load_flax_variables(inits["SegModule"]))
        import v2x_sim_tpu.utils.seg_metrics as jseg
        mp.setattr(jseg, "iou_from_confusion", recorder(jseg.iou_from_confusion, "jax"))
        mp.setattr(bench_table, "iou_from_confusion",
                   recorder(bench_table.iou_from_confusion, "port"))
        rows = {}
        for name, extra in (("det", det), ("seg", seg)):
            out = io.StringIO()
            states = ["--save_states", str(tmp / "jax_states")] if name == "det" else []
            with _argv(["bench_table"] + TINY + extra + states + ["--out", str(tmp / f"j_{name}.md")]):
                with contextlib.redirect_stdout(out):
                    jbt.main()
            jrow = [json.loads(line) for line in out.getvalue().splitlines()
                    if line.startswith('{"mode"')][-1]
            states = ["--save_states", str(tmp / "port_states")] if name == "det" else []
            prow = bench_table.main(TINY + extra + states + ["--out", str(tmp / f"p_{name}.md")])[0]
            rows[name] = (jrow, prow)
    finally:
        mp.undo()
    return {"rows": rows, "cms": cms, "tmp": tmp}


def test_untrained_det_row_matches_jax(untrained):
    jrow, prow = untrained["rows"]["det"]
    assert list(prow) == list(jrow)
    for key in ("mAP@1.0m", "mAP@2.0m"):
        assert abs(prow[key] - jrow[key]) <= 1e-6, (key, prow[key], jrow[key])
    assert jrow["mAP@2.0m"] > 0.0


def test_untrained_seg_confusion_matches_jax(untrained):
    jrow, prow = untrained["rows"]["seg"]
    assert list(prow) == list(jrow)
    jcm, pcm = untrained["cms"]["jax"], untrained["cms"]["port"]
    assert len(pcm) == 1 and len(jcm) >= 1
    np.testing.assert_array_equal(pcm[0], jcm[-1])
    assert pcm[0].sum() > 0
    assert (prow["mIoU"], prow["vehicle IoU"]) == (jrow["mIoU"], jrow["vehicle IoU"])


def test_track_table_reads_jax_pkl_like_jax(untrained, monkeypatch):
    tmp = untrained["tmp"]
    streams = []
    orig = jmot.evaluate_mot
    monkeypatch.setattr(jmot, "evaluate_mot", lambda *a, **k: streams.append(orig(*a, **k)) or streams[-1])
    common = ["--modes", "upperbound", "--grid", "tiny", "--width_mult", "0.25", "--seqs", "2",
              "--frames", "4", "--cpu"]
    out = io.StringIO()
    with _argv(["bench_table_track", "--states", str(tmp / "jax_states"), "--out",
                str(tmp / "jt.md")] + common), contextlib.redirect_stdout(out):
        jtrack.main()
    jrow = json.loads(out.getvalue().splitlines()[0])
    prow = bench_table_track.main(["--states", str(tmp / "jax_states"), "--out", str(tmp / "pt.md")]
                                  + common)[0]
    assert len(prow["streams"]) == len(streams) == 2 * 2
    for got, want in zip(prow["streams"], streams):
        for key in ("matches", "false_positives", "misses", "id_switches", "num_gt"):
            assert got[key] == want[key], key
        assert got["mota"] == pytest.approx(want["mota"], abs=1e-12)
    for key in ("mota", "motp", "hota", "det_a", "ass_a"):
        assert prow[key] == pytest.approx(jrow[key], abs=1e-4), key
    assert sum(m["num_gt"] for m in streams) > 0
    # The port's own .pt states load the same way.
    own = bench_table_track.main(["--states", str(tmp / "port_states"), "--out", str(tmp / "po.md")]
                                 + common)[0]
    assert len(own["streams"]) == 4 and np.isfinite(own["mota"])


@pytest.fixture(scope="module")
def trained(untrained, tmp_path_factory):
    """A few trained steps of disco+kd against the teacher JAX's untrained
    upperbound row saved as a .pkl, by both tools: their printed rows and
    their curves files."""
    tmp = tmp_path_factory.mktemp("trained")
    extra = ["--modes", "disco+kd", "--steps", "2", "--cosine", "--data_pool", "2",
             "--eval_at", "1", "--teacher_state", str(untrained["tmp"] / "jax_states" / "upperbound_seed0.pkl")]
    out = io.StringIO()
    with _argv(["bench_table"] + TINY + extra + ["--out", str(tmp / "J.md")]):
        with contextlib.redirect_stdout(out):
            jbt.main()
    jrows = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith('{"mode"')]
    (tmp / "j.log").write_text(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prows = bench_table.main(TINY + extra + ["--out", str(tmp / "P.md")])
    (tmp / "p.log").write_text(out.getvalue())
    return {"jrows": jrows, "prows": prows, "tmp": tmp}


def _curves(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_trained_rows_and_curves_have_jax_keys(trained):
    jrows, prows, tmp = trained["jrows"], trained["prows"], trained["tmp"]
    assert [list(r) for r in prows] == [list(r) for r in jrows]
    assert [r["mode"] for r in prows] == ["disco+kd"]
    assert prows[0]["teacher_s"] == 0.0  # the teacher is loaded, not trained
    for r in prows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "mode"), r
    jc, pc = _curves(tmp / "J_curves.jsonl"), _curves(tmp / "P_curves.jsonl")
    assert [list(c) for c in pc] == [list(c) for c in jc]
    assert [[list(e) for e in c["curve"]] for c in pc] == [[list(e) for e in c["curve"]] for c in jc]
    assert [[e["step"] for e in c["curve"]] for c in pc] == [[1, 2]]
    assert (pc[0]["kd_weight"], pc[0]["kd_reduce"]) == (jc[0]["kd_weight"], jc[0]["kd_reduce"])


def _without(text, *prefixes):
    return [line for line in text.splitlines() if not line.startswith(prefixes)]


def test_write_table_prints_jax_markdown(tmp_path):
    rows = [
        {"mode": "lowerbound", "mAP@0.5": 0.1234, "mAP@0.7": 0.05, "final_loss": 0.731,
         "train_s": 12.5, "steps_per_s": 8.0, "compile_s": 3.2, "teacher_s": 0.0, "eval_s": 1.0},
        {"mode": "disco+kd", "mAP@0.5": "0.2±0.01", "mAP@0.7": "0.1±0.02", "final_loss": 0.5,
         "train_s": 10.0, "steps_per_s": 10.0, "compile_s": 3.0, "teacher_s": 40.5, "eval_s": 1.0},
    ]
    for extra in ([], ["--seeds", "0,1", "--data_pool", "150", "--cosine", "--eval_at", "100,200"],
                  ["--task", "seg", "--seg_depth", "2"]):
        jargs, pargs = _tiny_args(jbt, extra), _tiny_args(bench_table, extra)
        with contextlib.redirect_stdout(io.StringIO()):
            jbt.write_table(rows, jargs, str(tmp_path / "j.md"))
            bench_table.write_table(rows, pargs, str(tmp_path / "p.md"), "CPU")
        want, got = (tmp_path / "j.md").read_text(), (tmp_path / "p.md").read_text()
        assert "Times (train_s, steps_per_s, compile_s, teacher_s) taken on: CPU." in got
        assert "`python -m v2x_sim_tpu_torch.tools.bench_table --task" in got
        # The device line and its blank line go; the Generated-by lines differ in the package.
        got_lines = _without(got, "Generated by", "Times (")
        assert got_lines[:3] == ["# Collaboration-mode benchmark (synthetic, per-agent occlusion)", "", ""]
        assert got_lines[3:] == _without(want, "Generated by")[2:]
        assert (_without(got, "Times (")[2].replace("v2x_sim_tpu_torch", "v2x_sim_tpu")
                == want.splitlines()[2])


def test_merge_and_assemble_print_jax_markdown(trained, tmp_path):
    tmp = trained["tmp"]
    # The repo's committed JAX curves, and this run's curves of both packages.
    for paths in (["BENCH_TABLE_FULL_curves.jsonl", "BENCH_TABLE_FULL_SEED1_curves.jsonl"],
                  [str(tmp / "J_curves.jsonl"), str(tmp / "P_curves.jsonl")],
                  [str(tmp / "P_curves.jsonl")]):
        want = jmerge.render(jmerge.load_records(paths), paths, "note")
        got = bench_table_merge.render(bench_table_merge.load_records(paths), paths, "note")
        assert got == want
        with contextlib.redirect_stdout(io.StringIO()):
            bench_table_merge.main(["--curves", ",".join(paths), "--out", str(tmp_path / "m.md"),
                                    "--note", "note"])
        assert (tmp_path / "m.md").read_text() == want
    logs = f"{tmp / 'j.log'},{tmp / 'p.log'}"
    curves = f"{tmp / 'J_curves.jsonl'},{tmp / 'P_curves.jsonl'}"
    common = ["--logs", logs, "--curves", curves, "--header", "protocol"]
    with contextlib.redirect_stdout(io.StringIO()):
        with _argv(["assemble"] + common + ["--out", str(tmp_path / "ja.md"),
                                            "--curves_out", str(tmp_path / "ja.jsonl")]):
            jassemble.main()
        bench_table_assemble.main(common + ["--out", str(tmp_path / "pa.md"),
                                            "--curves_out", str(tmp_path / "pa.jsonl")])
    assert (tmp_path / "pa.md").read_text() == (tmp_path / "ja.md").read_text()
    assert (tmp_path / "pa.jsonl").read_text() == (tmp_path / "ja.jsonl").read_text()
    assert "| disco+kd |" in (tmp_path / "pa.md").read_text()
