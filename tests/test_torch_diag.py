"""The port's diagnostic tools against the JAX package's, on the CPU.

  * The ConvGRU diagnostics tap (``models/convrnn.py::gru_diagnostics``):
    V2VNet's per-round gate statistics equal the JAX cell's sown
    ``diagnostics`` within 1e-5 (same inputs and flax parameters as
    ``tests/test_torch_fusion.py``); outside the tap nothing is recorded
    and the output is the same. ``diag_v2v.gru_probe`` on a tiny v2v
    detector from a JAX init tree matches the JAX tool's probe (the
    model's ``apply`` with ``mutable=["diagnostics"]``), and the tool's
    ``main`` prints one finite row per round at every probe.
  * ``diag_upperbound``: the probe record at step 0 of the JAX tool's
    ``run_modes`` (upperbound, tiny grid, baked pool) from the same init
    tree as the port's: losses, gradient norms and score statistics
    within 1e-4 (relative), the mAPs equal. After two training steps, a
    probe leaves the port's parameters, buffers and Adam state
    bit-identical.
"""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.det.v2vnet import V2VNetFusion as JaxV2V
from v2x_sim_tpu.tools import bench_table as jbt
from v2x_sim_tpu.tools import diag_upperbound as jdiag
from v2x_sim_tpu.datasets.synthetic import generate_batch as jax_generate_batch
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
from v2x_sim_tpu_torch.models.convrnn import GRU_STATS, ConvGRUCell, gru_diagnostics
from v2x_sim_tpu_torch.models.det.v2vnet import V2VNetFusion
from v2x_sim_tpu_torch.tools import bench_table, diag_upperbound, diag_v2v
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.test_torch_fusion import GRID, JGRID, C, _inputs, _jax_module, _to_port
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

TINY = ["--grid", "tiny", "--agents", "2", "--width_mult", "0.25", "--batch", "2", "--cpu"]


@contextlib.contextmanager
def _argv(argv):
    saved = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = saved


def test_gru_tap_matches_jax_sown_diagnostics():
    feats, trans, mask = _inputs(seed=3)
    jmod = JaxV2V(JGRID)
    params, want_out = _jax_module(jmod, feats, trans, mask, False, seed=3)
    args = (jnp.asarray(feats), jnp.asarray(trans), jnp.asarray(mask))
    _, diag = jmod.apply({"params": params}, *args, train=False, mutable=["diagnostics"])
    want = np.stack([np.asarray(x) for x in jax.tree.leaves(diag["diagnostics"])])
    module = _to_port(V2VNetFusion(GRID, C), params)
    inputs = (torch.from_numpy(feats), torch.from_numpy(trans), torch.from_numpy(mask))
    with torch.no_grad():
        plain = module(*inputs)
        with gru_diagnostics(module) as rows:
            tapped = module(*inputs)
    got = torch.stack(rows).numpy()
    assert got.shape == want.shape == (3, len(GRU_STATS)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert torch.equal(plain, tapped)
    np.testing.assert_allclose(plain.numpy(), want_out, rtol=0, atol=2e-5)
    assert all(m.diagnostics is None for m in module.modules() if isinstance(m, ConvGRUCell))
    assert 0.0 < got[:, 0].min() and got[:, 0].max() < 1.0  # z means off the rails


def test_diag_v2v_probe_matches_jax_tool():
    with _argv(["diag_v2v"] + TINY):
        jargs = jbt.parse_args()
    jcfg, jspec = jbt.build_config(jargs), jbt.build_spec(jargs)
    jmod = JaxDetModule(jcfg, mode="v2v", width_mult=0.25)
    raw = jax_generate_batch(jcfg, jspec, batch_size=2, seed=990_000)
    batch = {k: jnp.asarray(v) for k, v in raw.items() if k not in ("visible", "gt_vehicle", "seg_labels")}
    state = jmod.init(jax.random.PRNGKey(0), batch)
    occ = jmod.occupancy_from_points(batch["points"], batch["point_mask"])
    _, diag = jmod.model.apply({"params": state.params, "batch_stats": state.batch_stats}, occ,
                               batch["trans"], batch["agent_mask"], train=False,
                               mutable=["diagnostics"])
    want = np.stack([np.asarray(x) for x in jax.tree.leaves(diag["diagnostics"])])

    args = bench_table.parse_args(TINY)
    cfg, spec = bench_table.build_config(args), bench_table.build_spec(args)
    port = DetModule(cfg, "v2v", device="cpu", width_mult=0.25)
    port.load_flax_variables(jax.tree.map(np.asarray, {"params": state.params,
                                                       "batch_stats": state.batch_stats}))
    bt = port.to_device(generate_batch(cfg, spec, batch_size=2, seed=990_000))
    got = diag_v2v.gru_probe(port, {"occupancy": port.model_input(bt), "trans": bt["trans"],
                                    "agent_mask": bt["agent_mask"]}).numpy()
    assert got.shape == want.shape == (3, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_diag_v2v_main_prints_finite_rounds():
    with contextlib.redirect_stdout(io.StringIO()):
        records = diag_v2v.main(TINY + ["--steps", "2", "--probe_every", "1"])
    assert [r["step"] for r in records] == [0, 1, 2]
    assert records[0]["loss"] is None and np.isfinite(records[-1]["loss"])
    for r in records:
        assert len(r["gru_rounds"]) == 3
        assert all(list(row) == list(GRU_STATS) and np.isfinite(list(row.values())).all()
                   for row in r["gru_rounds"])


UB = TINY + ["--modes", "upperbound", "--steps", "0", "--probe_every", "1", "--data_pool", "2",
             "--eval_batches", "1"]


def test_diag_upperbound_probe_matches_jax(monkeypatch, tmp_path):
    inits = {}
    orig = JaxDetModule.init

    def init(self, rng, batch):
        state = orig(self, rng, batch)
        inits["tree"] = jax.tree.map(np.asarray, {"params": state.params,
                                                  "batch_stats": state.batch_stats})
        return state

    monkeypatch.setattr(JaxDetModule, "init", init)
    monkeypatch.setattr(DetModule, "init_weights",
                        lambda self, seed: self.load_flax_variables(inits["tree"]))
    with _argv(["diag_upperbound"] + UB):
        jargs = jdiag.parse_args()
    jcfg, jspec = jbt.build_config(jargs), jbt.build_spec(jargs)
    jheld = [jax_generate_batch(jcfg, jspec, batch_size=2, seed=900_000)]
    want = []
    with contextlib.redirect_stdout(io.StringIO()):
        jdiag.run_modes("upperbound", jargs, "", jcfg, jspec, {}, jheld, want.append)
    with contextlib.redirect_stdout(io.StringIO()):
        got = diag_upperbound.main(UB + ["--out", str(tmp_path / "d.jsonl")])
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert list(got) == list(want)
    assert (got["mode"], got["step"]) == ("upperbound", 0)
    for key, w in want.items():
        if key.startswith("map_"):
            assert got[key] == w, key
        elif key not in ("mode", "step"):
            assert got[key] == pytest.approx(w, rel=1e-4, abs=1e-4), key
    assert (tmp_path / "d.jsonl").read_text().count("\n") == 1


def test_diag_probe_moves_no_state():
    args = diag_upperbound.parse_args(UB)
    args.device = torch.device("cpu")
    cfg, spec = bench_table.build_config(args), bench_table.build_spec(args)
    mod = DetModule(cfg, "upperbound", device="cpu", width_mult=0.25, learning_rate=3e-3)
    mod.init_weights(0)
    stream = bench_table._train_stream(args, cfg, spec, 0, {})
    for s in range(2):
        mod.train_step(mod.prepare_batch(stream(s)))
    held = [generate_batch(cfg, spec, batch_size=2, seed=900_000)]
    state = {k: v.clone() for k, v in mod.model.state_dict().items()}
    opt = {i: {k: v.clone() for k, v in s.items()} for i, s in enumerate(mod.optimizer.state.values())}
    grads = [None if p.grad is None else p.grad.clone() for p in mod.model.parameters()]
    rec = diag_upperbound.probe_record(mod, held, [mod.prepare_batch(h) for h in held],
                                       [stream(0)], args)
    assert rec["held_cls_loss_bat"] != rec["held_cls_loss_run"]  # train-mode BN did run
    for k, v in mod.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    for i, s in enumerate(mod.optimizer.state.values()):
        for k, v in s.items():
            assert torch.equal(v, opt[i][k]), (i, k)
    for p, g in zip(mod.model.parameters(), grads):
        assert (p.grad is None and g is None) or torch.equal(p.grad, g)
    assert mod.step == 2
