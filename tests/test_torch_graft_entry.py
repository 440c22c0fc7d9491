"""The port's counterpart of the root ``__graft_entry__.py``
(``v2x_sim_tpu_torch/graft_entry.py``), on the CPU.

``entry()``: JAX's example arguments and variables, the latter carried
across through ``bridge.state_dict_from_flax``, give the port's forward
JAX's ``cls_logits``/``reg`` (fp32, JAX's default s2d execution) within
atol 1e-4, and the port's own example arguments are JAX's.
``dryrun_multichip(4, device="cpu")``: four gloo ranks step the five
variants of JAX's dry run and print its five lines; a failing rank
raises.
"""

import ast

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from v2x_sim_tpu_torch import graft_entry
from v2x_sim_tpu_torch.bridge import state_dict_from_flax
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ATOL = 1e-4
DRYRUN_LINES = ("dryrun disco+kd ok:", "dryrun mgda ok:", "dryrun gspmd dp x spatial ok:",
                "dryrun seg dp ok:", "dryrun gspmd seg dp x spatial ok:")


def test_entry_matches_the_jax_entry_on_carried_weights():
    jfn, (jvars, jocc, jtrans, jmask) = jax_entry.entry()
    fn, (model, occ, trans, mask) = graft_entry.entry(device="cpu")
    # The same scene, voxelized alike, and the same model shape.
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(trans.numpy(), np.asarray(jtrans))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    model.load_state_dict(state_dict_from_flax(jvars, "disco"), strict=True)
    want = jfn(jvars, jocc, jtrans, jmask)
    got = fn(model, *(torch.from_numpy(np.array(x)) for x in (jocc, jtrans, jmask)))
    for g, w, name in zip(got, want, ("cls_logits", "reg")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL, err_msg=name)
        assert np.abs(w).max() > 10 * ATOL, name  # the comparison is not of near-zeros


def test_entry_uses_flax_default_weights_in_inference_mode():
    fn, (model, occ, trans, mask) = graft_entry.entry(device="cpu")
    assert model.mode == "disco" and not model.training
    assert occ.shape == (1, 6, 64, 64, 8) and occ.dtype == torch.float32
    cls, reg = fn(model, occ, trans, mask)
    assert cls.shape == (1, 6, 64, 64, 6, 2) and reg.shape == (1, 6, 64, 64, 6, 6)
    assert not cls.requires_grad
    # Inference semantics: the running stats do not move.
    before = [b.clone() for b in model.buffers()]
    fn(model, occ, trans, mask)
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    # flax's defaults: zero biases, unit BatchNorm scales.
    assert float(model.cls_head.conv1.bias.detach().abs().max()) == 0.0
    assert float(model.encoder.blocks[0].bn1.weight.detach().min()) == 1.0


def test_dryrun_multichip_on_cpu_prints_the_five_variants(capsys):
    graft_entry.dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split("{")[0].strip() for ln in lines] == list(DRYRUN_LINES)
    assert lines[2].endswith("devices: 4")
    for line in lines:
        metrics = ast.literal_eval(line[line.index("{"):line.index("}") + 1])
        assert "loss" in metrics and all(np.isfinite(v) for v in metrics.values())
    assert "kd_loss" in lines[0] and "mgda_w_cls_loss" in lines[1]


def test_dryrun_multichip_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank .* failed"):
        graft_entry.dryrun_multichip(3, device="cpu")  # 3 ranks do not split over spatial 2
