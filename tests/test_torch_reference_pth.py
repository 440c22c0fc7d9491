"""The reference's ``.pth`` into the port (``train/torch_convert.py``),
on the CPU.

A state dict of the JAX package's PyTorch reference graph
(``v2x_sim_tpu.baselines.torch_ref``, random weights, random BN running
stats) is saved under a temporary directory, bare and in the reference's
``{"model_state_dict": ...}`` and ``{"state_dict": ...}`` wrappers, and
loaded into the port's ``DetModel``. Its eval logits must match the
reference model's forward and the JAX ``DetModel`` fed the same file
through ``v2x_sim_tpu.train.torch_convert``, at
tests/test_reference_parity.py's atol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.baselines.torch_ref import build_model
from v2x_sim_tpu.baselines.torch_ref import key_map as jax_key_map
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.train.torch_convert import convert_state_dict
from v2x_sim_tpu.train.torch_convert import load_pth as jax_load_pth
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train import torch_convert
from tests.test_reference_parity import _inputs, _randomize_bn_stats
from tests.test_torch_model import CFG, JCFG
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ATOL = 2e-4
WRAPPERS = {"bare": None, "model_state_dict": "model_state_dict", "state_dict": "state_dict"}


def _reference(mode, seed):
    torch.manual_seed(seed)
    ref = build_model(CFG.grid.grid_shape, CFG.grid.area_extents, CFG.anchors.num_anchors,
                      CFG.num_classes, CFG.anchors.box_code_size, CFG.fusion_layer)(mode=mode).eval()
    _randomize_bn_stats(ref)
    return ref


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
@pytest.mark.parametrize("mode", ["lowerbound", "disco"])
def test_reference_pth_loads_into_the_port(tmp_path, mode, wrapper):
    ref = _reference(mode, seed=3)
    path = str(tmp_path / "reference.pth")
    sd = ref.state_dict()
    torch.save(sd if WRAPPERS[wrapper] is None else {WRAPPERS[wrapper]: sd, "epoch": 7}, path)

    model = DetModel(CFG, mode).eval()
    torch_convert.load_reference(model, path)
    occ, trans, mask = _inputs(seed=2)
    with torch.no_grad():
        want_cls, want_reg = ref(torch.from_numpy(occ.transpose(0, 1, 4, 2, 3)),
                                 torch.from_numpy(trans), torch.from_numpy(mask))
        got = model(torch.from_numpy(occ), torch.from_numpy(trans), torch.from_numpy(mask))
    jax_out = JaxDetModel(config=JCFG, mode=mode, s2d=False).apply(
        convert_state_dict(jax_load_pth(path), jax_key_map(mode)),
        jnp.asarray(occ), jnp.asarray(trans), jnp.asarray(mask), train=False)
    for got_t, ref_t, jax_t in ((got.cls_logits, want_cls, jax_out.cls_logits),
                                (got.reg, want_reg, jax_out.reg)):
        np.testing.assert_allclose(got_t.numpy(), ref_t.numpy(), atol=ATOL)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(jax_t), atol=ATOL)
    # Every parameter and running stat is the file's, bit for bit.
    mine = model.state_dict()
    for key, value in sd.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(mine[key], value), key


def test_renaming_table_and_unmapped_keys():
    sd = _reference("lowerbound", seed=4).state_dict()
    # A checkpoint whose heads are named otherwise loads through a table edit.
    renamed = {k.replace("cls_head.", "classifier."): v for k, v in sd.items()}
    table = {(p.replace("cls_head.", "classifier.") if p.startswith("cls_head.") else p): p
             for p in {k.rpartition(".")[0] for k in sd}}
    out = torch_convert.state_dict_from_reference(renamed, table)
    assert not any(k.endswith("num_batches_tracked") for k in out)
    assert sorted(out) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    with pytest.raises(KeyError, match="classifier"):
        torch_convert.state_dict_from_reference(renamed, mode="lowerbound")
    # A disco checkpoint's fusion has no module in a lowerbound model.
    with pytest.raises(KeyError, match="fusion"):
        torch_convert.state_dict_from_reference(_reference("disco", seed=4).state_dict(),
                                                mode="lowerbound")
