"""The ``fusion`` keyword of ``DetModule`` and ``DetModel``: a fusion
module's settings under a configuration's names, handed to
``models/det/net.py::build_fusion``. For every mode with a fusion module,
a model built with the keyword at its defaults has the state-dict keys
and shapes of one built without it, and the listed defaults are the
constructor's own; a setting away from its default
reaches the module; and a key the mode does not take raises."""

import inspect

import pytest
import torch

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.det.net import FUSION_KEYWORDS, NO_FUSION, PORT_MODES, DetModel
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

CFG = Config()
WIDTH = 0.25
FUSED = sorted(FUSION_KEYWORDS)


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _model(mode, **kw):
    with torch.device("meta"):
        return DetModel(CFG, mode, WIDTH, **kw)


def test_every_mode_with_a_fusion_module_is_listed():
    built = {m for m in PORT_MODES if _model(m).fusion is not None}
    assert built == set(FUSED)
    assert not set(FUSED) & set(NO_FUSION)


@pytest.mark.parametrize("mode", FUSED)
def test_the_keyword_at_its_defaults_builds_the_same_module(mode):
    assert _shapes(_model(mode, fusion=dict(FUSION_KEYWORDS[mode]))) == _shapes(_model(mode))


#: A configuration's name for a constructor keyword, where the two differ.
CONSTRUCTOR_NAMES = {"edge_hidden": "hidden"}


@pytest.mark.parametrize("mode", FUSED)
def test_the_listed_defaults_are_the_constructors(mode):
    init = inspect.signature(type(_model(mode).fusion).__init__).parameters
    for key, value in FUSION_KEYWORDS[mode].items():
        assert init[CONSTRUCTOR_NAMES.get(key, key)].default == value, key


@pytest.mark.parametrize("mode, fusion, path, want", [
    ("disco", {"edge_hidden": 16}, "edge_hidden.out_channels", 16),
    ("agent", {"hidden": 8}, "score_hidden.out_features", 8),
    ("v2v", {"rounds": 2}, "rounds", 2),
    ("v2v", {"msg_norm": True}, "msg_norm.num_channels", 64),
    ("when2com", {"warp_flag": False}, "warp_flag", False),
    ("v2xvit", {"depth": 2}, "layers.__len__", 2),
    ("v2xvit", {"window_sizes": [2, 4, 8]}, "layers.0.mswin.windows.2.window", 8),
    ("cobevt", {"depth": 2}, "layers.__len__", 2),
    ("cobevt", {"window_size": 4}, "layers.0.grid_attn.window", 4),
    ("cobevt", {"dim_head": 16}, "layers.0.local_attn.heads", 4),
])
def test_a_setting_reaches_the_module(mode, fusion, path, want):
    got = _model(mode, fusion=fusion).fusion
    for part in path.split("."):
        got = getattr(got, part)
    assert (got() if callable(got) else got) == want


@pytest.mark.parametrize("mode, fusion", [
    ("disco", {"hidden": 32}),
    ("v2v", {"window": 4}),
    ("cat", {"edge_hidden": 32}),
    ("v2xvit", {"rounds": 3}),
    ("cobevt", {"heads": 8}),
    ("mean", {"edge_hidden": 32}),
    ("lowerbound", {"depth": 3}),
])
def test_an_unknown_key_raises(mode, fusion):
    with pytest.raises(ValueError, match="takes no fusion setting"):
        _model(mode, fusion=fusion)
