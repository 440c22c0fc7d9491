"""The port's nuScenes-format writer (``datasets/nuscenes_writer.py``)
against the JAX package's, on the CPU.

Tokens are ``uuid4``, so two writes never share them: both writers take
the same seed and knobs, and both roots are read back by the port's
reader and by JAX's, with seg labels. The frames (matched by
their contents, since the readers order scenes by token) must hold equal points,
boxes, masks, transforms and labels, and the instance ids one
numbering of the other; the JSON tables must be equal once every token
is replaced by its first-appearance index.
"""

import json

import numpy as np
import pytest

from v2x_sim_tpu.datasets.nuscenes import V2XSimDataset as JaxV2XSimDataset
from v2x_sim_tpu.datasets.nuscenes_writer import write_synthetic_nuscenes as jax_write
from v2x_sim_tpu.datasets.synthetic import SyntheticSpec as JaxSpec
from v2x_sim_tpu_torch.datasets.nuscenes import V2XSimDataset
from v2x_sim_tpu_torch.datasets.nuscenes_writer import write_synthetic_nuscenes
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec
from tests.test_torch_data import NUSC_CFG, _jax_config

SPEC = dict(num_vehicles=5, points_per_agent=512, max_gt=8)
#: Writer knobs: the plain root and the irregular records of real logs.
KNOBS = {
    "plain": {},
    "irregular": {"present_agents": (1, 2), "sweep_rows": 2, "duplicate_keyframes": True},
}


def _roots(tmp_path, knobs):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jax_write(str(jroot), _jax_config(NUSC_CFG), JaxSpec(**SPEC), num_scenes=2,
              frames_per_scene=2, seed=3, **knobs)
    assert write_synthetic_nuscenes(str(proot), NUSC_CFG, SyntheticSpec(**SPEC), num_scenes=2,
                                    frames_per_scene=2, seed=3, **knobs) == str(proot)
    return jroot, proot


def _untokened(root):
    """Every JSON table under ``root`` with each token string replaced by
    the index of its first appearance (tables in name order)."""
    index = {}

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, str) and len(x) == 32 and all(c in "0123456789abcdef" for c in x):
            return f"tok{index.setdefault(x, len(index))}"
        if isinstance(x, str):  # file names embed the scene token
            for t, i in index.items():
                x = x.replace(t, f"tok{i}")
        return x

    return {p.relative_to(root).as_posix(): walk(json.loads(p.read_text()))
            for p in sorted(root.rglob("*.json"))}


def _frames(ds):
    """A reader's frames keyed by the bytes of every array but the
    instance ids (a scene's frames differ only in their seg labels, the
    map staying put as the agents drift): the readers order scenes and
    number instances by token, so the two roots list the same frames in
    another order."""
    frames = [ds[i] for i in range(len(ds))]
    return {b"".join(np.ascontiguousarray(v).tobytes() for k, v in sorted(f.items()) if k != "gt_ids"): f
            for f in frames}


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_port_writer_writes_the_jax_scenes(tmp_path, knobs):
    jroot, proot = _roots(tmp_path, KNOBS[knobs])
    assert _untokened(proot) == _untokened(jroot)
    kw = dict(max_points=512, max_gt=8, with_seg_labels=True)
    want = _frames(JaxV2XSimDataset(str(jroot), _jax_config(NUSC_CFG), **kw))
    assert len(want) == 4
    for name, root in (("jax", jroot), ("port", proot)):
        for reader, ds in (("port", V2XSimDataset(str(root), NUSC_CFG, **kw)),
                           ("jax", JaxV2XSimDataset(str(root), _jax_config(NUSC_CFG), **kw))):
            got = _frames(ds)
            assert got.keys() == want.keys(), (name, reader)
            ids = {}  # the instance numbering of one root against the other's
            for key, w in want.items():
                g = got[key]
                assert g.keys() == w.keys()
                for field in w:
                    if field == "gt_ids":
                        for a, b in zip(g[field].ravel(), w[field].ravel()):
                            assert ids.setdefault(int(a), int(b)) == int(b), (name, reader)
                    else:
                        np.testing.assert_array_equal(g[field], w[field],
                                                      err_msg=f"{name} root, {reader} reader: {field}")
            assert len(set(ids.values())) == len(ids)  # one-to-one
    f0 = next(iter(want.values()))
    if knobs == "irregular":  # only agents 1 and 2 have lidar; keyframes, not decoys, are read
        assert f0["agent_mask"].tolist() == [False, True, True]
        assert f0["point_mask"][1:].sum(axis=1).min() > 0
    assert f0["gt_mask"].any() and (f0["seg_labels"] >= 0).any()
