"""The port stands alone: nothing under v2x_sim_tpu_torch/, chip_smoke.py
nor bench_torch.py imports JAX, flax or the JAX package, and its entry
points refuse to run without a card unless asked for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "v2x_sim_tpu"}


def _port_files():
    return sorted((ROOT / "v2x_sim_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "bench_torch.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"v2x_sim_tpu_torch/ops/assign.py", "v2x_sim_tpu_torch/utils/losses.py",
            "v2x_sim_tpu_torch/train/det_module.py", "v2x_sim_tpu_torch/bridge.py"} <= names
    # Every subpackage is scanned: the tools, the native reader's bindings,
    # the data readers and the evaluation utilities among them.
    for sub in ("tools", "native", "datasets", "utils", "train", "models", "ops", "tracking",
                "parallel", "baselines"):
        assert any(n.startswith(f"v2x_sim_tpu_torch/{sub}/") for n in names), sub
    assert {"v2x_sim_tpu_torch/tools/train_det.py", "v2x_sim_tpu_torch/tools/test_det.py",
            "v2x_sim_tpu_torch/tools/create_data_det.py", "v2x_sim_tpu_torch/tools/common.py",
            "v2x_sim_tpu_torch/native/loader.py", "v2x_sim_tpu_torch/datasets/loader.py",
            "v2x_sim_tpu_torch/datasets/cache.py", "v2x_sim_tpu_torch/datasets/nuscenes.py",
            "v2x_sim_tpu_torch/utils/mean_ap.py", "v2x_sim_tpu_torch/utils/meters.py",
            "v2x_sim_tpu_torch/train/checkpoint.py", "v2x_sim_tpu_torch/models/seg/unet.py",
            "v2x_sim_tpu_torch/train/seg_module.py", "v2x_sim_tpu_torch/utils/seg_metrics.py",
            "v2x_sim_tpu_torch/utils/mapping.py", "v2x_sim_tpu_torch/datasets/nuscenes_map.py",
            "v2x_sim_tpu_torch/tools/create_data_seg.py", "v2x_sim_tpu_torch/tools/train_seg.py",
            "v2x_sim_tpu_torch/tools/test_seg.py", "v2x_sim_tpu_torch/tools/track.py",
            "v2x_sim_tpu_torch/tracking/sort.py", "v2x_sim_tpu_torch/tracking/mot_metrics.py",
            "v2x_sim_tpu_torch/ops/iou_host.py", "v2x_sim_tpu_torch/ops/visibility.py",
            "v2x_sim_tpu_torch/utils/mgda.py", "v2x_sim_tpu_torch/tools/bench_table.py",
            "v2x_sim_tpu_torch/tools/bench_table_assemble.py",
            "v2x_sim_tpu_torch/tools/bench_table_merge.py",
            "v2x_sim_tpu_torch/tools/bench_table_track.py", "v2x_sim_tpu_torch/tools/diag_v2v.py",
            "v2x_sim_tpu_torch/tools/diag_upperbound.py", "v2x_sim_tpu_torch/tools/xprof_det.py",
            "v2x_sim_tpu_torch/tools/bench_loader.py", "v2x_sim_tpu_torch/utils/spans.py",
            "v2x_sim_tpu_torch/parallel/mesh.py", "v2x_sim_tpu_torch/parallel/spatial.py",
            "v2x_sim_tpu_torch/datasets/nuscenes_writer.py",
            "v2x_sim_tpu_torch/train/torch_convert.py", "v2x_sim_tpu_torch/bench.py",
            "v2x_sim_tpu_torch/graft_entry.py", "v2x_sim_tpu_torch/baselines/torch_ref.py",
            "bench_torch.py"} <= names
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN) for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_import_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\nimport jax.numpy as jnp\nfrom v2x_sim_tpu.ops import nms\n"
        "from flax import linen\nimport importlib\nimportlib.import_module('optax')\n"
    )
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "v2x_sim_tpu", "flax", "optax"}


def test_entry_points_raise_without_a_card(monkeypatch):
    from v2x_sim_tpu_torch import bench, graft_entry, resolve_device
    from v2x_sim_tpu_torch.baselines import torch_ref
    from v2x_sim_tpu_torch.configs.config import Config
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetModule(Config(), "disco")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegModule(Config(), "disco")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetModule(Config(), "disco", use_vis=True, mgda=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    occ, trans = torch.zeros(1, 1, 4, 4, 2), torch.eye(4).expand(1, 1, 1, 4, 4)
    mask = torch.ones(1, 1)
    for entry_point in (bench.run, graft_entry.entry, lambda: graft_entry.dryrun_multichip(2),
                        lambda: torch_ref.measure(occ, trans, mask)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry_point()
    assert resolve_device("cpu") == torch.device("cpu")
    fn, (model, occ, _, _) = graft_entry.entry(device="cpu")
    assert occ.device.type == "cpu" and next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("mode", ["upperbound", "v2v", "when2com"])
def test_every_mode_constructs(mode):
    """These modes construct as DetModel, DetModule, SegModel and
    SegModule, and an unknown mode raises ValueError."""
    from v2x_sim_tpu_torch.configs.config import Config
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.models.seg.unet import SegModel
    from v2x_sim_tpu_torch.train.det_module import DetModule
    from v2x_sim_tpu_torch.train.seg_module import SegModule

    assert DetModel(Config(), mode).mode == mode
    assert DetModule(Config(), mode, device="cpu").mode == mode
    assert SegModel(Config(), mode).mode == mode
    assert SegModule(Config(), mode, device="cpu").mode == mode
    for model in (DetModel, SegModel):
        with pytest.raises(ValueError, match="unknown mode"):
            model(Config(), mode + "_x")
