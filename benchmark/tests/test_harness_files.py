"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, limits and per-layer readers are found by name; names and
units use the allowed characters; each per-layer metric's end-to-end
metric is one its cells report; nothing under benchmark/ imports JAX or
the JAX package, the reference imports nothing of the port, and only the
harness's program module imports the port."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py" and (ROOT / SPEC["command"][1]).is_file()
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    from benchmark.harness.cell import load_cell

    c = load_cell(cell)
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert c.kind in ("train", "predict")
    for part in ("reference.py", "flops.py", "config.json"):
        assert (c.config_dir / part).is_file()
    assert c.config["name"] == w["config"]
    assert c.limits and all("limit" in v for v in c.limits.values())
    for m in c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


def test_names_units_and_sources():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        listed = [x["name"] for x in SPEC[kind]]
        assert len(listed) == len(set(listed))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    from benchmark.harness.cell import load_cell

    for m in SPEC["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in load_cell(cell).end_to_end}, (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module)
        elif (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            roots.add(str(node.args[0].value))
    return roots


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "optax", "v2x_sim_tpu"}, path


#: Originals of the harness's frozen copies, which the tests hold the copies to.
ORIGINALS = {"v2x_sim_tpu_torch.tools.xprof_det"}


def test_only_the_program_module_and_the_tests_import_the_port():
    for path in FILES:
        mods = _imports(path)
        port = {m for m in mods if m.split(".")[0] == "v2x_sim_tpu_torch"}
        rel = path.relative_to(BENCH)
        if rel.parts[0] == "tests":
            mods = mods - ORIGINALS
        assert not {m for m in mods if m.startswith(("v2x_sim_tpu_torch.bench",
                                                     "v2x_sim_tpu_torch.baselines",
                                                     "v2x_sim_tpu_torch.tools"))} | (
            {m for m in mods if m.split(".")[0] == "chip_smoke"}), path
        if rel.parts[0] != "tests" and rel != Path("harness/program.py"):
            assert not port, path
    refs = list((BENCH / "reference").glob("*.py")) + list((BENCH / "configs").rglob("*.py"))
    assert len(refs) >= 7
