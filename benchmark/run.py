"""The port's benchmark: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic
mix, limits and per-layer metrics are found by name from
``BENCHMARK.json`` (see ``benchmark/README.md``). The run makes its inputs
and weights from the seed, warms up the cell's own calls, measures for
``--seconds`` seconds, checks the outputs against the plain reference and
prints one JSON line last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from an
untraced stretch and a profiled one. Each number compared with the
reference is printed beside its limit on standard error, last.

It exits non-zero, printing no result, without a CUDA card, or when JAX
or the JAX package has been loaded by the end of the run.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "v2x_sim_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    Python's bytecode too: where the installed packages hold no bytecode
    of their own, every run would compile the sources of the modules the
    port imports (``torch.distributed``, dynamo, sympy) anew."""
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False  # written only under the prefix
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell, roofline

    marks = [("imports", time.time())]

    chips = next(w["chips"] for w in cell.load_json(ROOT / "BENCHMARK.json")["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)
    torch.zeros(1, device=device)
    marks.append(("cuda", time.time()))
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, T0,
                           peaks=roofline.PEAKS.get(card), marks=marks)
    found = forbidden_modules()
    if found:
        print(f"run: the process loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
