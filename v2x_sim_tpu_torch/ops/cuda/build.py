"""Build the port's CUDA sources into shared libraries with a plain C ABI.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the repo root (the hash covers the
source and the flags, so an edited source rebuilds) and loads with
``ctypes``. Nothing is built when a module is imported: the first call of
a kernel wrapper builds its library, and ``build`` compiles several
sources at once, one ``nvcc`` process each. A source from another
directory (another version of a kernel, to time against this one) builds
the same way, named by its content hash. The kernel wrappers share
``on_cpu`` (which route a call takes) and ``raise_on_error`` (the C
entries' return code).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: No --use_fast_math: the kernels keep IEEE division and precise sinf/cosf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class Built(NamedTuple):
    """A compiled library and what nvcc/ptxas printed when it was built
    (registers, spills), kept beside it as ``<name>-<hash>.log``."""

    path: Path
    log: str


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str], csrc: Path = CSRC) -> Dict[str, Built]:
    """Compile the named sources of `csrc` (all nvcc processes started
    together); raises RuntimeError with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, Built] = {}
    for name in names:
        so = library_path(name, csrc)
        if so.exists():
            log = so.with_suffix(".log")
            out[name] = Built(so, log.read_text() if log.exists() else "")
            continue
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
        out[name] = Built(so, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.cache
def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Build ``<csrc>/<name>.cu`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build([name], csrc)[name].path))


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the wrapper takes the plain
    version); raises on a mix of devices or on a device that is neither
    CPU nor CUDA."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def raise_on_error(rc: int, what: str) -> None:
    """Raises when a C entry returned a cudaError_t other than 0."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
