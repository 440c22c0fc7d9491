"""ctypes bindings for the native threaded .pcd.bin batch reader.

The port's own copy of ``v2x_sim_tpu/native/loader.py`` and its
``loader.cpp``. The library is built with ``g++`` on first use into
``build/native/libv2xloader-<hash>.so`` at the repo root (git-ignored;
the hash covers the source and the flags, so an edited source rebuilds,
and the file is renamed into place so that concurrent processes never
load a partial one). It is built without ``-march=native``, so a build
directory copied to another host still loads there.

Where no compiler is found, or the library does not load, the reader
falls back to a numpy loop: it is host I/O (multi-core, GIL-free), not a
device path, and both give the same arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libv2xloader-{digest}.so"


@functools.cache
def _lib() -> Optional[ctypes.CDLL]:
    """The built library with its C signature declared, or None when it
    cannot be built or loaded."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:  # a corrupt or foreign binary: take the numpy path
        return None
    lib.v2x_read_pcd_batch.restype = ctypes.c_int64
    lib.v2x_read_pcd_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int32,
    ]
    return lib


def native_available() -> bool:
    return _lib() is not None


def read_pcd_batch(
    paths: List[str],
    max_points: int,
    stride_floats: int = 5,
    transforms: Optional[np.ndarray] = None,
    n_threads: int = 0,
):
    """Read a batch of .pcd.bin sweeps into padded buffers.

    Args:
      paths: list of file paths.
      max_points: pad/truncate point count per file.
      stride_floats: floats per record (nuScenes = 5: x, y, z, i, ring).
      transforms: optional (N, 4, 4) float32 rigid transforms applied to
        each file's points (e.g. sensor -> ego frame).
      n_threads: worker threads (0 = one per CPU, capped at 16).

    Returns:
      points (N, max_points, 3) float32, mask (N, max_points) bool.
    """
    n = len(paths)
    points = np.zeros((n, max_points, 3), np.float32)
    mask = np.zeros((n, max_points), np.uint8)
    if n == 0:
        return points, mask.astype(bool)

    lib = _lib()
    if lib is None:
        return _read_pcd_batch_numpy(paths, max_points, stride_floats, transforms)

    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    t_ptr = None
    if transforms is not None:
        transforms = np.ascontiguousarray(transforms, np.float32)
        if transforms.shape != (n, 4, 4):
            raise ValueError(f"transforms must be ({n}, 4, 4), got {transforms.shape}")
        t_ptr = transforms.ctypes.data_as(ctypes.c_void_p)
    err = lib.v2x_read_pcd_batch(
        c_paths,
        n,
        stride_floats,
        max_points,
        t_ptr,
        points.ctypes.data_as(ctypes.c_void_p),
        mask.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if err != 0:
        raise FileNotFoundError(f"native loader failed on {paths[err - 1]}")
    return points, mask.astype(bool)


def _read_pcd_batch_numpy(paths, max_points, stride_floats, transforms):
    """The numpy reader: the fallback, and the native reader's test oracle."""
    n = len(paths)
    points = np.zeros((n, max_points, 3), np.float32)
    mask = np.zeros((n, max_points), bool)
    for i, p in enumerate(paths):
        flat = np.fromfile(p, np.float32)
        # A trailing partial record (a truncated sweep) is dropped, as the
        # native reader does.
        usable = (flat.size // stride_floats) * stride_floats
        raw = flat[:usable].reshape(-1, stride_floats)[:max_points, :3]
        if transforms is not None:
            t = transforms[i]
            raw = raw @ t[:3, :3].T + t[:3, 3]
        points[i, : len(raw)] = raw
        mask[i, : len(raw)] = True
    return points, mask
