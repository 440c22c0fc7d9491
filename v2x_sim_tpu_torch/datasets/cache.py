"""Offline preprocessed .npz frame cache.

The port's own copy of ``v2x_sim_tpu/datasets/cache.py`` (numpy only; the
wire format is the same, so one cache directory loads in both packages).
``tools/create_data_det.py`` writes one .npz per frame holding the whole
multi-agent scene dict, and this reader streams them back.

Wire format knobs:
  * compressed (default) or uncompressed frames: zlib decompression, not
    disk bandwidth, bounds reads of the small sparse-target frames on
    fast storage; ``save_frame(compress=False)`` /
    ``create_data_det --uncompressed`` trade bytes for CPU;
  * threaded reads: numpy's zlib decompression and file I/O release the
    GIL, so a small thread pool loads the frames of one batch
    (``iter_batches(workers=...)``), inside the loader's prefetch thread.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

FRAME_KEYS = (
    "points",
    "point_mask",
    "trans",
    "agent_mask",
    "gt_boxes",
    "gt_mask",
)


def iter_batches(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    workers: int = 4,
    shard: Tuple[int, int] = (0, 1),
):
    """Yield stacked host batches over an indexable frame dataset.

    The tail partial batch is yielded (a smaller leading dim), so a
    dataset shorter than one batch still yields its frames.

    ``workers`` > 1 loads the frames of each batch concurrently (order
    preserved by ``Executor.map``); 0 or 1 reads them serially.

    ``shard=(i, n)`` loads only rows ``[i·b/n, (i+1)·b/n)`` of each batch
    of b frames (data rank i of n), and raises when b does not split.
    """
    i, n = shard
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    pool = ThreadPoolExecutor(workers) if workers > 1 else None
    try:
        for start in range(0, len(order), batch_size):
            idx = [int(j) for j in order[start : start + batch_size]]
            if len(idx) % n:
                raise ValueError(f"a batch of {len(idx)} frames does not split over {n} ranks")
            idx = idx[i * len(idx) // n:(i + 1) * len(idx) // n]
            if pool is not None:
                items = list(pool.map(dataset.__getitem__, idx))
            else:
                items = [dataset[i] for i in idx]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def save_frame(
    cache_dir: str,
    name: str,
    frame: Dict[str, np.ndarray],
    compress: bool = True,
) -> str:
    """Write one frame dict as ``<cache_dir>/<name>.npz``; returns the path."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}.npz")
    writer = np.savez_compressed if compress else np.savez
    writer(path, **{k: frame[k] for k in frame})
    return path


class NpzCacheDataset:
    """Streams frames from a create_data cache directory."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self.files: List[str] = sorted(
            os.path.join(cache_dir, f)
            for f in os.listdir(cache_dir)
            if f.endswith(".npz")
        )
        if not self.files:
            raise FileNotFoundError(f"no .npz frames under {cache_dir}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.files[idx]) as z:
            return {k: z[k] for k in z.files}

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        workers: int = 4,
        shard: Tuple[int, int] = (0, 1),
    ):
        yield from iter_batches(self, batch_size, shuffle, seed, workers, shard)
