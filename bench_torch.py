#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port on one card.

    python bench_torch.py         # preflight, then one bounded run: one JSON line
    python bench_torch.py --run   # the measurement itself, in this process

See ``v2x_sim_tpu_torch/bench.py`` for what it measures.
"""

import sys

from v2x_sim_tpu_torch import bench

if __name__ == "__main__":
    if "--run" in sys.argv:
        bench.run()
    else:
        sys.exit(bench.main())
