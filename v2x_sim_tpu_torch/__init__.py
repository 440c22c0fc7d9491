"""v2x_sim_tpu_torch — the PyTorch/CUDA port of v2x_sim_tpu for NVIDIA Hopper.

Multi-agent (1 RSU + up to 5 vehicles) collaborative BEV detection in
PyTorch, with the JAX package's Pallas kernels rewritten by hand for the
H100 (``csrc/``). The JAX package is the reference; this package imports
nothing of it and keeps its own copies of the numpy-only modules it needs.

Layout mirrors ``v2x_sim_tpu`` module for module. Public functions keep
the JAX package's layouts (NHWC maps, ``(B, A, H, W, K, C)`` logits,
``(B, A, K, 5)`` boxes) so the parity tests compare like with like.

Entry points run on the card unless the caller passes ``device="cpu"``;
they never fall back to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and no card is present — there is no silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
