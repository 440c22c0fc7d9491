"""MGDA multi-task gradient balancing (min-norm solver).

Port of ``v2x_sim_tpu/utils/mgda.py`` (the reference's ``MinNormSolver``
with 'l2' gradient normalization, used by ``FaFModule`` under ``--MGDA``
to balance the cls, loc and KD task gradients). Each task's gradient is a
list of tensors, one per parameter. The solver works on the (T, T) Gram
matrix of the flattened task gradients: the closed form for two tasks,
32 Frank-Wolfe steps with exact line search for more. Everything stays on
the gradients' device; nothing waits for it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Grads = Sequence[torch.Tensor]

FW_ITERS = 32  # Frank-Wolfe steps for more than two tasks


def _min_norm_2d(v1v1: torch.Tensor, v1v2: torch.Tensor, v2v2: torch.Tensor) -> torch.Tensor:
    """Weights of the min-norm point on the segment between two gradients."""
    gamma = (v2v2 - v1v2) / (v1v1 + v2v2 - 2 * v1v2).clamp(min=1e-12)
    gamma = gamma.clamp(0.0, 1.0)
    return torch.stack([gamma, 1.0 - gamma])


def min_norm_weights(gram: torch.Tensor) -> torch.Tensor:
    """(T,) simplex weights of the min-norm point in the convex hull of the
    task gradients, from their (T, T) Gram matrix G_ij = <g_i, g_j>.
    T > 2 takes ``FW_ITERS`` Frank-Wolfe steps from the uniform weights, each
    toward the vertex of least directional derivative (the first on ties,
    as argmin returns it)."""
    t = gram.shape[0]
    if t == 1:
        return torch.ones(1, dtype=gram.dtype, device=gram.device)
    if t == 2:
        return _min_norm_2d(gram[0, 0], gram[0, 1], gram[1, 1])
    w = torch.full((t,), 1.0 / t, dtype=gram.dtype, device=gram.device)
    for _ in range(FW_ITERS):
        v = torch.nn.functional.one_hot(torch.argmin(gram @ w), t).to(gram.dtype)
        d = v - w
        # Exact line search on the quadratic.
        step = (-(w @ gram @ d) / (d @ gram @ d).clamp(min=1e-12)).clamp(0.0, 1.0)
        w = w + step * d
    return w


def gram_matrix(grads: Sequence[Grads]) -> torch.Tensor:
    """(T, T) Gram matrix of T task gradients."""
    flat = torch.stack([torch.cat([g.reshape(-1) for g in task]) for task in grads])
    return flat @ flat.T


def combine_grads(grads: Sequence[Grads], weights: torch.Tensor) -> List[torch.Tensor]:
    """sum_t weights[t] * grads[t], parameter by parameter."""
    return [sum(w * g for w, g in zip(weights, per_param)) for per_param in zip(*grads)]


def mgda_grads(grads: Sequence[Grads]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The MGDA combination: each task's gradient is divided by its global
    l2 norm (at least 1e-12), then the min-norm weights combine the
    normalized gradients.

    Returns (combined gradient, one tensor per parameter; (T,) weights).
    """

    def nrm(task):
        n = torch.sqrt(sum((g * g).sum() for g in task)).clamp(min=1e-12)
        return [g / n for g in task]

    grads = [nrm(task) for task in grads]
    weights = min_norm_weights(gram_matrix(grads))
    return combine_grads(grads, weights), weights
