"""How well DiscoNet's training gradients are determined, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.grad_conditioning [width_mult [seed]]

Prints, for one loss gradient of the training step on the batch of
tests/test_torch_train.py (64x64x8 grid, B=2, one padded agent), the
largest difference of two gradient computations over the param tree,
each leaf's difference divided by that leaf's largest JAX or float64
entry:

  * the port in float32 against the port in float64;
  * the JAX package's space-to-depth execution against its plain
    execution, both in float64 (the former computes BatchNorm
    statistics in float32 whatever the input dtype);
  * the port against the JAX plain execution, both in float64.

Not a test: it backs the tolerances of tests/test_torch_train.py.
"""

import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train import CFG, JCFG, JaxDetModel, JaxDetModule, _leaves
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, random_flax_variables
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule


def _worst(got, want):
    """Largest per-leaf max|got - want| / max|want|, over leaves whose
    max|want| is at least 1e-6 of the largest gradient."""
    got, want = _leaves(got), _leaves(want)
    gmax = max(np.abs(w).max() for w in want.values())
    return max(float(np.abs(got[k] - w).max() / np.abs(w).max())
               for k, w in want.items() if np.abs(w).max() >= 1e-6 * gmax)


def port_grads(raw, variables, dtype, width):
    port = DetModule(CFG, "disco", dtype, device="cpu", width_mult=width)
    port.load_flax_variables(variables)
    port.model.to(dtype)
    loss, _ = port.loss(port.prepare_batch(raw), train=True)
    loss.backward()
    return flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()})["params"]


def jax_grads(raw, variables, s2d, width):
    with jax.enable_x64(True):
        jmod = JaxDetModule(JCFG, mode="disco", compute_dtype=jnp.float64, width_mult=width)
        if not s2d:
            jmod.model = JaxDetModel(
                config=JCFG, mode="disco", dtype=jnp.float64, s2d=False, width_mult=width)
            jmod._blocked = jmod._occ_blocked = False
        v = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
        prep = jmod.prepare_batch(raw)
        grad_fn = jax.jit(jax.grad(lambda p: jmod.loss_fn(p, v["batch_stats"], prep, None, True)[0]))
        return jax.tree.map(np.asarray, grad_fn(v["params"]))


def main(width: float, seed: int) -> None:
    raw = generate_batch(CFG, SyntheticSpec(points_per_agent=2048, num_vehicles=12, max_gt=16), 2, seed=5)
    raw["agent_mask"][1, -1] = False
    variables = random_flax_variables(DetModel(CFG, "disco", width), seed=seed)
    p64 = port_grads(raw, variables, torch.float64, width)
    print(f"width_mult {width}, weights seed {seed}")
    print(f"port fp32 vs port fp64:          {_worst(port_grads(raw, variables, torch.float32, width), p64):.3e}")
    plain = jax_grads(raw, variables, False, width)
    print(f"JAX s2d vs JAX plain, fp64:      {_worst(jax_grads(raw, variables, True, width), plain):.3e}")
    print(f"port vs JAX plain, fp64:         {_worst(p64, plain):.3e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    main(float(args[0]) if args else 1.0, int(args[1]) if len(args) > 1 else 0)
