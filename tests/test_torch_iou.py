"""Rotated IoU of the PyTorch port: the plain version against the JAX
package (its XLA S-H form and the Pallas kernel in interpret mode). The
CUDA kernel is held against the plain version in tests/test_torch_cuda.py.

Tolerances: 1e-5 between two float32 implementations of the same
arithmetic (as tests/test_iou_pallas.py); the known-value cases use the
tolerances of tests/test_iou_sh.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.ops import iou_sh as jax_iou_sh
from v2x_sim_tpu_torch.ops import iou_sh
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ATOL = 1e-5


def _random_boxes(rng, n, spread=6.0):
    return np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(1.0, 5.0, n),
            rng.uniform(0.8, 3.0, n),
            rng.uniform(-np.pi, np.pi, n),
        ],
        axis=-1,
    ).astype(np.float32)


def test_plain_matches_jax_iou_sh():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 500), _random_boxes(rng, 500)
    got = iou_sh.rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_iou_sh.rotated_iou(jnp.asarray(a), jnp.asarray(b)))
    assert (want > 0).mean() > 0.1  # enough overlapping pairs to mean something
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_matches_pallas_kernel_interpret_mode():
    """The plain version against the TPU kernel it stands beside."""
    from jax.experimental.pallas import tpu as pltpu

    from v2x_sim_tpu.ops.pallas import iou_pl

    rng = np.random.default_rng(1)
    a, b = _random_boxes(rng, 200), _random_boxes(rng, 200)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(iou_pl.rotated_iou_pairs(jnp.asarray(a), jnp.asarray(b)))
    got = iou_sh.rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_matrix_and_quad_area_match_jax():
    rng = np.random.default_rng(2)
    a, b = _random_boxes(rng, 24), _random_boxes(rng, 16)
    got = iou_sh.rotated_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_iou_sh.rotated_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=ATOL)

    from v2x_sim_tpu.ops.boxes import box_corners as jax_corners
    from v2x_sim_tpu_torch.ops.boxes import box_corners

    ca, cb = a[:16], b
    got = iou_sh.quad_intersection_area(
        box_corners(torch.from_numpy(ca)), box_corners(torch.from_numpy(cb))
    ).numpy()
    want = np.asarray(jax_iou_sh.quad_intersection_area(
        jax_corners(jnp.asarray(ca)), jax_corners(jnp.asarray(cb))))
    np.testing.assert_allclose(got, want, atol=1e-4)  # areas up to ~15 m^2


@pytest.mark.parametrize(
    "box_a, box_b, iou, atol",
    [
        ((1.0, 2.0, 4.0, 2.0, 0.7), (1.0, 2.0, 4.0, 2.0, 0.7), 1.0, 1e-4),  # identical
        ((0.0, 0.0, 2.0, 2.0, 0.0), (1.0, 0.0, 2.0, 2.0, 0.0), 1 / 3, 1e-4),  # half shift
        ((0.0, 0.0, 2.0, 2.0, 0.0), (50.0, 50.0, 2.0, 2.0, 1.0), 0.0, 1e-6),  # far
        ((0.0, 0.0, 10.0, 10.0, 0.2), (0.0, 0.0, 2.0, 2.0, 1.0), 0.04, 1e-4),  # contained
    ],
)
def test_plain_special_cases(box_a, box_b, iou, atol):
    got = iou_sh.rotated_iou(torch.tensor([box_a]), torch.tensor([box_b]))
    np.testing.assert_allclose(got.numpy(), [iou], atol=atol)


def test_plain_matches_jax_on_zero_size_columns():
    """ROADMAP.md's F2: detections against padded (all-zero) GT. The clip
    keeps the detection whole, so the intersection is its shoelace area in
    every implementation, and the IoU is that area over the union's
    rounding residual (l*w minus the shoelace area, or the 1e-8 floor).
    That quotient is exact only when every product and sum rounds alike:

      * the port's plain version equals JAX's plain ``iou_sh`` (the
        reference JAX's own kernel tests hold the Pallas tile to) bit for
        bit on every pair whose corners agree bit for bit; the corners
        differ only where torch's and XLA's float32 sin/cos differ by an
        ulp (a few percent of yaws), and there the quotient moves freely;
      * the intersection is the detection's area l*w to the shoelace's
        rounding at these coordinates (atol 1e-3 m^2 at |x|, |y| <= 32 m),
        and JAX's plain version's, bit for bit where the corners agree;
      * JAX's Pallas kernel in interpret mode, whose fused CPU execution
        rounds the residual otherwise, gives the same regime: a finite
        quotient over 1e3.
    The CUDA kernel is held to the plain version on such operands in
    tests/test_torch_cuda.py."""
    from jax.experimental.pallas import tpu as pltpu

    from v2x_sim_tpu.ops.boxes import box_corners as jax_corners
    from v2x_sim_tpu.ops.pallas import iou_pl
    from v2x_sim_tpu_torch.ops.boxes import box_corners

    rng = np.random.default_rng(13)
    a = _random_boxes(rng, 512, spread=32.0)
    b = _random_boxes(rng, 512, spread=32.0)
    padded = rng.random(512) < 0.6
    b[padded] = 0.0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = iou_sh.rotated_iou(ta, tb).numpy()
    want = np.asarray(jax_iou_sh.rotated_iou(jnp.asarray(a), jnp.asarray(b)))
    same_corners = (box_corners(ta).numpy() == np.asarray(jax_corners(jnp.asarray(a)))).all(axis=(1, 2))
    assert padded.sum() > 250 and same_corners.mean() > 0.9
    assert (want[padded] > 1e3).all()  # area / residual: the F2 regime
    np.testing.assert_array_equal(got[padded & same_corners], want[padded & same_corners])
    np.testing.assert_allclose(got[~padded], want[~padded], atol=ATOL)

    inter = iou_sh.quad_intersection_area(box_corners(ta), box_corners(tb)).numpy()
    np.testing.assert_allclose(inter[padded], a[padded, 2] * a[padded, 3], rtol=0, atol=1e-3)
    jax_inter = np.asarray(jax_iou_sh.quad_intersection_area(
        jax_corners(jnp.asarray(a)), jax_corners(jnp.asarray(b))))
    np.testing.assert_array_equal(inter[padded & same_corners], jax_inter[padded & same_corners])
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(iou_pl.rotated_iou_pairs(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(kernel[padded]).all() and (kernel[padded] > 1e3).all()
