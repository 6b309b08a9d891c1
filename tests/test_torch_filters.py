"""The port's VoxelFilter (one zero-padded conv3d) against the JAX package's
decomposed TPU convolution, fp64 on a non-cubic anisotropic grid
(tolerance 1e-12)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
import easysimp_tpu_torch as pt


@pytest.mark.parametrize("radius", [1.5, 2.5])
@pytest.mark.parametrize("op", ["weight_sum", "sensitivity_filter",
                                "density_filter", "chain_rule"])
def test_voxel_filter_matches_reference(radius, op):
    nels = (9, 6, 5)
    extents = (9.0, 7.2, 4.0)
    f_r = et.create_filter_cache(et.generate_grid(nels, (0, 0, 0), extents),
                                 radius, dtype=jnp.float64)
    f_p = pt.create_filter_cache(pt.generate_grid(nels, (0, 0, 0), extents),
                                 radius, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    rho = rng.uniform(0.0005, 1.0, nels)
    sens = -rng.uniform(0.01, 5.0, nels)
    if op == "weight_sum":
        want, got = f_r.weight_sum, f_p.weight_sum
    elif op == "sensitivity_filter":
        want = f_r.sensitivity_filter(jnp.asarray(rho), jnp.asarray(sens))
        got = f_p.sensitivity_filter(torch.tensor(rho), torch.tensor(sens))
    else:
        want = getattr(f_r, op)(jnp.asarray(rho))
        got = getattr(f_p, op)(torch.tensor(rho))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
