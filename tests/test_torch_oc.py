"""The port's OC update against the JAX package: the same bisection count,
the same lambda, and the design at 1e-12 (fp64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from easysimp_tpu.ops import oc as ref
from easysimp_tpu_torch.ops import oc as port


@pytest.mark.parametrize("seed,vf,move", [(5, 0.4, 0.2), (6, 0.5, 0.2),
                                          (7, 0.25, 0.1)])
def test_oc_update_matches_reference(seed, vf, move):
    rng = np.random.default_rng(seed)
    shape = (7, 5, 3)
    rho = rng.uniform(0.05, 0.95, shape)
    sens = -rng.uniform(0.01, 5.0, shape)
    n = rho.size
    vsens = np.full(shape, 1.0 / n)
    new_r, lam_r, its_r, verr_r = ref.oc_update(
        jnp.asarray(rho), jnp.asarray(sens), jnp.asarray(vsens), vf, float(n),
        1.0, move, 0.5, volume_weights=jnp.asarray(vsens * n))
    new_p, lam_p, its_p, verr_p = port.oc_update(
        torch.tensor(rho), torch.tensor(sens), torch.tensor(vsens), vf,
        float(n), torch.tensor(vsens * n), move, 0.5)
    assert its_p == int(its_r)
    assert lam_p == float(lam_r)
    # the volume error is a difference of O(n) sums: summation order shows
    # at 1e-14 of the total volume
    np.testing.assert_allclose(verr_p, float(verr_r), rtol=0, atol=1e-12 * n)
    np.testing.assert_allclose(new_p.numpy(), np.asarray(new_r), rtol=1e-12,
                               atol=1e-12)


def test_oc_update_nonconvergence_matches_reference():
    """An infeasible target exhausts the bisection in both packages."""
    rho = np.full((5, 5, 2), 0.9)
    sens = -np.ones_like(rho)
    vsens = np.full_like(rho, 1.0 / rho.size)
    n = float(rho.size)
    _, lam_r, its_r, verr_r = ref.oc_update(
        jnp.asarray(rho), jnp.asarray(sens), jnp.asarray(vsens), 0.05, n,
        1.0, 0.2, 0.5, volume_weights=jnp.asarray(vsens * n))
    new_p, lam_p, its_p, verr_p = port.oc_update(
        torch.tensor(rho), torch.tensor(sens), torch.tensor(vsens), 0.05, n,
        torch.tensor(vsens * n), 0.2, 0.5)
    assert (its_p, lam_p) == (int(its_r), float(lam_r))
    assert abs(verr_p) >= 1e-6
    np.testing.assert_allclose(new_p.numpy(), 0.7, rtol=1e-12)


def test_sensitivity_health_and_median():
    vals = np.random.default_rng(1).standard_normal(10_000)
    got = [float(v) for v in port.sensitivity_health(torch.tensor(vals))]
    want = [float(v) for v in ref.sensitivity_health(jnp.asarray(vals))]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert port.host_median_abs(torch.tensor(vals)) == \
        ref.host_median_abs(jnp.asarray(vals))
