"""The port's PCG against the JAX package: Jacobi-preconditioned, with and
without a deflation ring.  The same iteration count, the same solution at
1e-10 (fp64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu.ops import cg as ref
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.ops import cg as port


def _system(seed=2):
    nels = (8, 5, 3)
    grid_r = et.generate_grid(nels)
    grid_p = pt.generate_grid(nels)
    bcs = [et.apply_fixed_boundary(grid_r, et.select_nodes_by_plane(
        grid_r, [0, 0, 0], [1, 0, 0], 1e-6))]
    mask = et.build_free_mask(grid_r, bcs)
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.05, 1.0, nels)
    b = rng.standard_normal((*grid_r.nnodes_per_axis, 3)) * mask
    ring = rng.standard_normal((4, *b.shape))
    op_r = et.VoxelOperator(grid_r, E0=1.0, Emin=1e-9, dtype=jnp.float64)
    op_p = pt.VoxelOperator(grid_p, E0=1.0, Emin=1e-9, dtype=torch.float64,
                            device="cpu")
    return op_r, op_p, mask, rho, b, ring


@pytest.mark.parametrize("recycle", [False, True])
def test_jacobi_pcg_matches_reference(recycle):
    op_r, op_p, mask, rho, b, ring = _system()
    s_r = op_r.youngs_modulus(jnp.asarray(rho))
    m_r = jnp.asarray(mask)
    d_r = op_r.diagonal(s_r, m_r)
    x0 = ring[0] * mask
    sol_r = ref.cg_solve(
        lambda v: op_r.apply(v, s_r, m_r), jnp.asarray(b),
        x0=jnp.asarray(x0), M=lambda r: r / d_r, rtol=1e-12, maxiter=500,
        deflate=ref.recycle_deflate(m_r, jnp.asarray(ring))
        if recycle else None)

    s_p = op_p.youngs_modulus(torch.tensor(rho))
    m_p = torch.tensor(mask)
    d_p = op_p.diagonal(s_p, m_p)
    sol_p = port.cg_solve(
        lambda v: op_p.apply(v, s_p, m_p), torch.tensor(b),
        x0=torch.tensor(x0), M=lambda r: r / d_p, rtol=1e-12, maxiter=500,
        deflate=port.recycle_deflate(m_p, torch.tensor(ring))
        if recycle else None)

    assert 0 < sol_p.iterations < 500
    assert sol_p.iterations == int(sol_r.iterations)
    np.testing.assert_allclose(sol_p.u.numpy(), np.asarray(sol_r.u),
                               rtol=1e-10, atol=1e-10)
    # at the exit both residuals are rounding-level: hold the port to the
    # stopping rule, and <u, r> to the solution tolerance
    assert sol_p.residual_norm <= 1e-12 * np.linalg.norm(b)
    np.testing.assert_allclose(float(sol_p.u_dot_r), float(sol_r.u_dot_r),
                               rtol=0, atol=1e-10)


def test_recycle_ring_matches_reference():
    rng = np.random.default_rng(0)
    u0, u1 = rng.standard_normal((2, 3, 4, 2, 3))
    mask = (rng.uniform(size=u0.shape) > 0.2).astype(np.float64)
    H_r = ref.recycle_push(ref.recycle_init(3, jnp.asarray(u0)),
                           jnp.asarray(u1))
    H_p = port.recycle_push(port.recycle_init(3, torch.tensor(u0)),
                            torch.tensor(u1))
    np.testing.assert_array_equal(H_p.numpy(), np.asarray(H_r))
    np.testing.assert_array_equal(
        port.recycle_deflate(torch.tensor(mask), H_p).numpy(),
        np.asarray(ref.recycle_deflate(jnp.asarray(mask), H_r)))
