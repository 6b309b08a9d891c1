"""The port's coarse-to-fine continuation (opt/continuation.py) against the
JAX package, float64 on the CPU: the coarsened problem, the two
prolongations, and a continuation trajectory."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu.opt import continuation as cont_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.carry import params_from_reference
from easysimp_tpu_torch.opt import continuation as cont_p


def _problem(mod, nels, traction=False):
    """A cantilever with a sliding support and, optionally, a surface
    traction on the far face beside its point load."""
    grid = mod.generate_grid(nels, (0.0, 0.0, 0.0),
                             tuple(0.5 * n for n in nels))
    nx, ny, nz = (0.5 * n for n in nels)
    bcs = [
        mod.apply_fixed_boundary(grid, mod.select_nodes_by_plane(
            grid, [0, 0, 0], [1, 0, 0], 1e-6)),
        mod.apply_sliding_boundary(grid, mod.select_nodes_by_box(
            grid, [nx, 0, 0], [nx, 0, nz]), [2]),
    ]
    loads = [mod.PointLoad(mod.select_nodes_by_box(
        grid, [nx, ny, 0], [nx, ny, nz]), [0.0, -1.0, 0.0])]
    if traction:
        loads.append(mod.SurfaceTractionLoad(
            mod.select_nodes_by_plane(grid, [nx, 0, 0], [1, 0, 0], 1e-6),
            lambda x, y, z: (0.0, -0.1 * (1.0 + y), 0.0)))
    return grid, loads, bcs


@pytest.mark.parametrize("nels", [(8, 4, 4), (12, 6, 2)])
def test_coarsen_problem_equals_reference(nels):
    """The coarse grid, the snapped node sets and the fields built from
    them are exactly the JAX package's."""
    coarse_r, loads_r, bcs_r = cont_r.coarsen_problem(
        *_problem(et, nels, traction=True))
    coarse_p, loads_p, bcs_p = cont_p.coarsen_problem(
        *_problem(pt, nels, traction=True))
    assert coarse_p.nels == coarse_r.nels == tuple(n // 2 for n in nels)
    assert coarse_p.spacing == coarse_r.spacing
    assert coarse_p.origin == coarse_r.origin
    for a, b in zip(loads_p + bcs_p, loads_r + bcs_r):
        np.testing.assert_array_equal(a.nodes, b.nodes)
    for a, b in zip(bcs_p, bcs_r):
        assert tuple(a.components) == tuple(b.components)
    np.testing.assert_array_equal(pt.build_free_mask(coarse_p, bcs_p),
                                  et.build_free_mask(coarse_r, bcs_r))
    np.testing.assert_array_equal(pt.build_load_field(coarse_p, loads_p),
                                  et.build_load_field(coarse_r, loads_r))


def test_coarsen_problem_refuses_odd_grids():
    with pytest.raises(ValueError, match="even grid dims"):
        cont_p.coarsen_problem(*_problem(pt, (6, 3, 2)))


def test_prolongations_equal_reference():
    """prolong_design: exact, and volume-preserving; prolong_displacement:
    the JAX package's trilinear prolongation (1e-15)."""
    rng = np.random.default_rng(5)
    design = rng.uniform(0.0, 1.0, (4, 3, 2))
    u = rng.standard_normal((5, 4, 3, 3))
    fine = cont_p.prolong_design(torch.tensor(design)).numpy()
    np.testing.assert_array_equal(
        fine, np.asarray(cont_r.prolong_design(jnp.asarray(design))))
    assert fine.shape == (8, 6, 4) and np.isclose(fine.mean(), design.mean(),
                                                  rtol=1e-15)
    np.testing.assert_allclose(
        cont_p.prolong_displacement(torch.tensor(u)).numpy(),
        np.asarray(cont_r.prolong_displacement(jnp.asarray(u))),
        rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("levels,nels,recycle_k", [(1, (8, 4, 4), 0),
                                                   (2, (16, 8, 8), 3)])
def test_continuation_trajectory_matches_jax(levels, nels, recycle_k):
    """A run that starts from the prolonged coarse result, one and two
    levels deep: energies rtol 1e-8 against the JAX package; the first fine
    volume fraction is the target, which the prolongation preserves."""
    params = et.OptimizationParameters(
        E0=10.0, Emin=1e-6, volume_fraction=0.4, max_iterations=3,
        tolerance=1e-9, filter_radius=1.5, dtype="float64", cg_rtol=1e-12,
        preconditioner="jacobi", continuation_levels=levels,
        continuation_iters=3, cg_recycle_k=recycle_k)
    want = et.simp_optimize(*_problem(et, nels), params)
    got = pt.simp_optimize(*_problem(pt, nels),
                           params_from_reference(params), device="cpu")
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(got.densities, want.densities, atol=1e-7)
    total = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                             tuple(0.5 * n for n in nels)).total_volume
    assert abs(got.volume_history[0] / total - 0.4) < 1e-6
    # the uniform start would give another first energy
    cold = pt.simp_optimize(
        *_problem(pt, nels), params_from_reference(params.__class__(
            **{**params.__dict__, "continuation_levels": 0,
               "max_iterations": 1})), device="cpu")
    assert abs(cold.energy_history[0] / got.energy_history[0] - 1) > 1e-3
