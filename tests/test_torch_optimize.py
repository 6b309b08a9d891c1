"""The port's SIMP loop end to end against the JAX package and against
the scipy direct-solve reference (tests/reference_impl.py), on the
10x6x2 cantilever of tests/test_optimize.py in float64 with Jacobi PCG."""

import numpy as np
import pytest

import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.carry import params_from_reference
from reference_impl import simp_optimize_reference


def _cantilever(mod, nels=(10, 6, 2)):
    grid = mod.generate_grid(nels, (0.0, 0.0, 0.0),
                             tuple(float(n) for n in nels))
    nx, ny, nz = nels
    bc = mod.apply_fixed_boundary(
        grid, mod.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-3))
    load = mod.PointLoad(mod.select_nodes_by_box(grid, [nx, 0, 0],
                                                 [nx, 0, nz]),
                         [0.0, -1.0, 0.0])
    return grid, [load], [bc]


def _run_both(**kw):
    params = et.OptimizationParameters(
        E0=200.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.4,
        max_iterations=10, tolerance=0.01, filter_radius=1.5,
        dtype="float64", preconditioner="jacobi", **kw)
    grid_r, loads_r, bcs_r = _cantilever(et)
    grid_p, loads_p, bcs_p = _cantilever(pt)
    res_r = et.simp_optimize(grid_r, loads_r, bcs_r, params)
    res_p = pt.simp_optimize(grid_p, loads_p, bcs_p,
                             params_from_reference(params), device="cpu")
    return grid_r, loads_r, bcs_r, params, res_r, res_p


@pytest.mark.parametrize("filter_type", ["sensitivity", "density"])
def test_trajectory_matches_jax_and_direct_solve(filter_type):
    """Energy history: JAX rtol 1e-8, direct solve rtol 1e-6 (as
    tests/test_optimize.py:63-84); densities atol 5e-5."""
    grid, loads, bcs, params, res_r, res_p = _run_both(
        filter_type=filter_type, cg_rtol=1e-12)
    assert res_p.iterations == res_r.iterations
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_p.volume_history, res_r.volume_history,
                               rtol=1e-10)
    np.testing.assert_allclose(res_p.densities, res_r.densities, atol=5e-5)
    np.testing.assert_allclose(res_p.element_energies,
                               res_r.element_energies, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res_p.stresses.von_mises,
                               res_r.stresses.von_mises, rtol=1e-6,
                               atol=1e-10)

    f = grid.dofs_flat(np.asarray(et.build_load_field(grid, loads)))
    mask = grid.dofs_flat(et.build_free_mask(grid, bcs))
    ref = simp_optimize_reference(
        grid.node_coords, grid.hex_connectivity, np.nonzero(mask == 0)[0], f,
        E0=params.E0, Emin=params.Emin, nu=params.nu, p=params.p,
        volume_fraction=params.volume_fraction,
        max_iterations=params.max_iterations, tolerance=params.tolerance,
        filter_radius_ratio=params.filter_radius, filter_type=filter_type,
        move=params.move_limit, damping=params.damping)
    np.testing.assert_allclose(res_p.energy_history, ref["energies"],
                               rtol=1e-6)
    np.testing.assert_allclose(res_p.densities, ref["final_densities"],
                               atol=5e-5)
    assert np.isclose(res_p.energy, ref["final_energy"], rtol=1e-6)


def test_recycled_adaptive_jacobi_matches_jax():
    """The chip smoke's solver configuration (Jacobi, adaptive forcing,
    an 8-slot recycle ring) against the JAX package.  The deflation solves
    a near-singular 7x7 Gram system, so rounding may move a solve's exit by
    one CG iteration: CG counts within 1.  The adaptive tolerances are kept
    tight (cg_rtol_max 1e-9) so that such a shift leaves the energies at
    rtol 1e-8."""
    _, _, _, _, res_r, res_p = _run_both(
        cg_rtol=1e-12, cg_rtol_max=1e-9, cg_forcing="adaptive",
        cg_recycle_k=8)
    assert len(res_p.cg_iterations_history) == \
        len(res_r.cg_iterations_history)
    np.testing.assert_allclose(res_p.cg_iterations_history,
                               res_r.cg_iterations_history, rtol=0, atol=1)
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)


def test_logger_files(tmp_path):
    """export_path writes the reference's CSV log and summary."""
    from easysimp_tpu.opt.logger import _CSV_HEADER

    grid, loads, bcs = _cantilever(pt, (4, 2, 2))
    params = pt.OptimizationParameters(
        max_iterations=2, tolerance=1e-9, dtype="float64",
        preconditioner="jacobi", export_path=str(tmp_path))
    pt.simp_optimize(grid, loads, bcs, params, device="cpu")
    lines = (tmp_path / "optimization_progress.csv").read_text().splitlines()
    assert lines[0] + "\n" == _CSV_HEADER
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2"]
    summary = (tmp_path / "optimization_summary.txt").read_text()
    assert "Iterations:       2" in summary


@pytest.mark.parametrize("kw", [
    dict(preconditioner="auto"),
    dict(preconditioner="multigrid"),
    dict(preconditioner="jacobi", export_interval=2, export_path="unused"),
    dict(preconditioner="jacobi", continuation_levels=1),
    dict(preconditioner="jacobi", checkpoint_path="unused.npz"),
    dict(preconditioner="jacobi", material_model=lambda rho: (rho, rho)),
])
def test_unported_options_raise(kw):
    grid, loads, bcs = _cantilever(pt, (4, 2, 2))
    params = pt.OptimizationParameters(max_iterations=1, dtype="float64",
                                       **kw)
    with pytest.raises(NotImplementedError):
        pt.simp_optimize(grid, loads, bcs, params, device="cpu")
