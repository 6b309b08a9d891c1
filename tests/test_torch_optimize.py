"""The port's SIMP loop end to end against the JAX package and against
the scipy direct-solve reference (tests/reference_impl.py), on the
cantilevers of tests/test_optimize.py in float64, with Jacobi PCG and with
geometric multigrid."""

import numpy as np
import pytest

import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.carry import params_from_reference
from easysimp_tpu_torch.opt.optimize import DiagonalPreconditioner
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


def _params(**kw):
    kw = {"preconditioner": "jacobi", "max_iterations": 10,
          "dtype": "float64", **kw}
    return et.OptimizationParameters(
        E0=200.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.4,
        tolerance=0.01, filter_radius=1.5, **kw)


def _run_port(params, nels=(10, 6, 2)):
    return pt.simp_optimize(*_cantilever(pt, nels),
                            params_from_reference(params), device="cpu")


def _direct(grid, loads, bcs, params, filter_type="sensitivity"):
    f = grid.dofs_flat(np.asarray(et.build_load_field(grid, loads)))
    mask = grid.dofs_flat(et.build_free_mask(grid, bcs))
    return simp_optimize_reference(
        grid.node_coords, grid.hex_connectivity, np.nonzero(mask == 0)[0], f,
        E0=params.E0, Emin=params.Emin, nu=params.nu, p=params.p,
        volume_fraction=params.volume_fraction,
        max_iterations=params.max_iterations, tolerance=params.tolerance,
        filter_radius_ratio=params.filter_radius, filter_type=filter_type,
        move=params.move_limit, damping=params.damping)


def _run_both(nels=(10, 6, 2), **kw):
    params = _params(**kw)
    grid_r, loads_r, bcs_r = _cantilever(et, nels)
    grid_p, loads_p, bcs_p = _cantilever(pt, nels)
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

    ref = _direct(grid, loads, bcs, params, filter_type)
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


@pytest.mark.parametrize("precond", ["multigrid", "auto"])
def test_multigrid_trajectory_matches_jax_and_direct_solve(precond):
    """Geometric multigrid (what "auto" resolves to here) on the 10x6x4
    cantilever: energies rtol 1e-8 against the JAX package with CG counts
    within 1 per solve, and rtol 1e-6 against the direct solve."""
    grid, loads, bcs, params, res_r, res_p = _run_both(
        nels=(10, 6, 4), preconditioner=precond, cg_rtol=1e-12,
        max_iterations=7)
    assert res_p.iterations == res_r.iterations
    np.testing.assert_allclose(res_p.cg_iterations_history,
                               res_r.cg_iterations_history, rtol=0, atol=1)
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_p.densities, res_r.densities, atol=1e-7)
    ref = _direct(grid, loads, bcs, params)
    np.testing.assert_allclose(res_p.energy_history, ref["energies"],
                               rtol=1e-6)
    assert np.isclose(res_p.energy, ref["final_energy"], rtol=1e-6)


def test_light_setup_cadence_matches_jax(monkeypatch):
    """The bench's setup cadence (light setup between full ones every 3,
    three levels) with an 8-slot recycle ring and adaptive forcing, against
    the JAX package: CG counts within 1, energies rtol 1e-8 (tight adaptive
    tolerances, as test_recycled_adaptive_jacobi_matches_jax)."""
    monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", "500")
    _, _, _, _, res_r, res_p = _run_both(
        nels=(16, 8, 8), preconditioner="multigrid", max_iterations=6,
        mg_full_setup_every=3, mg_smooth_iters=(1, 2), cg_rtol=1e-12,
        cg_rtol_max=1e-9, cg_forcing="adaptive", cg_recycle_k=8)
    np.testing.assert_allclose(res_p.cg_iterations_history,
                               res_r.cg_iterations_history, rtol=0, atol=1)
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)


@pytest.mark.parametrize("setup_every,recycle_k", [(3, 0), (2, 3)])
def test_stale_preconditioner_trajectory_matches(setup_every, recycle_k):
    """Ports of tests/test_optimize.py:190 and :212: a preconditioner
    rebuilt only every `setup_every` iterations (CG still applies the
    current operator), with and without recycling, reproduces the
    refresh-every-iteration trajectory to solver tolerance."""
    def run(every):
        return _run_port(_params(
            preconditioner="multigrid", cg_rtol=1e-12, max_iterations=7,
            mg_setup_every=every, cg_recycle_k=recycle_k), (10, 6, 4))

    res1, res_n = run(1), run(setup_every)
    np.testing.assert_allclose(res_n.energy_history, res1.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_n.densities, res1.densities, rtol=1e-7,
                               atol=1e-9)


def test_bench_config_trajectory_parity():
    """Port of tests/test_optimize.py:234: the bench composition in float32
    (Galerkin V(1,2), bfloat16 cycle interior, recycled CG) tracks the
    float64 direct solve, energies rtol 2e-4, volumes rtol 1e-5."""
    params = _params(max_iterations=8, dtype="float32", cg_rtol=1e-6,
                     preconditioner="multigrid", mg_smooth_iters=(1, 2),
                     mg_cycle_dtype="bfloat16", cg_recycle_k=4)
    res = _run_port(params, (10, 6, 4))
    ref = _direct(*_cantilever(et, (10, 6, 4)), params)
    np.testing.assert_allclose(res.energy_history, ref["energies"],
                               rtol=2e-4)
    np.testing.assert_allclose(res.volume_history, ref["volumes"],
                               rtol=1e-5)


def test_auto_without_levels_is_jacobi(capsys):
    """On a grid with no coarser level (odd element counts) "auto" is
    Jacobi; "multigrid" warns and falls back to Jacobi."""
    nels = (5, 3, 3)
    runs = {p: _run_port(_params(preconditioner=p, cg_rtol=1e-12,
                                 max_iterations=3), nels)
            for p in ("jacobi", "auto")}
    assert "falling back" not in capsys.readouterr().out
    runs["multigrid"] = _run_port(_params(
        preconditioner="multigrid", cg_rtol=1e-12, max_iterations=3), nels)
    assert "falling back to Jacobi" in capsys.readouterr().out
    for p in ("auto", "multigrid"):
        assert runs[p].energy_history == runs["jacobi"].energy_history
        assert runs[p].cg_iterations_history == \
            runs["jacobi"].cg_iterations_history
    vs = pt.build_voxel_step(*_cantilever(pt, nels),
                             params_from_reference(_params(
                                 preconditioner="auto")), device="cpu")
    assert isinstance(vs.precond, DiagonalPreconditioner)
    assert vs.precond.jacobi and vs.setup_every == 1


@pytest.mark.parametrize("what", ["mesh", "unstructured"])
def test_unported_options_raise(what):
    """What the port refuses on the JAX package's signature: a device mesh
    whose axes do not fit the input kind (("x","y","z") for a voxel grid,
    ("e",) for an unstructured mesh), with the reference's messages."""
    from easysimp_tpu_torch.parallel.sharding import (make_element_mesh,
                                                      make_mesh)

    grid, loads, bcs = _cantilever(pt, (4, 2, 2))
    params = pt.OptimizationParameters(max_iterations=1, dtype="float64",
                                       preconditioner="jacobi")
    wrong = make_element_mesh(16, devices=["cpu"] * 2)
    match = "'x','y','z'"
    if what == "unstructured":
        grid = pt.tet_mesh_from_grid(grid)
        wrong, match = make_mesh(2, devices=["cpu"] * 2), "'e',"
    for mesh in (wrong, object()):
        with pytest.raises(ValueError, match=match):
            pt.simp_optimize(grid, loads, bcs, params, device="cpu",
                             mesh=mesh)
