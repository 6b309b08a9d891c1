"""The unstructured slice as a whole: `pt.simp_optimize` on an
UnstructuredMesh against the JAX package (energies rtol 1e-8, EQUAL CG
counts) and against the scipy direct-solve reference (rtol 1e-6, densities
atol 5e-5), on the tet cantilever of tests/test_unstructured.py in float64
on the CPU; body force, material model, checkpoint/resume, exports."""

import os

import numpy as np
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu import mesh as mesh_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch import mesh as mesh_p
from easysimp_tpu_torch.carry import mesh_from_reference, params_from_reference
from easysimp_tpu_torch.post import vtu as vtu_p
from reference_impl import simp_optimize_reference

NELS = (4, 2, 2)


def _problem(mod, nels=NELS):
    tet_mesh_from_grid = (mesh_p if mod is pt else mesh_r).tet_mesh_from_grid
    mesh = tet_mesh_from_grid(mod.generate_grid(
        nels, (0.0, 0.0, 0.0), tuple(float(n) for n in nels)))
    bc = mod.apply_fixed_boundary(
        mesh, mod.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    load = mod.PointLoad(mod.select_nodes_by_box(
        mesh, [nels[0], 0, 0], [nels[0], 0, nels[2]]), [0.0, -1.0, 0.0])
    return mesh, [load], [bc]


def _params(**kw):
    """cg_rtol 1e-10: tight enough for the direct-solve comparison, and off
    the rounding floor, where a CG exit can shift by one iteration with the
    order of a sum."""
    kw = {"max_iterations": 8, "cg_rtol": 1e-10, "filter_radius": 1.5,
          "tolerance": 0.01, **kw}
    return et.OptimizationParameters(
        E0=100.0, Emin=1e-6, volume_fraction=0.5, dtype="float64", **kw)


def _run_port(params, nels=NELS, accel=None, resume_from=None,
              material_model=None):
    return pt.simp_optimize(
        *_problem(pt, nels), params_from_reference(params, material_model),
        accel, resume_from=resume_from, device="cpu")


_REFERENCE_RUNS = {}

# On this mesh (120 free dofs, a load symmetric in z) the one-level
# preconditioners need 60-75 CG iterations for 1e-10: as many as the
# symmetric subspace has dimensions, so the exit is CG's finite termination,
# which rounding moves by an iteration.  Equal counts are asked of them at a
# tolerance they reach some ten iterations earlier; the AMG (about 15
# iterations) keeps the tight one.
_CG_RTOL = {"block_jacobi": {"cg_rtol": 1e-6}, "jacobi": {"cg_rtol": 1e-6}}


def _run_reference(accel=None, **kw):
    """One JAX run per configuration and module (its compile dominates)."""
    key = (accel is not None, tuple(sorted(kw.items())))
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = et.simp_optimize(*_problem(et), _params(**kw),
                                                accel)
    return _REFERENCE_RUNS[key]


@pytest.mark.parametrize("precond", ["auto", "block_jacobi"])
@pytest.mark.parametrize("filter_type", ["sensitivity", "density"])
def test_tet_cantilever_trajectory(filter_type, precond):
    kw = dict(filter_type=filter_type, preconditioner=precond,
              **_CG_RTOL.get(precond, {}))
    res_r = _run_reference(**kw)
    res_p = _run_port(_params(**kw))
    assert res_p.iterations == res_r.iterations == 8
    assert res_p.cg_iterations_history == res_r.cg_iterations_history
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_p.volume_history, res_r.volume_history,
                               rtol=1e-10)
    np.testing.assert_allclose(res_p.densities, np.asarray(res_r.densities),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res_p.displacements,
                               np.asarray(res_r.displacements), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(res_p.element_energies,
                               res_r.element_energies, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res_p.stresses.von_mises,
                               res_r.stresses.von_mises, rtol=1e-6,
                               atol=1e-10)
    assert res_p.energy == pytest.approx(res_r.energy, rel=1e-8)
    assert len(res_p.iteration_seconds) == 8

    mesh, loads, bcs = _problem(et)
    f = et.build_load_field(mesh, loads).reshape(-1)
    fixed_dofs = np.nonzero(et.build_free_mask(mesh, bcs) == 0)[0]
    ref = simp_optimize_reference(
        mesh.node_coords, mesh.connectivity, fixed_dofs, f,
        E0=100.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.5,
        max_iterations=8, tolerance=0.01, filter_radius_ratio=1.5,
        filter_type=filter_type)
    np.testing.assert_allclose(res_p.energy_history, ref["energies"],
                               rtol=1e-6)
    np.testing.assert_allclose(res_p.densities, ref["final_densities"],
                               atol=5e-5)


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_other_preconditioners_and_solver_options(precond):
    """Scalar Jacobi; and the AMG with a forced deep hierarchy, the smoothed
    prolongator, the recycle ring and adaptive forcing."""
    kw = {"preconditioner": precond, "max_iterations": 5}
    kw.update(_CG_RTOL.get(precond, {}))
    if precond == "amg":
        kw.update(amg_max_coarse_dofs=30, amg_smooth_prolongator=True,
                  cg_recycle_k=4, cg_forcing="adaptive", cg_rtol_max=1e-9)
    res_r = _run_reference(**kw)
    res_p = _run_port(_params(**kw))
    assert res_p.cg_iterations_history == res_r.cg_iterations_history
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)


def test_body_force_equals_reference_and_integrates():
    accel = ((0.0, -9.81, 0.0), 7.85)
    res_r = _run_reference(accel=accel, max_iterations=4)
    res_p = _run_port(_params(max_iterations=4), accel=accel)
    assert res_p.cg_iterations_history == res_r.cg_iterations_history
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)
    # the shape integrals behind the body force sum to the mesh volume, so
    # a uniform design's force integrates to rho * base_density * V * accel
    mesh, loads, bcs = _problem(pt)
    us = pt.build_unstructured_step(
        mesh, loads, bcs, params_from_reference(_params()), accel,
        device="cpu")
    assert us.shape_integrals.shape == (mesh.n_cells, 4)
    assert float(us.shape_integrals.sum()) == pytest.approx(
        mesh.total_volume, rel=1e-12)


def test_material_model_closure_is_the_default_law():
    """A SIMP closure (two-field Lamé operator, jvp sensitivities) follows
    the default law's trajectory to 1e-8, and the JAX package's run of its
    own closure."""
    base = _run_port(_params(max_iterations=5))
    model_p = pt.create_simp_material_model(100.0, 0.3, 1e-6, 3.0)
    res_p = _run_port(_params(max_iterations=5), material_model=model_p)
    np.testing.assert_allclose(res_p.energy_history, base.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_p.densities, base.densities, rtol=1e-6,
                               atol=1e-8)
    model_r = et.create_simp_material_model(100.0, 0.3, 1e-6, 3.0)
    res_r = et.simp_optimize(*_problem(et), _params(
        max_iterations=5, material_model=model_r))
    assert res_p.cg_iterations_history == res_r.cg_iterations_history
    np.testing.assert_allclose(res_p.energy_history, res_r.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_p.stresses.von_mises,
                               res_r.stresses.von_mises, rtol=1e-6,
                               atol=1e-10)


def test_checkpoint_resume_and_exports(tmp_path):
    """Checkpoint at 4 + resume = 8 uninterrupted; a checkpoint of either
    package resumes in the other; interval and tolerance exports and the
    log are written and read back."""
    out = str(tmp_path / "out")
    ckpt = str(tmp_path / "ck")
    kw = dict(tolerance=1e-9, cg_recycle_k=4, checkpoint_interval=4,
              checkpoint_path=ckpt)

    def params(**more):
        return _params(**{**kw, **more})

    full = _run_port(params(checkpoint_interval=0, export_path=out,
                            export_interval=4, tolerance_checkpoints=[0.5]))
    assert sorted(os.listdir(out)) == [
        "final_results_50tol.vtu", "iter_0004.vtu", "iter_0008.vtu",
        "optimization_progress.csv", "optimization_summary.txt"]
    back = vtu_p.read_vtu(os.path.join(out, "iter_0008.vtu"))
    mesh = _problem(pt)[0]
    assert set(back.types) == {10} and len(back.types) == mesh.n_cells
    np.testing.assert_array_equal(back.points, mesh.node_coords)
    assert back.cell_data["density"].shape == (mesh.n_cells,)
    assert np.isfinite(back.cell_data["von_mises_stress"]).all()
    assert back.point_data["displacement"].shape == (mesh.n_nodes, 3)
    np.testing.assert_allclose(back.cell_data["density"], full.densities,
                               atol=0.3)   # iteration 8's, not the final
    reimported = pt.import_mesh(os.path.join(out, "iter_0008.vtu"))
    np.testing.assert_array_equal(reimported.connectivity, mesh.connectivity)

    _run_port(params(max_iterations=4))
    resumed = _run_port(params(), resume_from=ckpt)
    assert resumed.iterations == 8
    assert resumed.energy_history == full.energy_history
    assert resumed.cg_iterations_history == full.cg_iterations_history
    np.testing.assert_array_equal(resumed.densities, full.densities)

    # the port's checkpoint resumes in the JAX package, and the reverse
    res_r = et.simp_optimize(*_problem(et), params(), resume_from=ckpt)
    np.testing.assert_allclose(res_r.energy_history, full.energy_history,
                               rtol=1e-8)
    ckpt_r = str(tmp_path / "ck_r")
    et.simp_optimize(*_problem(et), params(max_iterations=4,
                                           checkpoint_path=ckpt_r))
    crossed = _run_port(params(checkpoint_interval=0), resume_from=ckpt_r)
    np.testing.assert_allclose(crossed.energy_history, full.energy_history,
                               rtol=1e-8)
    assert crossed.cg_iterations_history[4:] == \
        full.cg_iterations_history[4:]


def test_entry_points_and_refusals():
    """`simp_optimize` dispatches a mesh to the unstructured loop; the
    device defaults to CUDA and raises without one; a device mesh of the
    wrong axes and the FD verifier refuse; a reference mesh carried
    across by attribute runs."""
    mesh, loads, bcs = _problem(pt, (2, 2, 2))
    params = pt.OptimizationParameters(max_iterations=1, dtype="float64",
                                       volume_fraction=0.5)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pt.simp_optimize(mesh, loads, bcs, params)
    from easysimp_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(ValueError, match="'e',"):
        pt.simp_optimize_unstructured(
            mesh, loads, bcs, params, device="cpu",
            device_mesh=make_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(NotImplementedError, match="voxel grids"):
        pt.verify_sensitivities(mesh, loads, bcs, params, device="cpu")
    with pytest.raises(ValueError, match="cg_forcing"):
        pt.simp_optimize(mesh, loads, bcs, pt.OptimizationParameters(
            cg_forcing="sometimes"), device="cpu")
    carried = mesh_from_reference(_problem(et, (2, 2, 2))[0])
    res = pt.simp_optimize(carried, loads, bcs, params, device="cpu")
    direct = pt.simp_optimize(mesh, loads, bcs, params, device="cpu")
    assert res.energy_history == direct.energy_history
    assert res.densities.shape == (mesh.n_cells,)
    assert res.displacements.shape == (mesh.n_dofs,)
    assert res.stresses.qp_stresses.shape == (mesh.n_cells, 4, 6)


def test_hex8_mesh_runs_like_the_voxel_path():
    """An undistorted hex8 UnstructuredMesh is the voxel problem: the
    unstructured loop follows the voxel loop's energies."""
    nels = (6, 3, 2)
    grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(float(n) for n in nels))
    mesh = mesh_p.UnstructuredMesh(node_coords=grid.node_coords,
                                   connectivity=grid.hex_connectivity)
    assert mesh.cell_type == "hex8"
    bc = pt.apply_fixed_boundary(
        grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    load = pt.PointLoad(pt.select_nodes_by_box(grid, [6, 0, 0], [6, 0, 2]),
                        [0.0, -1.0, 0.0])
    params = pt.OptimizationParameters(
        E0=100.0, Emin=1e-6, volume_fraction=0.5, max_iterations=4,
        filter_radius=1.5, dtype="float64", cg_rtol=1e-12)
    res_m = pt.simp_optimize(mesh, [load], [bc], params, device="cpu")
    res_g = pt.simp_optimize(grid, [load], [bc], params, device="cpu")
    np.testing.assert_allclose(res_m.energy_history, res_g.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res_m.densities, res_g.densities, rtol=1e-6,
                               atol=1e-8)
