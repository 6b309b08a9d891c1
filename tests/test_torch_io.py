"""What the port reads and writes, against the JAX package: checkpoints
(one `.npz` format for both packages, so state is carried across in either
direction), VTU exports, the boundary-condition export, volumes, mesh
extraction and the profiler trace.  float64 on the CPU."""

import os

import numpy as np
import pytest

import easysimp_tpu as et
from easysimp_tpu.opt import checkpoint as ckpt_r
from easysimp_tpu.post import vtu as vtu_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.carry import params_from_reference
from easysimp_tpu_torch.opt import checkpoint as ckpt_p
from easysimp_tpu_torch.post import vtu as vtu_p
from easysimp_tpu_torch.utils.extract_mesh import extract_mesh_from_vtu

NELS = (12, 6, 4)


def _cantilever(mod, nels=NELS):
    grid = mod.generate_grid(nels)
    bc = mod.apply_fixed_boundary(
        grid, mod.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    load = mod.PointLoad(mod.select_nodes_by_box(
        grid, [nels[0], 0, 0], [nels[0], 0, nels[2]]), [0.0, -1.0, 0.0])
    return grid, [load], [bc]


def _params(**kw):
    """Multigrid with an 8-slot recycle ring and adaptive forcing (tight,
    so that a CG exit shifted by one iteration leaves the energies at
    1e-8)."""
    kw = {"max_iterations": 6, "preconditioner": "multigrid",
          "cg_recycle_k": 8, "cg_forcing": "adaptive", "cg_rtol": 1e-12,
          "cg_rtol_max": 1e-9, **kw}
    return et.OptimizationParameters(
        E0=10.0, Emin=1e-6, volume_fraction=0.4, tolerance=1e-9,
        filter_radius=1.5, dtype="float64", **kw)


def _run(mod, params, resume_from=None):
    if mod is et:
        return et.simp_optimize(*_cantilever(et), params,
                                resume_from=resume_from)
    return pt.simp_optimize(*_cantilever(pt), params_from_reference(params),
                            resume_from=resume_from, device="cpu")


@pytest.fixture(scope="module")
def full_runs():
    """The uninterrupted 6-iteration runs of both packages."""
    return {"jax": _run(et, _params()), "port": _run(pt, _params())}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_state_carried_across(tmp_path, full_runs, writer, reader):
    """A checkpoint written at iteration 3 by one package (multigrid power
    vectors, recycle ring, histories) and resumed by the other matches the
    reader's and the JAX package's uninterrupted runs, rtol 1e-8; within
    the port, rtol 1e-10 and densities atol 1e-12 (tests/test_aux.py:18)."""
    mods = {"jax": et, "port": pt}
    path = str(tmp_path / "ckpt")
    _run(mods[writer], _params(max_iterations=3, checkpoint_interval=3,
                               checkpoint_path=path))
    assert os.path.exists(path + ".npz")
    saved = ckpt_p.load_checkpoint(path)
    assert saved["iteration"] == 3 and len(saved["pvecs"]) >= 2
    assert saved["recycle"].shape[0] == 8

    res = _run(mods[reader], _params(), resume_from=path)
    assert res.iterations == 6 and len(res.energy_history) == 6
    rtol, atol = (1e-10, 1e-12) if writer == reader else (1e-8, 1e-7)
    for other in (full_runs[reader], full_runs["jax"]):
        tol = rtol if other is full_runs[reader] else 1e-8
        np.testing.assert_allclose(res.energy_history, other.energy_history,
                                   rtol=tol)
        np.testing.assert_allclose(res.cg_iterations_history,
                                   other.cg_iterations_history, rtol=0,
                                   atol=1)
    np.testing.assert_allclose(res.densities, full_runs[reader].densities,
                               atol=atol)
    if reader == "port":
        # the clock covers the resumed run's own iterations only
        assert len(res.iteration_seconds) == 3


def test_resume_restarts_cold_on_other_state(tmp_path, full_runs):
    """A checkpoint without power vectors and with another ring size (a
    Jacobi run, k = 3) still resumes: the vectors are estimated cold and
    the ring seeded with the warm start; the trajectory stays within solver
    tolerance (rtol 1e-8)."""
    path = str(tmp_path / "jac")
    _run(pt, _params(max_iterations=3, checkpoint_interval=3,
                     checkpoint_path=path, preconditioner="jacobi",
                     cg_recycle_k=3))
    assert ckpt_p.load_checkpoint(path)["pvecs"] == []
    res = _run(pt, _params(), resume_from=path)
    np.testing.assert_allclose(res.energy_history,
                               full_runs["port"].energy_history, rtol=1e-8)


def test_checkpoint_files_are_one_format(tmp_path):
    """The same state saved by both packages: the same keys and arrays;
    each loads the other's; a version from the future and a changed
    checkpoint list are refused."""
    rng = np.random.default_rng(0)
    state = dict(
        design=rng.uniform(size=(4, 3, 2)),
        u=rng.standard_normal((5, 4, 3, 3)), iteration=7,
        energy_history=[3.0, 2.0], volume_history=[1.0, 1.0],
        change_history=[0.2, 0.1], cg_history=[10, 12],
        checkpoint_triggered=[True, False],
        pvecs=[rng.standard_normal((5, 4, 3, 3)),
               rng.standard_normal((3, 3, 2, 3))],
        recycle=rng.standard_normal((2, 5, 4, 3, 3)))
    path_p = ckpt_p.save_checkpoint(str(tmp_path / "p"), **state)
    path_r = ckpt_r.save_checkpoint(str(tmp_path / "r"), **state)
    with np.load(path_p) as zp, np.load(path_r) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for key in zp.files:
            assert zp[key].dtype == zr[key].dtype
            np.testing.assert_array_equal(zp[key], zr[key])
    for load, path in ((ckpt_p.load_checkpoint, path_r),
                       (ckpt_r.load_checkpoint, path_p)):
        got = load(path)
        assert got["iteration"] == 7 and got["cg_history"] == [10, 12]
        assert got["checkpoint_triggered"] == [True, False]
        np.testing.assert_array_equal(got["design"], state["design"])
        np.testing.assert_array_equal(got["pvecs"][1], state["pvecs"][1])
        np.testing.assert_array_equal(got["recycle"], state["recycle"])
    with np.load(path_p) as z:
        future = {k: z[k] for k in z.files}
    future["format_version"] = np.asarray(2)
    np.savez(str(tmp_path / "future.npz"), **future)
    with pytest.raises(ValueError, match="version"):
        ckpt_p.load_checkpoint(str(tmp_path / "future"))
    assert ckpt_p.restore_triggered([], [0.1, 0.2]) == [False, False]
    with pytest.raises(ValueError, match="positional"):
        ckpt_p.restore_triggered([True], [0.1, 0.2])


def _small_result(mod):
    params = _params(max_iterations=2, preconditioner="jacobi",
                     cg_recycle_k=0, cg_forcing="fixed")
    grid = _cantilever(mod, (6, 4, 2))[0]
    if mod is et:
        return grid, et.simp_optimize(*_cantilever(et, (6, 4, 2)), params)
    return grid, pt.simp_optimize(*_cantilever(pt, (6, 4, 2)),
                                  params_from_reference(params), device="cpu")


@pytest.mark.parametrize("compress", [True, False])
def test_write_vtu_bytes_equal_reference(tmp_path, compress):
    """The same ResultsData through both writers: byte-identical files,
    and a read_vtu round trip of every field."""
    grid, res = _small_result(pt)
    data = pt.create_results_data(grid, res)
    args = (data.points, data.cells, data.cell_type)
    kw = dict(cell_data={"density": data.densities,
                         "von_mises_stress": data.von_mises},
              point_data={"displacement": data.displacements},
              field_data={"energy": data.energy, "iterations": 3,
                          "converged": False}, compress=compress)
    path_p = vtu_p.write_vtu(str(tmp_path / "p"), *args, **kw)
    path_r = vtu_r.write_vtu(str(tmp_path / "r"), *args, **kw)
    with open(path_p, "rb") as fp, open(path_r, "rb") as fr:
        assert fp.read() == fr.read()
    for read in (vtu_p.read_vtu, vtu_r.read_vtu):
        back = read(path_p)
        np.testing.assert_array_equal(back.points, data.points)
        np.testing.assert_array_equal(back.connectivity.reshape(-1, 8),
                                      data.cells)
        assert set(back.types) == {12}
        np.testing.assert_array_equal(back.cell_data["density"],
                                      data.densities)
        np.testing.assert_array_equal(back.point_data["displacement"],
                                      data.displacements)


def test_results_export_equals_reference(tmp_path):
    """create_results_data and export_results_vtu on the port's result
    against the JAX package's on its own result of the same problem: the
    same mesh arrays and field names; the fields agree to solver
    tolerance."""
    grid_p, res_p = _small_result(pt)
    grid_r, res_r = _small_result(et)
    data_p = pt.create_results_data(grid_p, res_p)
    data_r = et.create_results_data(grid_r, res_r)
    np.testing.assert_array_equal(data_p.points, data_r.points)
    np.testing.assert_array_equal(data_p.cells, data_r.cells)
    assert (data_p.cell_type, data_p.iterations, data_p.converged) == \
        (data_r.cell_type, data_r.iterations, data_r.converged)
    assert np.isclose(data_p.volume_fraction, data_r.volume_fraction,
                      rtol=1e-10)
    back_p = vtu_p.read_vtu(pt.export_results_vtu(data_p,
                                                  str(tmp_path / "p")))
    back_r = vtu_r.read_vtu(et.export_results_vtu(data_r,
                                                  str(tmp_path / "r")))
    assert list(back_p.cell_data) == list(back_r.cell_data) == \
        ["density", "von_mises_stress", "element_energy"]
    assert list(back_p.point_data) == list(back_r.point_data) == \
        ["displacement", "displacement_magnitude"]
    for name in back_r.cell_data:
        np.testing.assert_allclose(back_p.cell_data[name],
                                   back_r.cell_data[name], rtol=1e-6,
                                   atol=1e-10)
    np.testing.assert_allclose(back_p.point_data["displacement"],
                               back_r.point_data["displacement"], rtol=1e-6,
                               atol=1e-10)


def test_interval_and_tolerance_exports(tmp_path):
    """export_interval and tolerance_checkpoints write the reference's
    files, each a results VTU of that iteration."""
    params = _params(max_iterations=4, preconditioner="jacobi",
                     cg_recycle_k=0, export_path=str(tmp_path),
                     export_interval=2, tolerance_checkpoints=[0.5, 1e-12])
    res = _run(pt, params)
    names = sorted(os.listdir(tmp_path))
    assert names == ["final_results_50tol.vtu", "iter_0002.vtu",
                     "iter_0004.vtu", "optimization_progress.csv",
                     "optimization_summary.txt"]
    back = vtu_p.read_vtu(str(tmp_path / "iter_0004.vtu"))
    assert back.cell_data["density"].shape == (np.prod(NELS),)
    # iteration 4's export holds the design that iteration 4 analysed: the
    # final analysis re-solves the design after that update
    assert np.abs(back.cell_data["density"] - res.densities).max() > 1e-6
    assert np.isclose(back.cell_data["density"].mean(), 0.4, atol=1e-6)
    assert np.all(np.isfinite(back.cell_data["von_mises_stress"]))
    assert np.all(back.cell_data["element_energy"] >= 0.0)


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir: a chrome trace of iterations 2-4 (here of the CPU)."""
    import json

    prof = tmp_path / "prof"
    _run(pt, _params(max_iterations=4, preconditioner="jacobi",
                     cg_recycle_k=0, profile_dir=str(prof)))
    files = list(prof.iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    with open(files[0]) as fh:
        assert json.load(fh)["traceEvents"]


def test_bc_export_bytes_equal_reference(tmp_path):
    grid_p, loads_p, bcs_p = _cantilever(pt, (6, 4, 2))
    grid_r, loads_r, bcs_r = _cantilever(et, (6, 4, 2))
    path_p = pt.export_boundary_conditions(grid_p, bcs_p, loads_p,
                                           str(tmp_path / "p"))
    path_r = et.export_boundary_conditions(grid_r, bcs_r, loads_r,
                                           str(tmp_path / "r"))
    with open(path_p, "rb") as fp, open(path_r, "rb") as fr:
        assert fp.read() == fr.read()
    back = vtu_p.read_vtu(path_p)
    assert set(back.cell_data["boundary_type"]) == {1.0}   # the fixed wall


def test_volume_and_mesh_extraction(tmp_path):
    grid_p, grid_r = pt.generate_grid((3, 2, 2)), et.generate_grid((3, 2, 2))
    rho = np.random.default_rng(1).uniform(size=grid_p.n_cells)
    assert pt.calculate_volume(grid_p) == et.calculate_volume(grid_r)
    assert pt.calculate_volume(grid_p, rho) == et.calculate_volume(grid_r,
                                                                   rho)
    np.testing.assert_array_equal(pt.calculate_element_volumes(grid_p),
                                  et.calculate_element_volumes(grid_r))
    assert pt.setup_problem(grid_p) is grid_p
    src = vtu_p.write_vtu(str(tmp_path / "res"), grid_p.node_coords,
                          grid_p.hex_connectivity, 12,
                          cell_data={"density": rho})
    back = vtu_p.read_vtu(extract_mesh_from_vtu(src))
    assert back.cell_data == {}
    np.testing.assert_array_equal(back.points, grid_p.node_coords)


def _results_on_mesh(mod, mesh, tmp_path, tag):
    """create_results_data on a mesh, written as a VTU: the file's bytes."""
    n = mesh.n_cells
    rng = np.random.default_rng(5)
    result = mod.OptimizationResult(
        densities=rng.uniform(size=n),
        displacements=rng.normal(size=mesh.n_dofs), stresses=None,
        energy=1.5, volume=0.4 * mesh.total_volume, iterations=3,
        converged=False, energy_history=[2.0, 1.5], volume_history=[0.4],
        element_energies=rng.uniform(size=n))
    data = mod.create_results_data(mesh, result)
    assert data.cell_type == 10 and data.cells.shape == (n, 4)
    with open(mod.export_results_vtu(data, str(tmp_path / tag)), "rb") as fh:
        return fh.read()


def _bc_export_on_mesh(mod, mesh, tmp_path, tag):
    bc = mod.apply_fixed_boundary(
        mesh, mod.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    load = mod.PointLoad(mod.select_nodes_by_plane(
        mesh, [2, 0, 0], [1, 0, 0], 1e-6), [0.0, -1.0, 0.0])
    with open(mod.export_boundary_conditions(
            mesh, [bc], [load], str(tmp_path / tag)), "rb") as fh:
        return fh.read()


def _volumes_on_mesh(mod, mesh, tmp_path, tag):
    rho = np.random.default_rng(6).uniform(size=mesh.n_cells)
    return (mod.calculate_volume(mesh), mod.calculate_volume(mesh, rho),
            mod.calculate_element_volumes(mesh).tobytes())


@pytest.mark.parametrize("call", [_results_on_mesh, _bc_export_on_mesh,
                                  _volumes_on_mesh])
def test_unstructured_input_is_refused(call, tmp_path):
    """These three calls refused an unstructured mesh until that path was
    ported; now they take a tet mesh and give the JAX package's output, to
    the byte."""
    from easysimp_tpu.mesh import tet_mesh_from_grid

    mesh_p = pt.tet_mesh_from_grid(pt.generate_grid((2, 2, 2)))
    mesh_r = tet_mesh_from_grid(et.generate_grid((2, 2, 2)))
    out_p = call(pt, mesh_p, tmp_path, "p")
    assert out_p == call(et, mesh_r, tmp_path, "r")
    assert out_p
