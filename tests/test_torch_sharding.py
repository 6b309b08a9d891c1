"""The port's multi-device path against the JAX package's, on the CPU.

The port's shards are `["cpu"] * 8` (one process, every shard on the CPU);
the JAX side runs on conftest.py's 8 virtual CPU devices.  float64: one
SIMP step against the JAX package's `build_voxel_step(mesh=...)` with the
tolerances of tests/test_sharding.py:93-100, whole runs against its
`simp_optimize` (energies rtol 1e-8, densities 1e-9), the element-sharded
unstructured path, the dry-run twin against MULTICHIP_r05.json, and the
refusals.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu.mesh import UnstructuredMesh
from easysimp_tpu.opt.optimize import build_voxel_step as build_r
from easysimp_tpu.parallel import sharding as sh_r
from easysimp_tpu_torch.carry import mesh_from_reference, params_from_reference
from easysimp_tpu_torch.opt.optimize import build_voxel_step as build_p
from easysimp_tpu_torch.parallel import sharding as sh_p

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


def _problem(mod, nels):
    grid = mod.generate_grid(nels, (0.0, 0.0, 0.0),
                             tuple(float(n) for n in nels))
    bc = mod.apply_fixed_boundary(
        grid, mod.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    nx, ny, nz = nels
    load = mod.PointLoad(
        mod.select_nodes_by_box(grid, [nx, 0, 0], [nx, 0, nz]),
        [0.0, -1.0, 0.0])
    return grid, [load], [bc]


@pytest.mark.parametrize("n, nels, want", [
    (8, (16, 8, 4), (8, 1, 1)), (8, (4, 16, 4), (1, 8, 1)),
    (4, (6, 6, 6), None), (8, (6, 6, 4), None)])
def test_best_mesh_shape(n, nels, want):
    """The port's own copy against the reference's cases
    (tests/test_sharding.py:43-47) and the reference function."""
    got = sh_p.best_mesh_shape(n, nels)
    assert got == sh_r.best_mesh_shape(n, nels)
    assert int(np.prod(got)) == n
    if want is not None:
        assert got == want


def test_make_mesh():
    m = sh_p.make_mesh(8, shape=(4, 2, 1), devices=CPU8)
    assert m.axis_names == ("x", "y", "z")
    assert m.shape == {"x": 4, "y": 2, "z": 1}
    assert m.devices.shape == (4, 2, 1)
    with pytest.raises(ValueError):
        sh_p.make_mesh(8, shape=(3, 2, 1), devices=CPU8)
    if not torch.cuda.is_available():
        # a mesh never falls back to the CPU on its own
        with pytest.raises(RuntimeError):
            sh_p.make_mesh(2)
        with pytest.raises(RuntimeError):
            sh_p.make_mesh(2, devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("shape", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
def test_sharded_step_matches_reference(devices, shape):
    """One SIMP step (multigrid PCG, filters, OC) on 16x8x4 over a mesh
    against the JAX package's sharded step on the same split."""
    params_r = et.OptimizationParameters(
        E0=100.0, Emin=1e-6, volume_fraction=0.4, filter_radius=1.5,
        dtype="float64", cg_rtol=1e-11)
    vs_r = build_r(*_problem(et, (16, 8, 4)), params_r,
                   mesh=sh_r.make_mesh(8, shape=shape, devices=devices))
    pv = jax.jit(vs_r.power_init)(vs_r.design0, vs_r.step_args[1])
    out_r = jax.jit(vs_r.step)(vs_r.design0, vs_r.u0, pv, *vs_r.step_args)

    vs = build_p(*_problem(pt, (16, 8, 4)), params_from_reference(params_r),
                 device="cpu",
                 mesh=sh_p.make_mesh(8, shape=shape, devices=CPU8))
    state, _ = vs.setup(vs.design0, vs.power_init(vs.design0))
    out = vs.step(vs.design0, vs.u0, state)

    np.testing.assert_allclose(vs.gather(out.new_design).numpy(),
                               np.asarray(out_r[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(vs.gather(out.u).numpy(),
                               np.asarray(vs_r.crop_node(out_r[1])),
                               rtol=1e-7, atol=1e-9)
    assert np.isclose(float(out.energy), float(out_r[3]), rtol=1e-9)
    assert np.isclose(float(out.volume), float(out_r[4]), rtol=1e-12)
    assert np.isclose(out.lam, float(out_r[5]), rtol=1e-9)
    assert out.cg_iters == int(out_r[6])


_RUNS = {}


def _reference_run(**kw):
    """The JAX package's unsharded run of 8x8x4 (one per configuration)."""
    key = tuple(sorted(kw.items()))
    if key not in _RUNS:
        params = et.OptimizationParameters(
            E0=100.0, Emin=1e-6, volume_fraction=0.5, max_iterations=4,
            tolerance=0.01, filter_radius=1.5, dtype="float64",
            cg_rtol=1e-11, **kw)
        _RUNS[key] = (params, et.simp_optimize(*_problem(et, (8, 8, 4)),
                                               params))
    return _RUNS[key]


@pytest.mark.parametrize("shape, kw", [((4, 2, 1), {}),
                                       ((2, 2, 2), {"cg_recycle_k": 3})])
def test_sharded_optimize_matches_reference(shape, kw):
    """simp_optimize(mesh=...) against the JAX package's simp_optimize, as
    tests/test_sharding.py:103-131 hold the JAX package's sharded runs."""
    params_r, res_r = _reference_run(**kw)
    res = pt.simp_optimize(
        *_problem(pt, (8, 8, 4)), params_from_reference(params_r),
        device="cpu", mesh=sh_p.make_mesh(8, shape=shape, devices=CPU8))
    np.testing.assert_allclose(res.energy_history, res_r.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res.densities, res_r.densities, atol=1e-9)
    assert res.cg_iterations_history == res_r.cg_iterations_history
    assert res.densities.shape == (8 * 8 * 4,)
    assert res.displacements.shape == (3 * 9 * 9 * 5,)


@pytest.mark.parametrize("saved_on, resumed_on", [("mesh", None),
                                                  (None, "mesh")])
def test_checkpoint_across_mesh(tmp_path, saved_on, resumed_on):
    """A checkpoint saved under a mesh resumes without one (and the other
    way round) and continues the unsharded trajectory: the recycle ring and
    the power vectors travel in the global layout."""
    params = pt.OptimizationParameters(
        E0=100.0, Emin=1e-6, volume_fraction=0.5, max_iterations=6,
        tolerance=1e-9, filter_radius=1.5, dtype="float64", cg_rtol=1e-11,
        cg_recycle_k=3, checkpoint_interval=3,
        checkpoint_path=str(tmp_path / "ckpt"))
    mesh = sh_p.make_mesh(8, shape=(2, 2, 2), devices=CPU8)
    on = {"mesh": mesh, None: None}
    full = pt.simp_optimize(*_problem(pt, (8, 8, 4)), params, device="cpu")
    first = dataclasses.replace(params, max_iterations=3)
    pt.simp_optimize(*_problem(pt, (8, 8, 4)), first, device="cpu",
                     mesh=on[saved_on])
    res = pt.simp_optimize(*_problem(pt, (8, 8, 4)), params, device="cpu",
                           mesh=on[resumed_on],
                           resume_from=str(tmp_path / "ckpt"))
    np.testing.assert_allclose(res.energy_history, full.energy_history,
                               rtol=1e-10)
    assert res.cg_iterations_history == full.cg_iterations_history
    np.testing.assert_allclose(res.densities, full.densities, atol=1e-12)


@pytest.mark.parametrize("accel, mg", [
    (None, dict(filter_type="density", cg_forcing="adaptive",
                mg_full_setup_every=2, mg_setup_every=2)),
    (([0.0, -9.81, 0.0], 1e-3), dict(material_model="simp"))])
def test_sharded_options_match_unsharded(tmp_path, accel, mg):
    """Density filter, adaptive forcing, light setups, body force, a
    material_model and exports under a mesh against the port's own
    unsharded run (float64, 1e-10)."""
    kw = dict(mg)
    if kw.get("material_model") == "simp":
        kw["material_model"] = pt.create_simp_material_model(100.0, 0.3,
                                                             1e-6, 3.0)
    outs = {}
    for name, mesh in [("one", None), ("mesh", sh_p.make_mesh(
            8, shape=(4, 2, 1), devices=CPU8))]:
        params = pt.OptimizationParameters(
            E0=100.0, Emin=1e-6, volume_fraction=0.5, max_iterations=4,
            tolerance=1e-9, filter_radius=1.5, dtype="float64",
            cg_rtol=1e-10, export_path=str(tmp_path / name),
            export_interval=2, **kw)
        outs[name] = pt.simp_optimize(*_problem(pt, (16, 8, 4)), params,
                                      accel, device="cpu", mesh=mesh)
    np.testing.assert_allclose(outs["mesh"].energy_history,
                               outs["one"].energy_history, rtol=1e-10)
    np.testing.assert_allclose(outs["mesh"].element_energies,
                               outs["one"].element_energies, rtol=1e-9,
                               atol=1e-14)
    assert sorted(os.listdir(tmp_path / "mesh")) == \
        sorted(os.listdir(tmp_path / "one"))


def _tet_problem(mod):
    grid = et.generate_grid((4, 2, 2), (0.0, 0.0, 0.0), (4.0, 2.0, 2.0))
    conn = grid.hex_connectivity
    tets = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
            (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]
    mesh = UnstructuredMesh(
        node_coords=grid.node_coords,
        connectivity=np.concatenate([conn[:, list(t)] for t in tets]))
    if mod is pt:
        mesh = mesh_from_reference(mesh)
    bc = mod.apply_fixed_boundary(
        mesh, mod.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    load = mod.PointLoad(mod.select_nodes_by_box(mesh, [4, 0, 0], [4, 0, 2]),
                         [0.0, -1.0, 0.0])
    return mesh, [load], [bc]


@pytest.mark.parametrize("smooth", [False, True])
def test_element_sharded_matches_reference(smooth):
    """The element-sharded unstructured path, both prolongators, against the
    JAX package's unsharded run (tests/test_sharding.py:204-250)."""
    params_r = et.OptimizationParameters(
        E0=100.0, Emin=1e-6, volume_fraction=0.5,
        max_iterations=3 if smooth else 4, tolerance=0.01,
        filter_radius=1.5, dtype="float64", cg_rtol=1e-11,
        amg_smooth_prolongator=smooth)
    res_r = et.simp_optimize(*_tet_problem(et), params_r)
    mesh, loads, bcs = _tet_problem(pt)
    dm = sh_p.make_element_mesh(mesh.n_cells, devices=CPU8)
    assert dm.size == 8
    res = pt.simp_optimize(mesh, loads, bcs, params_from_reference(params_r),
                           device="cpu", mesh=dm)
    np.testing.assert_allclose(res.energy_history, res_r.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(res.densities, res_r.densities, atol=1e-9)
    assert res.cg_iterations_history == res_r.cg_iterations_history


@pytest.mark.parametrize("n_elements, n_devices, want",
                         [(16490, None, 5), (36552, None, 8), (7, 4, 1)])
def test_make_element_mesh_divisibility(n_elements, n_devices, want):
    got = sh_p.make_element_mesh(n_elements, n_devices=n_devices,
                                 devices=CPU8)
    assert got.size == want
    assert got.axis_names == ("e",)


def test_dryrun_twin():
    """The dry run on eight CPU shards against MULTICHIP_r05.json: energy
    4.009019e+01 and CG 11 on all three splits, 8.712991e+01 for the tets
    (float32 with CG at 1e-6: rtol 1e-5)."""
    from easysimp_tpu_torch.dryrun import dryrun_multichip

    results = dryrun_multichip(8, devices=CPU8)
    assert [r[0] for r in results] == [(8, 1, 1), (4, 2, 1), (2, 2, 2),
                                       "tets"]
    for _, energy, cg in results[:3]:
        assert abs(energy - 4.009019e+01) <= 1e-5 * 4.009019e+01
        assert cg == 11
    assert abs(results[3][1] - 8.712991e+01) <= 1e-5 * 8.712991e+01


def test_mesh_refusals():
    grid, loads, bcs = _problem(pt, (8, 4, 4))
    params = pt.OptimizationParameters(max_iterations=1, dtype="float64")
    emesh = sh_p.make_element_mesh(64, devices=CPU8)
    with pytest.raises(ValueError, match="'x','y','z'"):
        pt.simp_optimize(grid, loads, bcs, params, device="cpu", mesh=emesh)
    tets = _tet_problem(pt)
    with pytest.raises(ValueError, match="'e',"):
        pt.simp_optimize(*tets, params, device="cpu",
                         mesh=sh_p.make_mesh(8, devices=CPU8))
    # device= and mesh= that disagree
    with pytest.raises(ValueError, match="disagrees"):
        pt.simp_optimize(grid, loads, bcs, params, device="cuda",
                         mesh=sh_p.make_mesh(4, devices=CPU8))

