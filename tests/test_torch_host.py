"""The port's host layer against the JAX package: import hygiene, grids,
boundary conditions and loads (exact)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu.models import beam_2x1x1


def test_import_without_jax():
    """The port imports with jax blocked, and importing it pulls in neither
    triton nor torch.utils.cpp_extension."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import easysimp_tpu_torch
        import easysimp_tpu_torch.carry
        import easysimp_tpu_torch.opt.logger
        import easysimp_tpu_torch.ops.cuda_kernels
        import easysimp_tpu_torch.opt.checkpoint
        import easysimp_tpu_torch.opt.continuation
        import easysimp_tpu_torch.opt.verify_sensitivities
        import easysimp_tpu_torch.post.bc_export
        import easysimp_tpu_torch.post.vtu
        import easysimp_tpu_torch.utils.extract_mesh
        import easysimp_tpu_torch.utils.volume
        import easysimp_tpu_torch.models.beam_2x1x1
        import easysimp_tpu_torch.models.cantilever
        import easysimp_tpu_torch.models.tol_study
        import easysimp_tpu_torch.mesh
        import easysimp_tpu_torch.native
        import easysimp_tpu_torch.ops.amg
        import easysimp_tpu_torch.opt.optimize_unstructured
        import easysimp_tpu_torch.models.gripper
        import easysimp_tpu_torch.models.wheel
        import easysimp_tpu_torch.parallel
        import easysimp_tpu_torch.parallel.sharded_multigrid
        import easysimp_tpu_torch.parallel.sharded_step
        import easysimp_tpu_torch.parallel.element_step
        import easysimp_tpu_torch.dryrun
        bad = [m for m in ("triton", "torch.utils.cpp_extension",
                           "easysimp_tpu") if m in sys.modules]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _bench_cantilever(mod, nels):
    nx, ny, nz = nels
    grid = mod.generate_grid(nels, (0.0, 0.0, 0.0),
                             tuple(float(n) for n in nels))
    bc = mod.apply_fixed_boundary(
        grid, mod.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    load = mod.PointLoad(
        mod.select_nodes_by_box(grid, [nx, 0, 0], [nx, 0, nz]),
        [0.0, -1.0, 0.0])
    return grid, [load], [bc]


def _assert_same_setup(grid_r, loads_r, bcs_r, grid_p, loads_p, bcs_p):
    np.testing.assert_array_equal(grid_p.node_coords, grid_r.node_coords)
    np.testing.assert_array_equal(grid_p.hex_connectivity,
                                  grid_r.hex_connectivity)
    np.testing.assert_array_equal(pt.build_free_mask(grid_p, bcs_p),
                                  et.build_free_mask(grid_r, bcs_r))
    np.testing.assert_array_equal(pt.build_load_field(grid_p, loads_p),
                                  et.build_load_field(grid_r, loads_r))


def test_bench_cantilever_setup():
    """The bench.py problem, built with each package's own selectors."""
    nels = (12, 6, 4)
    _assert_same_setup(*_bench_cantilever(et, nels),
                       *_bench_cantilever(pt, nels))


@pytest.mark.parametrize("variant", ["four_legs", "mbb", "michell",
                                     "michell_half"])
def test_beam_2x1x1_setups(variant):
    """models/beam_2x1x1.py at a reduced size: the reference's node sets,
    carried into the port's BC and load objects, give the same free mask
    and load field; the port's selectors find the same nodes."""
    build = getattr(beam_2x1x1, f"build_{variant}")
    nels = (10, 6, 6)
    grid_r, loads_r, bcs_r, _, _ = build(nels)
    grid_p = pt.generate_grid(nels, (0.0, 0.0, 0.0), (2.0, 1.0, 1.0))
    bcs_p = [pt.DirichletBC(bc.nodes, bc.components) for bc in bcs_r]
    loads_p = [pt.PointLoad(ld.nodes, ld.force_vector) for ld in loads_r]
    _assert_same_setup(grid_r, loads_r, bcs_r, grid_p, loads_p, bcs_p)
    for sel, args in [("select_nodes_by_plane", ([0, 0, 1.0], [0, 0, 1.0])),
                      ("select_nodes_by_circle",
                       ([2.0, 0.5, 0.5], [1.0, 0.0, 0.0], 0.2))]:
        np.testing.assert_array_equal(getattr(pt, sel)(grid_p, *args),
                                      getattr(et, sel)(grid_r, *args))
    assert pt.closest_node(grid_p, [0.0, 1.0, 0.5]) == \
        et.closest_node(grid_r, [0.0, 1.0, 0.5])


def test_surface_traction_load():
    """SurfaceTractionLoad integrates the same nodal forces."""
    nels = (4, 3, 2)
    grid_r = et.generate_grid(nels)
    grid_p = pt.generate_grid(nels)
    nodes = et.select_nodes_by_plane(grid_r, [4, 0, 0], [1, 0, 0], 1e-6)
    fn = lambda x, y, z: (0.0, -1.0 - y, 0.5 * z)
    np.testing.assert_array_equal(
        pt.build_load_field(grid_p, [pt.SurfaceTractionLoad(nodes, fn)]),
        et.build_load_field(grid_r, [et.SurfaceTractionLoad(nodes, fn)]))


def test_carry_params_and_fields():
    """carry.py copies the reference's parameters field by field and takes
    numpy fields in the JAX layouts."""
    import dataclasses

    import torch
    from easysimp_tpu_torch.carry import fields_from_numpy, params_from_reference

    ref = et.OptimizationParameters(E0=7.0, volume_fraction=0.3,
                                    filter_type="density", cg_recycle_k=4,
                                    preconditioner="jacobi",
                                    tolerance_checkpoints=[0.1])
    got = params_from_reference(ref)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    design = np.full((3, 2, 2), 0.4)
    u = np.zeros((4, 3, 3, 3))
    d_t, u_t = fields_from_numpy(design, u, dtype="float64", device="cpu")
    assert d_t.dtype == torch.float64 and tuple(u_t.shape) == u.shape
    with pytest.raises(ValueError):
        fields_from_numpy(design, u[:, :2], dtype="float64", device="cpu")


def test_voxel_body_force():
    """The variable-density body force node field (1e-12)."""
    import jax.numpy as jnp
    import torch

    from easysimp_tpu.loads import voxel_body_force as ref_force
    from easysimp_tpu_torch.loads import voxel_body_force

    rho = np.random.default_rng(8).uniform(0.0, 1.0, (5, 4, 3))
    rho[0, 0, 0] = 1e-7                    # below the reference's skip
    accel = (0.0, -9.81, 1.5)
    want = np.asarray(ref_force(jnp.asarray(rho), accel, 2.5, 0.125,
                                jnp.float64))
    got = voxel_body_force(torch.tensor(rho), accel, 2.5, 0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
