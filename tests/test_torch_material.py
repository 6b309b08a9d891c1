"""The port's two-field Lamé path (`material_model`) against the JAX
package, in float64 on the CPU: the basis stiffnesses, the operator's Lamé
methods, a varying-nu operator against a dense assembly, `simp_optimize`
with the SIMP closure and with a RAMP law, and the stresses.

On the CPU `apply_K_lame` and `element_energies_lame` run the kernels'
plain versions; `chip_smoke.py` (phase `lame`) holds the two-launch route
against `apply_K_lame_plain` on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu.ops import elements as el_r
from easysimp_tpu.stress import voxel_stress_arrays as stress_arrays_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.carry import params_from_reference
from easysimp_tpu_torch.ops import cuda_kernels as ck
from easysimp_tpu_torch.ops import elements as el_p
from easysimp_tpu_torch.stress import voxel_stress_arrays as stress_arrays_p


def _ramp_model(lame_parameters):
    """RAMP interpolation (q = 4) with a density-dependent Poisson ratio,
    the law of tests/test_material_model.py:146."""
    def model(r):
        E = 1e-6 + r / (1.0 + 4.0 * (1.0 - r))
        nu = 0.25 + 0.1 * r
        return lame_parameters(E, nu)
    return model


def _varying_nu_model(mod):
    def model(r):
        E = mod.simp_youngs_modulus(r, 1.0, 1e-6, 3.0)
        return mod.lame_parameters(E, 0.2 + 0.15 * r)
    return model


def _operators(nels, extents, seed):
    rng = np.random.default_rng(seed)
    op_r = et.VoxelOperator(et.generate_grid(nels, (0.0, 0.0, 0.0), extents),
                            dtype=jnp.float64)
    op_p = pt.VoxelOperator(pt.generate_grid(nels, (0.0, 0.0, 0.0), extents),
                            dtype=torch.float64, device="cpu")
    u = rng.standard_normal((*op_r.grid.nnodes_per_axis, 3))
    rho = rng.uniform(0.05, 1.0, nels)
    mask = np.ones_like(u)
    mask[0] = 0.0
    return op_r, op_p, u, rho, mask


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.8, 0.55, 1.3)])
def test_lame_basis_matches_reference(spacing):
    """(ke_lam, ke_mu) against the JAX package, 1e-13; symmetric; and
    lam*ke_lam + mu*ke_mu rebuilds hex8_stiffness."""
    got = el_p.hex8_stiffness_lame_basis(spacing)
    want = el_r.hex8_stiffness_lame_basis(spacing)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-13, atol=1e-13)
        assert np.array_equal(g, g.T)
    lam, mu = el_p.create_material_model(3.7, 0.28)
    assert (lam, mu) == el_r.create_material_model(3.7, 0.28)
    np.testing.assert_allclose(lam * got[0] + mu * got[1],
                               el_p.hex8_stiffness(spacing, 3.7, 0.28),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(el_p.elasticity_matrix_lame(1.3, 0.7),
                                  el_r.elasticity_matrix_lame(1.3, 0.7))


@pytest.mark.parametrize("method", ["apply_K_lame", "apply_K_lame_plain",
                                    "apply_lame", "diagonal_lame",
                                    "element_energies_lame"])
@pytest.mark.parametrize("zero_lam", [False, True])
def test_lame_operator_matches_reference(method, zero_lam):
    """The operator's Lamé methods against the JAX operator with random
    positive Lamé fields, and with lam = 0 where mu is not: 1e-12 (element
    energies 1e-11)."""
    op_r, op_p, u, rho, mask = _operators((7, 5, 4), (1.4, 0.6, 0.5), seed=1)
    rng = np.random.default_rng(2)
    lam = np.zeros_like(rho) if zero_lam else rng.uniform(1e-9, 2.0,
                                                          rho.shape)
    mu = rng.uniform(1e-9, 2.0, rho.shape)
    args = {"apply_K_lame": (u, lam, mu), "apply_K_lame_plain": (u, lam, mu),
            "apply_lame": (u, lam, mu, mask),
            "diagonal_lame": (lam, mu, mask),
            "element_energies_lame": (u,)}[method]
    ref_method = method.replace("_plain", "")
    want = getattr(op_r, ref_method)(*map(jnp.asarray, args))
    got = getattr(op_p, method)(*map(torch.tensor, args))
    tol = 1e-11 if method == "element_energies_lame" else 1e-12
    if method == "element_energies_lame":
        want, got = jnp.stack(want), torch.stack(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_simp_law_through_lame_equals_fast_path():
    """apply_K_lame(u, lam(E), mu(E)) == apply_K(u, E), fp64 roundoff."""
    _, op_p, u, rho, _ = _operators((6, 4, 3), (4.8, 3.2, 2.4), seed=0)
    E = op_p.youngs_modulus(torch.tensor(rho))
    lam, mu = el_p.lame_parameters(E, op_p.nu)
    np.testing.assert_allclose(
        op_p.apply_K_lame(torch.tensor(u), lam, mu).numpy(),
        op_p.apply_K(torch.tensor(u), E).numpy(), rtol=1e-12, atol=1e-12)


def test_varying_nu_matches_dense_assembly():
    """A density-dependent Poisson ratio, which unit-ke scaling cannot
    express, against a per-element dense assembly (as
    tests/test_material_model.py:66), 1e-10."""
    op_r, op_p, u, rho, _ = _operators((3, 2, 2), (2.4, 1.6, 1.6), seed=1)
    grid = op_r.grid
    lam, mu = _varying_nu_model(el_p)(torch.tensor(rho))
    got = grid.dofs_flat(op_p.apply_K_lame(torch.tensor(u), lam, mu).numpy())
    conn = grid.hex_connectivity
    coords = grid.node_coords[conn]
    K = np.zeros((grid.n_dofs, grid.n_dofs))
    lam_e, mu_e = grid.cells_flat(lam.numpy()), grid.cells_flat(mu.numpy())
    for e in range(conn.shape[0]):
        nu = lam_e[e] / (2.0 * (lam_e[e] + mu_e[e]))
        E = 2.0 * mu_e[e] * (1.0 + nu)
        ke, _ = el_r.element_stiffness_batch_np(coords[e:e + 1], E=E, nu=nu)
        dofs = (3 * conn[e][:, None] + np.arange(3)).reshape(-1)
        K[np.ix_(dofs, dofs)] += ke[0]
    np.testing.assert_allclose(got, K @ grid.dofs_flat(u), rtol=1e-10,
                               atol=1e-10)


def test_lame_path_goes_through_the_kernel_wrappers(monkeypatch):
    """apply_K_lame is two voxel_matvec calls with (lam, ke_lam) and
    (mu, ke_mu), element_energies_lame two voxel_energies calls: the
    wrappers that launch the kernels on CUDA tensors."""
    from easysimp_tpu_torch.ops import operator

    _, op_p, u, rho, _ = _operators((4, 3, 2), (1.0, 1.0, 1.0), seed=3)
    calls = []

    def matvec(u, scale, ke):
        calls.append(("matvec", scale, ke))
        return ck.voxel_matvec(u, scale, ke)

    def energies(u, ke):
        calls.append(("energies", None, ke))
        return ck.voxel_energies(u, ke)

    monkeypatch.setattr(operator, "voxel_matvec", matvec)
    monkeypatch.setattr(operator, "voxel_energies", energies)
    lam, mu = torch.tensor(rho), torch.tensor(2.0 * rho)
    ke_lam, ke_mu = op_p.ke_lame_basis
    op_p.apply_K_lame(torch.tensor(u), lam, mu)
    op_p.element_energies_lame(torch.tensor(u))
    assert [(c[0], c[1] is None or c[1] is s, c[2] is k) for c, s, k in zip(
        calls, (lam, mu, None, None), (ke_lam, ke_mu, ke_lam, ke_mu))] == \
        [("matvec", True, True)] * 2 + [("energies", True, True)] * 2


def _cantilever(mod, nels):
    grid = mod.generate_grid(nels)
    bc = mod.apply_fixed_boundary(
        grid, mod.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    load = mod.PointLoad(
        mod.select_nodes_by_box(grid, [nels[0], 0, 0],
                                [nels[0], 0, nels[2]]), [0.0, -1.0, 0.0])
    return grid, [load], [bc]


_KW = dict(E0=100.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.4,
           max_iterations=4, tolerance=0.0, filter_radius=1.5,
           dtype="float64", cg_rtol=1e-12)


@pytest.mark.parametrize("precond,filter_type", [
    ("jacobi", "sensitivity"), ("multigrid", "density")])
def test_simp_closure_trajectory(precond, filter_type):
    """material_model=<SIMP closure>: the port's default path (rtol 1e-9,
    as tests/test_material_model.py:109) and the JAX package with its jnp
    closure (rtol 1e-8)."""
    nels = (8, 4, 2)
    kw = dict(_KW, preconditioner=precond, filter_type=filter_type)
    fast = pt.simp_optimize(*_cantilever(pt, nels),
                            pt.OptimizationParameters(**kw), device="cpu")
    model = pt.create_simp_material_model(100.0, 0.3, Emin=1e-6, p=3.0)
    got = pt.simp_optimize(
        *_cantilever(pt, nels),
        pt.OptimizationParameters(material_model=model, **kw), device="cpu")
    np.testing.assert_allclose(got.energy_history, fast.energy_history,
                               rtol=1e-9)
    np.testing.assert_allclose(got.densities, fast.densities, atol=1e-9)
    np.testing.assert_allclose(got.element_energies, fast.element_energies,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.stresses.qp_stresses,
                               fast.stresses.qp_stresses, rtol=1e-8,
                               atol=1e-12)

    params_r = et.OptimizationParameters(
        material_model=et.create_simp_material_model(100.0, 0.3, Emin=1e-6,
                                                     p=3.0), **kw)
    want = et.simp_optimize(*_cantilever(et, nels), params_r)
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(got.cg_iterations_history,
                               want.cg_iterations_history, rtol=0, atol=1)
    np.testing.assert_allclose(got.densities, want.densities, atol=1e-7)


def test_ramp_trajectory_matches_jax():
    """A law with density-dependent nu through both packages, rtol 1e-8."""
    nels = (8, 4, 2)
    kw = dict(_KW, preconditioner="jacobi", max_iterations=3)
    want = et.simp_optimize(*_cantilever(et, nels), et.OptimizationParameters(
        material_model=_ramp_model(el_r.lame_parameters), **kw))
    got = pt.simp_optimize(*_cantilever(pt, nels), pt.OptimizationParameters(
        material_model=_ramp_model(el_p.lame_parameters), **kw), device="cpu")
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(got.densities, want.densities, atol=1e-7)
    np.testing.assert_allclose(got.stresses.von_mises,
                               want.stresses.von_mises, rtol=1e-6,
                               atol=1e-10)


def test_ramp_sensitivities_match_finite_differences():
    """The jvp material derivative against central differences for the RAMP
    law with varying nu (tests/test_material_model.py:133), rtol 2e-4."""
    model = _ramp_model(el_p.lame_parameters)
    params = pt.OptimizationParameters(
        material_model=model, volume_fraction=0.4, filter_radius=1.5,
        dtype="float64", cg_rtol=1e-13, preconditioner="jacobi")
    vs = pt.build_voxel_step(*_cantilever(pt, (5, 3, 2)), params,
                             device="cpu")
    design = torch.tensor(np.random.default_rng(3).uniform(0.3, 0.9,
                                                           vs.grid.nels))
    state, _ = vs.setup(design, ())
    out = vs.step(design, vs.u0, state)
    # the sensitivity filter is linear: undo nothing, compare the raw
    # material derivative of the energy 0.5 u^T K u, which is -0.5 * that of
    # the compliance at fixed load
    _, (dlam, dmu) = torch.func.jvp(model, (out.phys,),
                                    (torch.ones_like(out.phys),))
    wl, wm = vs.op.element_energies_lame(out.u)
    sens = -(dlam * wl + dmu * wm)

    def energy(d):
        return float(vs.step(d, vs.u0, vs.setup(d, ())[0]).energy)

    h = 1e-6
    for ijk in [(0, 0, 0), (2, 1, 1), (4, 2, 1)]:
        dp, dm = design.clone(), design.clone()
        dp[ijk] += h
        dm[ijk] -= h
        fd = (energy(dp) - energy(dm)) / (2 * h)
        np.testing.assert_allclose(float(sens[ijk]) / 2.0, fd, rtol=2e-4)


@pytest.mark.parametrize("law", ["simp", "varying_nu"])
def test_stresses_with_material_model_match_jax(law):
    """voxel_stress_arrays(material_model=...) against the JAX package,
    1e-12."""
    op_r, op_p, u, rho, _ = _operators((5, 4, 3), (1.0, 0.8, 0.9), seed=4)
    if law == "simp":
        m_r = et.create_simp_material_model(70.0, 0.3, 1e-6, 3.0)
        m_p = pt.create_simp_material_model(70.0, 0.3, 1e-6, 3.0)
    else:
        m_r, m_p = _varying_nu_model(el_r), _varying_nu_model(el_p)
    want = stress_arrays_r(op_r.grid, jnp.asarray(u), jnp.asarray(rho), 1.0,
                           1e-9, 0.3, 3.0, material_model=m_r)
    got = stress_arrays_p(op_p.grid, torch.tensor(u), torch.tensor(rho), 1.0,
                          1e-9, 0.3, 3.0, material_model=m_p)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_params_from_reference_material_model():
    """A jnp closure cannot be carried over: the caller gives the torch
    callable, or the copy is refused."""
    ref = et.OptimizationParameters(
        material_model=et.create_simp_material_model(1.0, 0.3))
    with pytest.raises(ValueError, match="material_model"):
        params_from_reference(ref)
    model = pt.create_simp_material_model(1.0, 0.3)
    assert params_from_reference(ref, model).material_model is model
    assert params_from_reference(
        et.OptimizationParameters()).material_model is None
