"""The port's multilevel aggregation AMG against the JAX package's, on the
CPU in float64 on the same problem: host structures EQUAL (the numpy code is
the same), setup blocks / inverses / the coarsest factor to rtol 1e-10, one
V-cycle to rtol 1e-9, for the tentative and the smoothed prolongator; plus
what the reference's own tests hold (SPD, better than block Jacobi, chunked
assembly, a deep hierarchy) and a float32 run at 1e9 contrast."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu import mesh as mesh_r
from easysimp_tpu.ops import amg as amg_r
from easysimp_tpu.ops.elements import element_stiffness_batch_np
from easysimp_tpu.ops.operator import UnstructuredOperator as OperatorR
import easysimp_tpu_torch as pt
from easysimp_tpu_torch import mesh as mesh_p
from easysimp_tpu_torch.ops import amg as amg_p
from easysimp_tpu_torch.ops.cg import cg_solve
from easysimp_tpu_torch.ops.operator import UnstructuredOperator as OperatorP

NELS = (6, 3, 3)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tets(mod, nels):
    tet_mesh_from_grid = (mesh_p if mod is pt else mesh_r).tet_mesh_from_grid
    return tet_mesh_from_grid(mod.generate_grid(
        nels, (0.0, 0.0, 0.0), tuple(float(n) for n in nels)))


def _inputs(nels=NELS, seed=0, contrast=1e9):
    """mesh data and the binary-ish density field of tests/test_amg.py (the
    SIMP-contrast regime that kills Jacobi), as numpy."""
    mesh = _tets(pt, nels)
    bc = pt.apply_fixed_boundary(
        mesh, pt.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    ke, _ = element_stiffness_batch_np(
        mesh.node_coords[mesh.connectivity], E=1.0, nu=0.3)
    mask = pt.build_free_mask(mesh, [bc])
    rng = np.random.default_rng(seed)
    rho = np.where(rng.uniform(size=mesh.n_cells) < 0.5, 1.0, 1e-3)
    f = rng.standard_normal(mesh.n_dofs) * mask
    return mesh, ke, mask, rho, f, dict(E0=1.0, Emin=1.0 / contrast, nu=0.3,
                                        p=3.0)


def _port(nels=NELS, dtype=torch.float64, **amg_kw):
    mesh, ke, mask, rho, f, kw = _inputs(nels)
    op = OperatorP(ke, mesh.connectivity, mesh.n_nodes, **kw, dtype=dtype,
                   device="cpu")
    amg = amg_p.MultilevelAMG(op, mesh, mask, **amg_kw)
    scale = op.youngs_modulus(_t(rho, dtype))
    return mesh, op, amg, _t(mask, dtype), scale, _t(f, dtype)


_REFERENCE = {}


def _reference(smooth, max_coarse_dofs):
    """The JAX side of one configuration, built and set up once per module
    (its compiles dominate)."""
    key = (smooth, max_coarse_dofs)
    if key not in _REFERENCE:
        mesh, ke, mask, rho, f, kw = _inputs()
        mesh_j = _tets(et, NELS)
        op = OperatorR(ke, mesh_j.connectivity, mesh_j.n_nodes, **kw,
                       dtype=jnp.float64)
        amg = amg_r.MultilevelAMG(op, mesh_j, mask, smooth_prolongator=smooth,
                                  max_coarse_dofs=max_coarse_dofs)
        mask_j = jnp.asarray(mask)
        scale = op.youngs_modulus(jnp.asarray(rho))
        A = lambda v: op.apply(v, scale, mask_j)
        Binv = op.block_diagonal_inverse(scale, mask_j)
        state = amg.setup(scale, mask_j, Binv, A)
        z = amg.apply(jnp.asarray(f), A, Binv, state, mask_j)
        _REFERENCE[key] = (amg, state, np.asarray(z))
    return _REFERENCE[key]


def test_host_structures_equal_reference():
    mesh = _tets(pt, NELS)
    for max_agg in (0, 5):
        agg_p, n_p = amg_p.greedy_aggregate(mesh.connectivity, mesh.n_nodes,
                                            max_agg=max_agg)
        agg_r, n_r = amg_r.greedy_aggregate(mesh.connectivity, mesh.n_nodes,
                                            max_agg=max_agg)
        assert n_p == n_r and agg_p.dtype == np.int32
        np.testing.assert_array_equal(agg_p, agg_r)
    assert agg_p.min() >= 0 and agg_p.max() == n_p - 1
    mask = np.ones((mesh.n_nodes, 3))
    mask[:4, 1] = 0.0
    P_p, B_p = amg_p.rigid_body_prolongator(mesh.node_coords, agg_p, n_p,
                                            mask, return_coarse=True)
    P_r, B_r = amg_r.rigid_body_prolongator(mesh.node_coords, agg_r, n_r,
                                            mask, return_coarse=True)
    np.testing.assert_array_equal(P_p, P_r)
    np.testing.assert_array_equal(B_p, B_r)
    np.testing.assert_array_equal(P_p[:4, 1], 0.0)     # masked rows are zero
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 9, 50), rng.integers(0, 9, 50)
    for a, b in zip(amg_p._unique_pairs(rows, cols, 9),
                    amg_r._unique_pairs(rows, cols, 9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smooth", [False, True],
                         ids=["tentative", "smoothed"])
def test_setup_and_apply_equal_reference(smooth):
    """Hierarchy structure equal; setup state to rtol 1e-10; one V-cycle to
    rtol 1e-9 (of the largest entry), on a three-level hierarchy."""
    ref, state_r, z_r = _reference(smooth, 60)
    mesh, op, amg, mask, scale, f = _port(smooth_prolongator=smooth,
                                          max_coarse_dofs=60)
    assert amg.n_coarse_levels == ref.n_coarse_levels >= 2
    assert amg.sizes == ref.sizes and amg.nc == ref.nc
    assert amg.chunk_slices == ref.chunk_slices
    np.testing.assert_array_equal(amg.agg_idx.numpy(),
                                  np.asarray(ref.agg_idx))
    np.testing.assert_array_equal(amg.Pn.numpy(), np.asarray(ref.Pn))
    for l in range(amg.n_coarse_levels):
        np.testing.assert_array_equal(amg.pair_rows[l].numpy(),
                                      np.asarray(ref.pair_rows[l]))
        np.testing.assert_array_equal(amg.pair_cols[l].numpy(),
                                      np.asarray(ref.pair_cols[l]))
    for l in range(amg.n_coarse_levels - 1):
        np.testing.assert_array_equal(amg.agg_coarse[l].numpy(),
                                      np.asarray(ref.agg_coarse[l]))
        np.testing.assert_array_equal(amg.P_coarse[l].numpy(),
                                      np.asarray(ref.P_coarse[l]))
    if smooth:
        for l, terms in enumerate(amg._sa_terms):
            for a, b in zip(terms, ref._sa_terms[l]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(amg._sa_inject[l].numpy(),
                                          np.asarray(ref._sa_inject[l]))
    else:
        np.testing.assert_array_equal(amg.elem_pair_idx.numpy(),
                                      np.asarray(ref.elem_pair_idx))
        for a, b in zip(amg.pair_maps, ref.pair_maps):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    A = lambda v: op.apply(v, scale, mask)
    Binv = op.block_diagonal_inverse(scale, mask)
    state = amg.setup(scale, mask, Binv, A)
    assert sorted(state) == sorted(state_r)
    for got, want in zip(state["blocks"], state_r["blocks"]):
        _close(got, want, 1e-10, atol=1e-12 * float(got.abs().max()))
    for got, want in zip(state["Binvs"], state_r["Binvs"]):
        _close(got, want, 1e-10, atol=1e-10 * float(got.abs().max()))
    _close(state["Binv0"], state_r["Binv0"], 1e-10,
           atol=1e-10 * float(state["Binv0"].abs().max()))
    _close(state["L"][0], state_r["L"][0], 1e-10, atol=1e-10)
    _close(state["L"][1], state_r["L"][1], 1e-10)
    if smooth:
        for got, want in zip(state["Ps"], state_r["Ps"]):
            _close(got, want, 1e-10, atol=1e-10)
    z = amg.apply(f, A, Binv, state, mask)
    _close(z, z_r, 1e-9, atol=1e-9 * float(np.abs(z_r).max()))
    assert torch.equal(z, amg.apply(f, A, Binv, state, mask))


def test_restrict_is_the_transpose_of_prolong():
    mesh, op, amg, mask, scale, f = _port()
    rng = np.random.default_rng(3)
    zc = _t(rng.normal(size=6 * amg.sizes[0]))
    lhs = torch.dot(amg.prolong(zc), f)
    rhs = torch.dot(zc, amg.restrict(f))
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-12)


def test_chunked_assembly_matches_unchunked():
    """Forcing many element chunks reproduces the one-shot assembly."""
    mesh, op, amg, mask, scale, f = _port((4, 2, 2))
    one = amg._assemble_level1(scale)
    E = mesh.n_cells
    amg.chunk_slices = [(s, min(s + 7, E)) for s in range(0, E, 7)]
    _close(amg._assemble_level1(scale), one, 1e-12, atol=1e-12)
    sa = _port((4, 2, 2), smooth_prolongator=True)[2]
    one = sa._assemble_node_blocks(scale, mask)
    sa.chunk_slices = amg.chunk_slices
    _close(sa._assemble_node_blocks(scale, mask), one, 1e-12, atol=1e-12)


@pytest.mark.parametrize("smooth", [False, True],
                         ids=["tentative", "smoothed"])
def test_vcycle_is_spd_and_beats_block_jacobi(smooth):
    """CG with the AMG cycle converges in far fewer iterations than block
    Jacobi on a SIMP-contrast operator, to the same solution; the cycle is
    symmetric."""
    mesh, op, amg, mask, scale, f = _port(smooth_prolongator=smooth)
    A = lambda v: op.apply(v, scale, mask)
    Binv = op.block_diagonal_inverse(scale, mask)
    sol_bj = cg_solve(A, f, M=lambda r: op.apply_block_jacobi(Binv, r),
                      rtol=1e-10, maxiter=2000)
    state = amg.setup(scale, mask, Binv, A)
    M = lambda r: amg.apply(r, A, Binv, state, mask)
    sol_amg = cg_solve(A, f, M=M, rtol=1e-10, maxiter=2000)
    _close(sol_amg.u, sol_bj.u, 1e-6, atol=1e-8)
    assert sol_amg.iterations < sol_bj.iterations / 2, (
        sol_amg.iterations, sol_bj.iterations)
    g = _t(np.random.default_rng(5).normal(size=mesh.n_dofs)) * mask
    assert float(torch.dot(g, M(f))) == pytest.approx(
        float(torch.dot(f, M(g))), rel=1e-9)
    assert float(torch.dot(f, M(f))) > 0


def test_iteration_counts_equal_reference():
    """The same AMG-CG solve takes the JAX package's iteration count."""
    from easysimp_tpu.ops.cg import cg_solve as cg_r

    mesh, ke, mask_np, rho, f_np, kw = _inputs()
    mesh_j = _tets(et, NELS)
    op_r = OperatorR(ke, mesh_j.connectivity, mesh_j.n_nodes, **kw,
                     dtype=jnp.float64)
    amg_j = amg_r.MultilevelAMG(op_r, mesh_j, mask_np)
    mask_j, scale_j = jnp.asarray(mask_np), op_r.youngs_modulus(
        jnp.asarray(rho))
    A_r = lambda v: op_r.apply(v, scale_j, mask_j)
    Binv_r = op_r.block_diagonal_inverse(scale_j, mask_j)
    st_r = amg_j.setup(scale_j, mask_j, Binv_r, A_r)
    sol_r = cg_r(A_r, jnp.asarray(f_np), x0=jnp.zeros(mesh.n_dofs),
                 M=lambda r: amg_j.apply(r, A_r, Binv_r, st_r, mask_j),
                 rtol=1e-10, maxiter=2000)

    mesh, op, amg, mask, scale, f = _port()
    A = lambda v: op.apply(v, scale, mask)
    Binv = op.block_diagonal_inverse(scale, mask)
    state = amg.setup(scale, mask, Binv, A)
    sol = cg_solve(A, f, M=lambda r: amg.apply(r, A, Binv, state, mask),
                   rtol=1e-10, maxiter=2000)
    assert sol.iterations == int(sol_r.iterations)
    _close(sol.u, sol_r.u, 1e-7, atol=1e-9)


def test_deep_hierarchy_matches_twolevel_solution():
    mesh, op, two, mask, scale, f = _port((8, 4, 4))
    assert two.n_coarse_levels == 1
    deep = amg_p.MultilevelAMG(op, mesh, mask.numpy(), max_coarse_dofs=60)
    assert deep.n_coarse_levels >= 2
    assert set(deep.build_seconds) == {"aggregation", "prolongator",
                                       "structure"}
    A = lambda v: op.apply(v, scale, mask)
    sols = []
    for amg in (two, deep):
        state = amg.setup(scale, mask)
        sols.append(cg_solve(
            A, f, M=lambda r: amg.apply(r, A, None, state, mask),
            rtol=1e-10, maxiter=2000))
    _close(sols[1].u, sols[0].u, 1e-6, atol=1e-8)
    assert sols[1].iterations < 3 * sols[0].iterations


@pytest.mark.parametrize("smooth", [False, True],
                         ids=["tentative", "smoothed"])
def test_float32_at_1e9_contrast_stays_finite(smooth):
    """The whole setup and cycle in float32 (TF32 off) at E_max/E_min = 1e9:
    finite, and CG converges to 1e-5."""
    mesh, op, amg, mask, scale, f = _port(dtype=torch.float32,
                                          smooth_prolongator=smooth,
                                          max_coarse_dofs=60)
    A = lambda v: op.apply(v, scale, mask)
    state = amg.setup(scale, mask)
    assert state["L"][0].dtype == torch.float32
    for t in (*state["blocks"], *state["Binvs"], state["Binv0"],
              *state["L"]):
        assert bool(torch.isfinite(t).all())
    sol = cg_solve(A, f, M=lambda r: amg.apply(r, A, None, state, mask),
                   rtol=1e-5, maxiter=500)
    assert bool(torch.isfinite(sol.u).all())
    assert sol.iterations < 500


def test_sa_term_budget_is_enforced(monkeypatch):
    monkeypatch.setenv("EASYSIMP_SA_TERM_BUDGET", "10")
    with pytest.raises(ValueError, match="term list needs"):
        _port((4, 2, 2), smooth_prolongator=True)
