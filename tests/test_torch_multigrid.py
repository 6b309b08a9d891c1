"""The port's geometric multigrid against the JAX package's, on the CPU: the
same numpy inputs through easysimp_tpu.ops.multigrid and
easysimp_tpu_torch.ops.multigrid.

float64 throughout, except the narrow-cycle cases.  The hierarchy, the
transfers, the hash start vectors and the setup state agree to 1e-12 (the
start vectors bitwise); M(r) agrees to 1e-12 on a mild field (rho uniform
in [0.3, 1]) and to 1e-9 on the 0.02/1.0 contrast field of
tests/test_multigrid.py, whose 1.6e5 modulus contrast amplifies the
last-bit differences of summation order (dot products, the dense Cholesky)
through the power iteration and the coarse solve.

The hierarchy, the setup state, M(r) and the MG-CG count are checked under
two kinds of supports: an x=0 face clamped in every component, and the
MBB beam's sliding supports (`models/beam_2x1x1.py` `build_mbb`: u_x on
the plane x=0, u_y on a strip of the far bottom edge, u_z at one pin),
whose per-component masks are injected through the coarse levels and hold
the z translation by one dof.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu.models import beam_2x1x1 as beam_r
from easysimp_tpu.ops import multigrid as jm
from easysimp_tpu_torch.carry import power_vectors_from_numpy
from easysimp_tpu_torch.ops import multigrid as tm
from easysimp_tpu_torch.ops.cg import cg_solve
from easysimp_tpu_torch.ops.stencil import apply_stencil

_JD = {"float64": jnp.float64, "float32": jnp.float32}
_TD = {"float64": torch.float64, "float32": torch.float32}


def with_supports(cases):
    """Each (values, id) case under both kinds of supports: the clamped
    face keeps the case's id, the MBB's sliding supports add "-mbb"."""
    return ([pytest.param(*values, "clamped", id=i) for values, i in cases]
            + [pytest.param(*values, "mbb", id=f"{i}-mbb")
               for values, i in cases])


def _free_mask(grid, nels, supports):
    """The free mask of the x=0 face clamped, or of `build_mbb`'s sliding
    supports on a grid of the same cell counts (numpy)."""
    if supports == "clamped":
        bc = et.apply_fixed_boundary(
            grid, et.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
        return et.build_free_mask(grid, [bc])
    beam, _, bcs, _, _ = beam_r.build_mbb(nels=nels)
    return et.build_free_mask(beam, bcs)


def _pair(nels=(16, 8, 8), dtype="float64", contrast=False, seed=5,
          supports="clamped"):
    """Operators of both packages on the grid of unit cubes, its free mask
    under `supports`, both packages' moduli of one design and a masked
    residual (numpy)."""
    ext = tuple(float(n) for n in nels)
    grid_r = et.generate_grid(nels, (0.0, 0.0, 0.0), ext)
    grid_p = pt.generate_grid(nels, (0.0, 0.0, 0.0), ext)
    op_r = et.VoxelOperator(grid_r, E0=200.0, Emin=1e-6, nu=0.3, p=3.0,
                            dtype=_JD[dtype])
    op_p = pt.VoxelOperator(grid_p, E0=200.0, Emin=1e-6, nu=0.3, p=3.0,
                            dtype=_TD[dtype], device="cpu")
    mask = _free_mask(grid_r, nels, supports)
    rng = np.random.default_rng(seed)
    if contrast:
        rho = rng.choice([0.02, 1.0], size=grid_r.nels, p=[0.5, 0.5])
    else:
        rho = rng.uniform(0.3, 1.0, grid_r.nels)
    r = rng.standard_normal((*grid_r.nnodes_per_axis, 3)) * mask
    return (op_r, op_p, op_r.youngs_modulus(jnp.asarray(rho, _JD[dtype])),
            op_p.youngs_modulus(torch.tensor(rho, dtype=_TD[dtype])), mask, r)


def _mgs(op_r, op_p, **kw):
    return (jm.MultigridPreconditioner(op_r, **kw),
            tm.MultigridPreconditioner(op_p, **kw))


def _close(got, want, rtol=1e-12):
    got = got.double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture
def three_levels(monkeypatch):
    """Coarsen 16x8x8 to three levels, as tests/test_multigrid.py:350."""
    monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", "500")


# --------------------------------------------------------------------------
# Transfers and field coarsening
# --------------------------------------------------------------------------

def test_prolong_restrict_match_reference_and_are_adjoint():
    rng = np.random.default_rng(0)
    xc = rng.standard_normal((4, 3, 5, 3))
    xf = rng.standard_normal((7, 5, 9, 3))
    _close(tm.prolong(torch.tensor(xc)), jm.prolong(jnp.asarray(xc)), 1e-15)
    _close(tm.restrict(torch.tensor(xf)), jm.restrict(jnp.asarray(xf)),
           1e-15)
    lhs = float(torch.sum(tm.prolong(torch.tensor(xc)) * torch.tensor(xf)))
    rhs = float(torch.sum(torch.tensor(xc) * tm.restrict(torch.tensor(xf))))
    assert np.isclose(lhs, rhs, rtol=1e-13)


@pytest.mark.parametrize("rule", ["arithmetic", "harmonic", "mixed"])
def test_coarsen_cells_matches_reference(rule):
    s = np.random.default_rng(2).uniform(0.01, 1.0, size=(4, 6, 2))
    _close(tm.coarsen_cells(torch.tensor(s), rule),
           jm.coarsen_cells(jnp.asarray(s), rule), 1e-15)


def test_coarsen_mask_and_unknown_rule():
    m = np.random.default_rng(3).integers(0, 2, (9, 5, 7, 3)).astype(float)
    _close(tm.coarsen_mask(torch.tensor(m)), jm.coarsen_mask(jnp.asarray(m)))
    with pytest.raises(ValueError):
        tm.coarsen_cells(torch.ones((2, 2, 2)), "geometric")


@pytest.mark.parametrize("nels,env,levels,supports", with_supports(
    [(c, f"nels{k}-{c[1]}-{c[2]}") for k, c in enumerate([
        ((16, 8, 8), "4100", 0), ((16, 8, 8), "500", 0),
        ((24, 12, 12), None, 0), ((10, 6, 4), None, 0), ((5, 3, 3), None, 0),
        ((32, 16, 16), "100", 2)])]))
def test_hierarchy_matches_reference(monkeypatch, nels, env, levels,
                                     supports):
    """Level count and grids, EASYSIMP_MAX_COARSE_DOFS and mg_levels read
    the same way; Galerkin weights of the direct levels equal."""
    if env is not None:
        monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", env)
    op_r, op_p, *_ = _pair(nels, supports=supports)
    mg_r, mg_p = _mgs(op_r, op_p, levels=levels)
    assert mg_p.n_levels == mg_r.n_levels
    assert [o.grid.nels for o in mg_p.ops] == [o.grid.nels for o in mg_r.ops]
    gs_r = getattr(mg_r, "_Gs", {})   # only set where the reference has levels
    assert sorted(mg_p._Gs) == sorted(gs_r)
    for lvl, G in gs_r.items():
        np.testing.assert_allclose(mg_p._Gs[lvl], G, rtol=1e-15, atol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hash_vectors_bitwise(three_levels, dtype):
    op_r, op_p, *_ = _pair(dtype=dtype)
    mg_r, mg_p = _mgs(op_r, op_p)
    for a, b in zip(mg_p.init_power_vectors(), mg_r.init_power_vectors()):
        assert a.dtype == _TD[dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# Setup state
# --------------------------------------------------------------------------

def _coarse_solve(mg, state, x, jax_state=None):
    if jax_state is None:
        return mg._cholesky_solve(state["cho"], torch.tensor(x))
    (cho, dinv) = jax_state["cho"]
    return dinv * jax.scipy.linalg.cho_solve(cho, dinv * jnp.asarray(x))


@pytest.mark.parametrize("galerkin,warm,power_iters,supports", with_supports(
    [(c, "-".join(map(str, c))) for c in [
        (True, False, 10), (True, True, 10), (False, False, 10),
        (False, True, 10), (True, False, 0)]]))
def test_setup_state_matches_reference(three_levels, galerkin, warm,
                                       power_iters, supports):
    """diags, lams, omegas, Chebyshev-free state, stencils, power vectors
    and the coarsest factor's solve: 1e-12.  warm: both setups start from
    the JAX package's cold power vectors, carried into the port with
    power_vectors_from_numpy (power_init itself agrees too)."""
    op_r, op_p, s_r, s_p, mask, _ = _pair(contrast=True, supports=supports)
    mg_r, mg_p = _mgs(op_r, op_p, galerkin=galerkin, smooth_iters=(1, 2),
                      power_iters=power_iters)
    assert mg_p.n_levels == 3
    m_r, m_p = jnp.asarray(mask), torch.tensor(mask)
    pv_r = pv_p = None
    if warm:
        pv_r = mg_r.power_init(s_r, m_r)
        pv_p = power_vectors_from_numpy([np.asarray(v) for v in pv_r],
                                        dtype="float64", device="cpu")
        for a, b in zip(mg_p.power_init(s_p, m_p), pv_r):
            _close(a, b)
    st_r, vec_r = mg_r.setup(s_r, m_r, pv_r)
    st_p, vec_p = mg_p.setup(s_p, m_p, pv_p)
    for key in ("scales", "masks", "diags", "lams", "omegas"):
        for lvl in range(mg_p.n_levels):
            _close(st_p[key][lvl], st_r[key][lvl])
    for a, b in zip(st_p["stencils"], st_r["stencils"]):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b)
    for a, b in zip(vec_p, vec_r):
        _close(a, b)
    x = np.random.default_rng(9).standard_normal(mg_p._coarse_ndofs)
    _close(_coarse_solve(mg_p, st_p, x), _coarse_solve(mg_r, None, x, st_r))


def test_power_vectors_from_numpy_checks_shapes():
    with pytest.raises(ValueError):
        power_vectors_from_numpy([np.zeros((3, 3, 3))], dtype="float64",
                                 device="cpu")


# --------------------------------------------------------------------------
# The preconditioner
# --------------------------------------------------------------------------

@pytest.mark.parametrize(
    "galerkin,smoother,cycle,contrast,supports", with_supports(
        [((g, sm, cy, co), f"{gi}-{sm}-{cy}-{ci}")
         for g, gi in ((True, "galerkin"), (False, "rediscretized"))
         for sm in ("chebyshev", "jacobi") for cy in ("v", "w")
         for co, ci in ((False, "mild"), (True, "contrast"))]))
def test_M_matches_reference(three_levels, contrast, cycle, smoother,
                             galerkin, supports):
    """M(r) from a cold setup, three levels: 1e-12 on the mild field, 1e-9
    at contrast (module docstring)."""
    op_r, op_p, s_r, s_p, mask, r = _pair(contrast=contrast,
                                          supports=supports)
    mg_r, mg_p = _mgs(op_r, op_p, smooth_iters=(1, 2), cycle=cycle,
                      smoother=smoother, galerkin=galerkin)
    assert mg_p.n_levels == 3
    want = mg_r.preconditioner_factory()(s_r, jnp.asarray(mask))(
        jnp.asarray(r))
    got = mg_p.preconditioner_factory()(s_p, torch.tensor(mask))(
        torch.tensor(r))
    _close(got, want, 1e-9 if contrast else 1e-12)


@pytest.mark.parametrize("narrow", ["cycle", "stencil"])
def test_narrow_M_matches_reference(narrow):
    """float32 operator with a bfloat16 cycle interior, or bfloat16 stencil
    storage: M(r) within 1e-2 of max|M r| of the JAX package's.  Both
    round to bfloat16 (8 bits, an ulp of 2^-8 = 3.9e-3) at each cycle op,
    in places that differ (XLA may keep excess precision inside a fusion;
    the port's bfloat16 matvec computes in float32 and rounds once), so the
    two cycles differ by up to a few bfloat16 ulps of the output."""
    op_r, op_p, s_r, s_p, mask, r = _pair(dtype="float32", contrast=True)
    kw = ({"cycle_dtype": "bf16"} if narrow == "cycle"
          else {"stencil_dtype": "bf16"})
    mg_r = jm.MultigridPreconditioner(
        op_r, smooth_iters=(1, 2),
        **{k: jnp.bfloat16 for k in kw})
    mg_p = tm.MultigridPreconditioner(
        op_p, smooth_iters=(1, 2), **{k: torch.bfloat16 for k in kw})
    m32 = mask.astype(np.float32)
    want = mg_r.preconditioner_factory()(s_r, jnp.asarray(m32))(
        jnp.asarray(r, jnp.float32))
    got = mg_p.preconditioner_factory()(s_p, torch.tensor(m32))(
        torch.tensor(r, dtype=torch.float32))
    assert got.dtype == torch.float32
    _close(got, want, 1e-2)


class _FormerApplies(tm.MultigridPreconditioner):
    """The cycle's stencil applies as they were composed before
    `stencil_apply`: mask, unfold x C -> sum, mask, and the caller's
    r - (...)."""

    def _stencil_apply(self, stencil, mask, v, r=None):
        if stencil.dtype != v.dtype:
            mv = (mask * v).to(stencil.dtype)
            y = mask * apply_stencil(stencil, mv).to(v.dtype)
        else:
            y = mask * apply_stencil(stencil, mask * v)
        return y if r is None else r - y


@pytest.mark.parametrize("smoother,cycle,dtype,narrow", [
    ("chebyshev", "v", "float64", None), ("jacobi", "v", "float64", None),
    ("chebyshev", "w", "float64", None),
    ("chebyshev", "v", "float32", "cycle_dtype"),
    ("chebyshev", "v", "float32", "stencil_dtype")])
def test_stencil_apply_keeps_the_cycle_bitwise(three_levels, smoother, cycle,
                                               dtype, narrow):
    """On the CPU, setup (power iterations through the level-1 apply) and
    one M(r) with every stencil apply and residual through `stencil_apply`
    are bitwise those of the former composition, under the MBB's sliding
    supports; bfloat16 cycle and stencil storage included."""
    _, op_p, _, s_p, mask, r = _pair(dtype=dtype, supports="mbb")
    kw = dict(smooth_iters=(1, 2), smoother=smoother, cycle=cycle)
    if narrow:
        kw[narrow] = torch.bfloat16
    m, rt = torch.tensor(mask, dtype=_TD[dtype]), torch.tensor(
        r, dtype=_TD[dtype])
    new, old = (cls(op_p, **kw) for cls in (tm.MultigridPreconditioner,
                                            _FormerApplies))
    assert new.n_levels == 3
    (st_new, pv_new), (st_old, pv_old) = (mg.setup(s_p, m)
                                          for mg in (new, old))
    assert all(torch.equal(a, b) for a, b in zip(pv_new, pv_old))
    assert all(torch.equal(a, b) for a, b in zip(st_new["lams"],
                                                 st_old["lams"]))
    assert torch.equal(new.make_M(st_new)(rt), old.make_M(st_old)(rt))


def test_M_is_linear_and_symmetric():
    """The cycle is a fixed symmetric linear operator (a valid CG
    preconditioner), as tests/test_multigrid.py:103 holds the reference."""
    _, op_p, _, s_p, mask, _ = _pair((8, 4, 4), contrast=True)
    mg = tm.MultigridPreconditioner(op_p, smooth_iters=2)
    M = mg.preconditioner_factory()(s_p, torch.tensor(mask))
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal(mask.shape) * mask)
    y = torch.tensor(rng.standard_normal(mask.shape) * mask)
    _close(M(2.5 * x - 1.5 * y), 2.5 * M(x) - 1.5 * M(y), 1e-10)
    assert np.isclose(float(torch.sum(M(x) * y)), float(torch.sum(x * M(y))),
                      rtol=1e-10)


def test_mg_cg_matches_reference_count():
    """CG with the port's multigrid takes the JAX package's iteration count
    on the contrast problem, and far fewer than Jacobi."""
    _mg_cg_matches_reference_count("clamped")


def test_mg_cg_matches_reference_count_mbb():
    """The same under the MBB beam's sliding supports."""
    _mg_cg_matches_reference_count("mbb")


def _mg_cg_matches_reference_count(supports):
    from easysimp_tpu.ops.cg import cg_solve as cg_ref

    op_r, op_p, s_r, s_p, mask, r = _pair(contrast=True, supports=supports)
    mg_r, mg_p = _mgs(op_r, op_p, smooth_iters=2)
    m_r, m_p = jnp.asarray(mask), torch.tensor(mask)
    ref = cg_ref(lambda v: op_r.apply(v, s_r, m_r), jnp.asarray(r),
                 M=mg_r.preconditioner_factory()(s_r, m_r), rtol=1e-10,
                 maxiter=500)
    got = cg_solve(lambda v: op_p.apply(v, s_p, m_p), torch.tensor(r),
                   M=mg_p.preconditioner_factory()(s_p, m_p), rtol=1e-10,
                   maxiter=500)
    assert got.iterations == int(ref.iterations)
    _close(got.u, ref.u, 1e-9)
    diag = op_p.diagonal(s_p, m_p)
    jac = cg_solve(lambda v: op_p.apply(v, s_p, m_p), torch.tensor(r),
                   M=lambda v: v / diag, rtol=1e-10, maxiter=5000)
    assert got.iterations < jac.iterations / 3


def test_setup_light_reuses_deep_and_refreshes_fine(three_levels):
    """The checks of tests/test_multigrid.py:340-397 on the port: after a
    full setup on design A, setup_light on design B refreshes levels 0-1
    exactly as a full warm setup on B does, keeps the deeper levels and
    the coarsest factor of A's state, returns the same keys; and its state
    equals the JAX package's setup_light state."""
    grid = pt.generate_grid((16, 8, 8), (0.0, 0.0, 0.0), (16.0, 8.0, 8.0))
    op = pt.VoxelOperator(grid, E0=100.0, Emin=1e-6, nu=0.3, p=3.0,
                          dtype=torch.float64, device="cpu")
    mg = tm.MultigridPreconditioner(op, smooth_iters=(1, 2))
    assert mg.n_levels >= 3 and mg.supports_light_setup
    rng = np.random.default_rng(3)
    dA = rng.uniform(0.2, 1.0, grid.nels)
    dB = np.clip(dA + rng.uniform(-0.2, 0.2, grid.nels), 0.05, 1.0)
    mask = np.ones((*grid.nnodes_per_axis, 3))
    mask[0] = 0.0
    m = torch.tensor(mask)
    sA = op.youngs_modulus(torch.tensor(dA))
    sB = op.youngs_modulus(torch.tensor(dB))

    pv0 = mg.power_init(sA, m)
    stA, vecsA = mg.setup(sA, m, pv0)
    stL, vecsL = mg.setup_light(sB, m, vecsA, stA)
    stF, vecsF = mg.setup(sB, m, vecsA)
    assert stL.keys() == stF.keys()
    for key in ("diags", "lams", "omegas"):
        for lvl in (0, 1):
            _close(stL[key][lvl], stF[key][lvl])
    _close(stL["stencils"][1], stF["stencils"][1])
    for lvl in (0, 1):
        _close(vecsL[lvl], vecsF[lvl])
        _close(stL["cheb"][lvl][0], stF["cheb"][lvl][0])
    for lvl in range(2, mg.n_levels):
        assert torch.equal(stL["stencils"][lvl], stA["stencils"][lvl])
        assert torch.equal(stL["lams"][lvl], stA["lams"][lvl])
        assert torch.equal(vecsL[lvl], vecsA[lvl])
    assert torch.equal(stL["cho"][0], stA["cho"][0])

    # against the JAX package's setup_light, from the same carried state
    op_r = et.VoxelOperator(
        et.generate_grid((16, 8, 8), (0.0, 0.0, 0.0), (16.0, 8.0, 8.0)),
        E0=100.0, Emin=1e-6, nu=0.3, p=3.0, dtype=jnp.float64)
    mg_r = jm.MultigridPreconditioner(op_r, smooth_iters=(1, 2))
    m_r = jnp.asarray(mask)
    stA_r, vecsA_r = mg_r.setup(op_r.youngs_modulus(jnp.asarray(dA)), m_r,
                                tuple(jnp.asarray(v.numpy()) for v in pv0))
    stL_r, vecsL_r = mg_r.setup_light(op_r.youngs_modulus(jnp.asarray(dB)),
                                      m_r, vecsA_r, stA_r)
    for key in ("diags", "lams", "omegas"):
        for lvl in range(mg.n_levels):
            _close(stL[key][lvl], stL_r[key][lvl])
    for a, b in zip(vecsL, vecsL_r):
        _close(a, b)
    r = torch.tensor(rng.standard_normal(mask.shape) * mask)
    _close(mg.make_M(stL)(r), mg_r._make_M(stL_r)(jnp.asarray(r.numpy())))


def test_w_cycle_refuses_a_narrow_cycle():
    """The W-cycle stays float32-only: with a bfloat16 interior the
    reference's diverges (CG at maxiter every iteration)."""
    _, op_p, *_ = _pair((8, 4, 4))
    with pytest.raises(ValueError, match="W-cycle"):
        tm.MultigridPreconditioner(op_p, cycle="w",
                                   cycle_dtype=torch.bfloat16)
    tm.MultigridPreconditioner(op_p, cycle="w", cycle_dtype=torch.float32)
