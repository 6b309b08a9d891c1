"""The port's VoxelOperator and the plain versions of its two kernels,
against the JAX package.

The CUDA kernels themselves cannot run on the CPU; `chip_smoke.py` holds
them against these plain versions on the card.  Here the plain versions are
held against the reference XLA path and against the Pallas kernels in
interpret mode, on the shapes and blocks of tests/test_pallas.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu.ops.pallas_kernels import (
    make_pallas_energies,
    make_pallas_matvec,
)
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.ops import cuda_kernels as ck


def _problem(nels, extents, seed, E0=3.0, fix_x0=True):
    rng = np.random.default_rng(seed)
    grid_r = et.generate_grid(nels, (0.0, 0.0, 0.0), extents)
    grid_p = pt.generate_grid(nels, (0.0, 0.0, 0.0), extents)
    op_r = et.VoxelOperator(grid_r, E0=E0, Emin=1e-9, nu=0.3, p=3.0,
                            dtype=jnp.float64)
    op_p = pt.VoxelOperator(grid_p, E0=E0, Emin=1e-9, nu=0.3, p=3.0,
                            dtype=torch.float64, device="cpu")
    u = rng.standard_normal((*grid_r.nnodes_per_axis, 3))
    rho = rng.uniform(0.05, 1.0, grid_r.nels)
    bcs = [et.apply_fixed_boundary(grid_r, et.select_nodes_by_plane(
        grid_r, [0, 0, 0], [1, 0, 0], 1e-9))] if fix_x0 else []
    mask = et.build_free_mask(grid_r, bcs)
    return op_r, op_p, u, rho, mask


_METHODS = ["apply_K", "apply", "diagonal", "row_abs_sums",
            "element_energies_unit", "compliance_sensitivities"]


@pytest.mark.parametrize("method", _METHODS)
def test_operator_matches_reference(method):
    """fp64: 1e-12 (element energies and sensitivities 1e-11)."""
    op_r, op_p, u, rho, mask = _problem((7, 5, 4), (1.4, 0.6, 0.5), seed=1)
    s_r = op_r.youngs_modulus(jnp.asarray(rho))
    s_p = op_p.youngs_modulus(torch.tensor(rho))
    args = {
        "apply_K": ((u, s_r), (u, s_p)),
        "apply": ((u, s_r, mask), (u, s_p, mask)),
        "diagonal": ((s_r, mask), (s_p, mask)),
        "row_abs_sums": ((s_r, mask), (s_p, mask)),
        "element_energies_unit": ((u,), (u,)),
        "compliance_sensitivities": ((u, rho), (u, rho)),
    }[method]
    to_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    to_t = lambda a: torch.tensor(a) if isinstance(a, np.ndarray) else a
    want = np.asarray(getattr(op_r, method)(*map(to_j, args[0])))
    got = getattr(op_p, method)(*map(to_t, args[1])).numpy()
    tol = 1e-11 if method in ("element_energies_unit",
                              "compliance_sensitivities") else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_apply_elements_matches_reference():
    """Element dofs and element products q_e = ke u_e, fp64 (1e-12)."""
    op_r, op_p, u, _, _ = _problem((5, 4, 3), (1.0, 0.8, 0.6), seed=2)
    ue_r, q_r = op_r.apply_elements(jnp.asarray(u))
    ue_p, q_p = op_p.apply_elements(torch.tensor(u))
    np.testing.assert_array_equal(ue_p.numpy(), np.asarray(ue_r))
    np.testing.assert_allclose(q_p.numpy(), np.asarray(q_r), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("nels,block", [
    ((16, 8, 4), 8),
    ((8, 16, 8), 4),
    ((8, 16, 4), (4, 8)),
    ((8, 24, 4), (2, 8)),
])
def test_plain_matvec_matches_pallas_interpret(nels, block):
    """The kernel's plain version against the Pallas matvec (interpret
    mode), fp64: 1e-12."""
    op_r, op_p, u, rho, _ = _problem(nels, (1.6, 1.1, 0.9), seed=0)
    scale = op_r.youngs_modulus(jnp.asarray(rho))
    want = np.asarray(make_pallas_matvec(op_r, block=block, interpret=True)(
        jnp.asarray(u), scale))
    got = ck.voxel_matvec_plain(torch.tensor(u),
                                torch.tensor(np.asarray(scale)),
                                op_p.ke).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nels,block", [
    ((16, 8, 4), (8, 8)),
    ((8, 16, 4), (4, 8)),
])
def test_plain_energies_match_pallas_interpret(nels, block):
    """The kernel's plain version against the Pallas energies (interpret
    mode), fp64: 1e-11."""
    op_r, op_p, u, _, _ = _problem(nels, (1.3, 0.9, 1.1), seed=3)
    want = np.asarray(make_pallas_energies(op_r, block=block,
                                           interpret=True)(jnp.asarray(u)))
    got = ck.voxel_energies_plain(torch.tensor(u), op_p.ke).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


def test_plain_matvec_bfloat16_storage():
    """bf16 storage, fp32 compute, against the Pallas bf16 matvec
    (interpret mode) and the fp64 operator: 5% of max|out| (bf16 rounding
    of inputs and outputs)."""
    nels = (16, 8, 4)
    grid_r = et.generate_grid(nels, (0.0, 0.0, 0.0), (1.6, 1.1, 0.9))
    grid_p = pt.generate_grid(nels, (0.0, 0.0, 0.0), (1.6, 1.1, 0.9))
    op16 = et.VoxelOperator(grid_r, dtype=jnp.bfloat16)
    op64 = et.VoxelOperator(grid_r, dtype=jnp.float64)
    port16 = pt.VoxelOperator(grid_p, dtype=torch.bfloat16, device="cpu")
    assert port16.ke.dtype == torch.float32
    rng = np.random.default_rng(11)
    u = rng.standard_normal((*grid_r.nnodes_per_axis, 3))
    rho = rng.uniform(0.05, 1.0, grid_r.nels)
    scale64 = np.asarray(op64.youngs_modulus(jnp.asarray(rho)))
    pallas = np.asarray(make_pallas_matvec(op16, block=8, interpret=True)(
        jnp.asarray(u, jnp.bfloat16), jnp.asarray(scale64, jnp.bfloat16)),
        dtype=np.float64)
    want = np.asarray(op64.apply_K(jnp.asarray(u), jnp.asarray(scale64)))
    got_t = port16.apply_K(torch.tensor(u, dtype=torch.bfloat16),
                           torch.tensor(scale64, dtype=torch.bfloat16))
    assert got_t.dtype == torch.bfloat16
    got = got_t.double().numpy()
    ref_scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=0.05 * ref_scale, rtol=0.05)
    np.testing.assert_allclose(got, pallas, atol=0.05 * ref_scale, rtol=0.05)


def test_wrappers_refuse_other_devices_and_missing_nvcc(monkeypatch,
                                                        tmp_path):
    """No fallback: a tensor on a device that is neither the CPU nor CUDA
    raises, and a build without nvcc raises."""
    u = torch.empty((3, 3, 3, 3), device="meta")
    with pytest.raises(ValueError):
        ck.voxel_matvec(u, torch.empty((2, 2, 2), device="meta"),
                        torch.empty((24, 24), device="meta"))
    with pytest.raises(ValueError):
        ck.voxel_energies(u, torch.empty((24, 24), device="meta"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ck, "_libs", {})
    for build in (ck.build_kernels, ck.build_element_kernels,
                  ck.build_stencil_kernels):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build()
