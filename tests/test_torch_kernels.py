"""The arithmetic of the float32 / bfloat16 CUDA kernels, and the port's
default device.

The kernels run only on the card (`chip_smoke.py` holds them against their
plain versions there).  Here their arithmetic is emulated in PyTorch with
`tf32_round`: the element product q_e = ke u_e in 3xTF32 (both operands
split into a TF32 high part and a TF32 remainder, three products summed in
float32), held against the JAX package's float64 operator.  The energies
take the element dofs less their element's mean displacement
(`centre_element_dofs`), as the kernels and the plain version do.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.carry import fields_from_numpy
from easysimp_tpu_torch.ops import cuda_kernels as ck
from easysimp_tpu_torch.ops.filters import VoxelFilter, create_filter_cache
from easysimp_tpu_torch.opt.optimize import build_voxel_step


def test_tf32_round_ties_away_and_keeps_bfloat16_exact():
    """Round to nearest with ties away from zero, 10 mantissa bits, as
    cvt.rna.tf32.f32; bfloat16 values (8 bits) pass unchanged."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 3 * ulp / 2, 0.0, float("inf")],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0,
                         float("inf")], dtype=torch.float32)
    assert torch.equal(ck.tf32_round(x), want)
    rng = np.random.default_rng(5)
    b = torch.tensor(rng.standard_normal(1000)).to(torch.bfloat16).float()
    assert torch.equal(ck.tf32_round(b), b)
    r = ck.tf32_round(torch.tensor(rng.standard_normal(1000),
                                   dtype=torch.float32))
    assert torch.equal(ck.tf32_round(r), r)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)


def _emulated_products(ue, ke, split):
    """q = ue @ ke with TF32 operands: 3xTF32 if `split`, else one TF32
    product; float32 sums."""
    ah, bh = ck.tf32_round(ue), ck.tf32_round(ke)
    if not split:
        return ah @ bh
    al, bl = ck.tf32_round(ue - ah), ck.tf32_round(ke - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_kernels(nels, split):
    """(matvec, energies) of the float32 kernels' arithmetic and of the JAX
    float64 operator, on a small odd grid with rho in [0.05, 1]."""
    extents = (1.4, 0.6, 0.5)
    rng = np.random.default_rng(7)
    grid_r = et.generate_grid(nels, (0.0, 0.0, 0.0), extents)
    grid_p = pt.generate_grid(nels, (0.0, 0.0, 0.0), extents)
    op_r = et.VoxelOperator(grid_r, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                            dtype=jnp.float64)
    op_p = pt.VoxelOperator(grid_p, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                            dtype=torch.float32, device="cpu")
    u = rng.standard_normal((*grid_r.nnodes_per_axis, 3))
    rho = rng.uniform(0.05, 1.0, grid_r.nels)
    scale = np.asarray(op_r.youngs_modulus(jnp.asarray(rho)))
    want_mv = np.asarray(op_r.apply_K(jnp.asarray(u), jnp.asarray(scale)))
    want_en = np.asarray(op_r.element_energies_unit(jnp.asarray(u)))

    u32 = torch.tensor(u, dtype=torch.float32)
    ue = ck.gather_element_dofs(u32)
    q = _emulated_products(ue.reshape(-1, 24), op_p.ke, split)
    q = q.reshape(ue.shape)
    mv = ck.scatter_element_dofs(
        q * torch.tensor(scale, dtype=torch.float32)[..., None])
    return ((mv.double().numpy(), want_mv),
            (_emulated_energies(u32, op_p.ke, split).double().numpy(),
             want_en))


def _emulated_energies(u32, ke, split):
    """The energies kernel's arithmetic: centred element dofs, q = ke u_e
    on the tensor cores, the dot in float32."""
    ue = ck.centre_element_dofs(ck.gather_element_dofs(u32))
    q = _emulated_products(ue.reshape(-1, 24), ke, split).reshape(ue.shape)
    return (ue * q).sum(dim=-1)


@pytest.mark.parametrize("nels", [(7, 5, 4), (3, 6, 5)])
def test_3xtf32_matches_float64_operator(nels):
    """3xTF32 matvec and energies against the float64 operator: within 1e-6
    of max|out| (the dropped lo*lo term is ~2^-22 relative, float32 sums
    ~1e-7)."""
    for got, want in _emulated_kernels(nels, split=True):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_single_tf32_misses_the_float32_tolerance():
    """One TF32 product keeps ~10 mantissa bits: it misses the kernels'
    float32 tolerance of 1e-5 of max|out|, which is why they split."""
    for got, want in _emulated_kernels((7, 5, 4), split=False):
        assert np.abs(got - want).max() > 1e-5 * np.abs(want).max()


def test_centred_energies_survive_a_large_translation():
    """A displacement field that carries a translation 10^3 times its
    element-to-element variation (a deflected, simply supported beam's):
    the energies from the centred dofs, the plain version's and the
    kernel's emulated arithmetic, stay within 1e-5 of max|out| of the
    float64 energies; the uncentred float32 product loses them."""
    rng = np.random.default_rng(11)
    grid = pt.generate_grid((7, 5, 4), (0.0, 0.0, 0.0), (1.4, 1.0, 0.8))
    op64 = pt.VoxelOperator(grid, nu=0.3, dtype=torch.float64, device="cpu")
    op32 = pt.VoxelOperator(grid, nu=0.3, dtype=torch.float32, device="cpu")
    u = torch.tensor(rng.standard_normal((*grid.nnodes_per_axis, 3)))
    u += torch.tensor([1e3, -3e3, 2e3], dtype=torch.float64)
    u32 = u.float()
    want = op64.element_energies_unit(u32.double())
    ref = float(want.abs().max())
    plain = ck.voxel_energies_plain(u32, op32.ke).double()
    emulated = _emulated_energies(u32, op32.ke, split=True).double()
    ue = ck.gather_element_dofs(u32).reshape(-1, 24)
    uncentred = (ue * (ue @ op32.ke)).sum(dim=-1).reshape(want.shape)
    assert float((plain - want).abs().max()) <= 1e-5 * ref
    assert float((emulated - want).abs().max()) <= 1e-5 * ref
    assert float((uncentred.double() - want).abs().max()) > 1e-2 * ref


def _small_problem():
    grid = pt.generate_grid((4, 2, 2))
    bc = pt.apply_fixed_boundary(
        grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-3))
    load = pt.PointLoad(pt.select_nodes_by_box(grid, [4, 0, 0], [4, 0, 2]),
                        [0.0, -1.0, 0.0])
    params = pt.OptimizationParameters(
        volume_fraction=0.4, max_iterations=1, filter_radius=1.5,
        dtype="float32", preconditioner="jacobi")
    return grid, [load], [bc], params


def _entry_points():
    grid, loads, bcs, params = _small_problem()
    design = np.full(grid.nels, 0.4)
    u = np.zeros((*grid.nnodes_per_axis, 3))
    return {
        "simp_optimize": (pt.simp_optimize,
                          lambda: pt.simp_optimize(grid, loads, bcs, params)),
        "build_voxel_step": (build_voxel_step,
                             lambda: build_voxel_step(grid, loads, bcs,
                                                      params).u0),
        "VoxelOperator": (pt.VoxelOperator,
                          lambda: pt.VoxelOperator(grid).ke),
        "VoxelFilter": (VoxelFilter,
                        lambda: VoxelFilter(grid, 1.5).weight_sum),
        "create_filter_cache": (create_filter_cache,
                                lambda: create_filter_cache(
                                    grid, 1.5).weight_sum),
        "fields_from_numpy": (fields_from_numpy,
                              lambda: fields_from_numpy(
                                  design, u, dtype="float32")[1]),
    }


@pytest.mark.parametrize("name", ["simp_optimize", "build_voxel_step",
                                  "VoxelOperator", "VoxelFilter",
                                  "create_filter_cache", "fields_from_numpy"])
def test_entry_points_default_to_cuda(name):
    """Every entry point defaults to device="cuda".  Without a CUDA device a
    call that names no device raises; nothing carries on on the CPU."""
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        launches = ck.launches("voxel_matvec")
        out = call()
        if name == "simp_optimize":
            assert ck.launches("voxel_matvec") > launches
        else:
            assert out.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
