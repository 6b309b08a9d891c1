"""Stress recovery and von Mises stress on voxel grids.

Port of the voxel part of easysimp_tpu/stress.py: strains at all Gauss
points of all elements come from one einsum against the precomputed B
matrices.  As in the reference package, von Mises is taken from the
cell-averaged stress (a documented deviation from EasySIMP.jl, which
exports the first quadrature point).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ops.cuda_kernels import gather_element_dofs
from .ops.elements import hex8_b_matrices, lame_parameters, simp_youngs_modulus

__all__ = ["StressField", "voxel_stress_arrays", "voxel_stresses",
           "von_mises_from_voigt"]


@dataclass
class StressField:
    """Per-element quadrature-point stresses in Voigt order
    (xx, yy, zz, xy, yz, xz).  Mapping-style access gives the reference's
    Dict{cell -> [sigma_qp]} view."""

    qp_stresses: np.ndarray     # (n_cells, n_qp, 6)
    avg_stresses: np.ndarray    # (n_cells, 6)
    von_mises: np.ndarray       # (n_cells,) from cell-averaged stress
    max_von_mises: float
    max_vm_cell: int

    def __getitem__(self, cell_id: int) -> np.ndarray:
        return self.qp_stresses[cell_id]

    def __len__(self) -> int:
        return self.qp_stresses.shape[0]

    def keys(self):
        return range(len(self))


def von_mises_from_voigt(sig):
    """sqrt(3/2 dev(s):dev(s)) for Voigt stresses (..., 6)."""
    sxx, syy, szz = sig[..., 0], sig[..., 1], sig[..., 2]
    sxy, syz, sxz = sig[..., 3], sig[..., 4], sig[..., 5]
    return torch.sqrt(torch.clamp(
        sxx**2 + syy**2 + szz**2
        - sxx * syy - syy * szz - szz * sxx
        + 3.0 * (sxy**2 + syz**2 + sxz**2), min=0.0))


def voxel_stress_arrays(grid, u_field, rho_phys, E0, Emin, nu, p,
                        material_model=None):
    """Batched stress recovery on u_field's device.

    Returns (qp_stresses (nx,ny,nz,8,6), avg (nx,ny,nz,6), vm (nx,ny,nz)):
    sigma = lambda tr(eps) I + 2 mu eps per Gauss point with the SIMP-scaled
    moduli (FiniteElementAnalysis.jl:537-555), or with those of
    `material_model`, a rho -> (lam, mu) closure on tensors, as the
    reference passes its closure into calculate_stresses_simp (:567-580)."""
    B, _ = hex8_b_matrices(grid.spacing)
    B = torch.as_tensor(B, dtype=u_field.dtype, device=u_field.device)
    ue = gather_element_dofs(u_field)                       # (nx,ny,nz,24)
    eps = torch.einsum("qck,...k->...qc", B, ue)            # (nx,ny,nz,8,6)
    if material_model is not None:
        lam, mu = material_model(rho_phys)
    else:
        E = simp_youngs_modulus(rho_phys, E0, Emin, p)
        lam, mu = lame_parameters(E, nu)
    lam_q = lam[..., None, None]
    mu_q = mu[..., None, None]
    tr = eps[..., 0:3].sum(dim=-1, keepdim=True)
    # engineering shear gamma: sigma_shear = mu * gamma
    sig = torch.cat([lam_q * tr + 2.0 * mu_q * eps[..., 0:3],
                     mu_q * eps[..., 3:6]], dim=-1)
    avg = sig.mean(dim=-2)
    return sig, avg, von_mises_from_voigt(avg)


def voxel_stresses(grid, u_field, rho_phys, E0, Emin, nu, p,
                   material_model=None) -> StressField:
    """Host-facing stress recovery, flattened to x-fastest cell numbering
    (float64 numpy)."""
    sig, avg, vm = voxel_stress_arrays(grid, u_field, rho_phys, E0, Emin,
                                       nu, p, material_model)
    sig = sig.cpu().double().numpy()
    sig_flat = sig.transpose(2, 1, 0, 3, 4).reshape(grid.n_cells, 8, 6)
    avg_flat = avg.cpu().double().numpy().transpose(2, 1, 0, 3).reshape(-1, 6)
    vm_flat = vm.cpu().double().numpy().transpose(2, 1, 0).reshape(-1)
    imax = int(np.argmax(vm_flat))
    return StressField(
        qp_stresses=sig_flat,
        avg_stresses=avg_flat,
        von_mises=vm_flat,
        max_von_mises=float(vm_flat[imax]),
        max_vm_cell=imax,
    )
