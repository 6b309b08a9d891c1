"""Stress recovery and von Mises stress.

Port of easysimp_tpu/stress.py.  On voxel grids the strains at all Gauss
points of all elements come from one einsum against the precomputed B
matrices, on the device; on imported meshes the recovery runs once per run
on the host in numpy float64, as in the reference.  As in the reference package, von Mises is taken from the
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
           "unstructured_stresses", "von_mises_from_voigt"]


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


def _von_mises_np(sig):
    sxx, syy, szz = sig[..., 0], sig[..., 1], sig[..., 2]
    sxy, syz, sxz = sig[..., 3], sig[..., 4], sig[..., 5]
    return np.sqrt(np.maximum(
        0.0,
        sxx**2 + syy**2 + szz**2 - sxx * syy - syy * szz - szz * sxx
        + 3.0 * (sxy**2 + syz**2 + sxz**2)))


def unstructured_stresses(mesh, u_flat, rho_phys, E0, Emin, nu, p,
                          material_model=None) -> StressField:
    """Host-side (numpy float64) stress recovery for imported meshes.

    One-shot per run (final analysis / checkpoint exports), so host numpy is
    the right cost/complexity point; batched over all elements.
    material_model: optional rho -> (lam, mu) closure on tensors (the
    reference passes its material closure into calculate_stresses_simp the
    same way, FiniteElementAnalysis.jl:567-580); it is called on a CPU
    float64 tensor.
    """
    from .ops.elements import (
        _b_matrix_batch_np,
        _gauss_points_2x2x2,
        _hex8_shape_gradients_ref,
    )

    coords = mesh.node_coords[mesh.connectivity]       # (E, nn, 3)
    nn = coords.shape[1]
    dofmap = (3 * mesh.connectivity[:, :, None] + np.arange(3)).reshape(
        mesh.n_cells, -1)
    ue = np.asarray(u_flat, dtype=np.float64)[dofmap]  # (E, 3nn)
    rho = np.asarray(rho_phys, dtype=np.float64)

    if material_model is not None:
        lam, mu = material_model(torch.as_tensor(rho))
        lam = np.asarray(lam, dtype=np.float64)
        mu = np.asarray(mu, dtype=np.float64)
    else:
        lam, mu = lame_parameters(simp_youngs_modulus(rho, E0, Emin, p), nu)

    def sigma_from_eps(eps):
        tr = eps[..., 0] + eps[..., 1] + eps[..., 2]
        sig = np.empty_like(eps)
        for c in range(3):
            sig[..., c] = lam * tr + 2.0 * mu * eps[..., c]
        for c in range(3, 6):
            sig[..., c] = mu * eps[..., c]   # engineering shear
        return sig

    if nn == 4:
        J = coords[:, 1:4, :] - coords[:, 0:1, :]
        invJ = np.linalg.inv(J)
        dNdL = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
        dNdx = np.einsum("ai,nxi->nax", dNdL, invJ)
        B = _b_matrix_batch_np(dNdx)                   # (E, 6, 12)
        eps = np.einsum("nck,nk->nc", B, ue)
        sig = sigma_from_eps(eps)
        # Constant-strain tets: one evaluation, but the reference's
        # QuadratureRule{RefTetrahedron}(2) has FOUR quadrature points
        # (FiniteElementAnalysis.jl:142), so its Dict{cell -> [sigma_qp]}
        # holds four (identical) tensors per tet: reproduce the shape.
        qp = np.repeat(sig[:, None, :], 4, axis=1)
        avg = sig
    else:
        pts, _ = _gauss_points_2x2x2()
        qps = []
        for q in range(8):
            dNdxi = _hex8_shape_gradients_ref(pts[q])
            Jq = np.einsum("ai,naj->nij", dNdxi, coords)
            invJ = np.linalg.inv(Jq)
            dNdx = np.einsum("ai,nxi->nax", dNdxi, invJ)
            B = _b_matrix_batch_np(dNdx)
            eps = np.einsum("nck,nk->nc", B, ue)
            qps.append(sigma_from_eps(eps))
        qp = np.stack(qps, axis=1)                     # (E, 8, 6)
        avg = qp.mean(axis=1)

    vm = _von_mises_np(avg)
    imax = int(np.argmax(vm))
    return StressField(
        qp_stresses=qp,
        avg_stresses=avg,
        von_mises=vm,
        max_von_mises=float(vm[imax]),
        max_vm_cell=imax,
    )
