"""Matrix-free stiffness operator on a voxel grid.

Port of `VoxelOperator` (easysimp_tpu/ops/operator.py:63-251).  The global K
is never formed; its action on a node field is

    K u = scatter( E(rho)_e * (ke_ref @ u_e) )

Dirichlet boundary conditions are masks: A(u) = M * K(M * u), with the
constrained subspace held exactly at zero.

`apply_K` and `element_energies_unit` dispatch on the device of their
tensors: CUDA tensors go to the hand-written kernels of `cuda_kernels.py`,
CPU tensors to their plain versions.  The two-field Lamé path
(`material_model`) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_kernels import (
    compute_dtype,
    gather_element_dofs,
    voxel_energies,
    voxel_matvec,
)
from .elements import HEX_CORNERS, hex8_stiffness, simp_youngs_modulus

__all__ = ["VoxelOperator"]


class VoxelOperator:
    """Matrix-free K on a structured voxel grid.

    Holds the float64-precomputed unit-modulus element stiffness on `device`
    (in the compute dtype of `dtype`: float32 for bfloat16 storage) and the
    SIMP material constants.  Methods are functions of their tensor
    arguments, which must lie on `device` in `dtype`.
    """

    def __init__(self, grid, E0=1.0, Emin=1e-9, nu=0.3, p=3.0,
                 dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.E0 = float(E0)
        self.Emin = float(Emin)
        self.nu = float(nu)
        self.p = float(p)
        self.dtype = dtype
        self.device = torch.device(device)
        ke64 = hex8_stiffness(grid.spacing, E=1.0, nu=self.nu)
        self.ke = torch.as_tensor(ke64, dtype=compute_dtype(dtype),
                                  device=self.device)
        # Per-corner diagonal 3-blocks of ke (Jacobi diagonal) and |ke| row
        # sums (Gershgorin bound), each (8, 3).
        diag = np.diag(ke64)
        rowabs = np.abs(ke64).sum(axis=1)
        self.ke_diag = torch.tensor(diag.reshape(8, 3), dtype=dtype,
                                    device=self.device)
        self.ke_rowabs = torch.tensor(rowabs.reshape(8, 3), dtype=dtype,
                                      device=self.device)

    # ----- material -------------------------------------------------------
    def youngs_modulus(self, rho):
        """E(rho): the per-element scaling of the unit-modulus ke."""
        return simp_youngs_modulus(rho, self.E0, self.Emin, self.p)

    # ----- core stencil action --------------------------------------------
    def apply_elements(self, u):
        """(u_e, q_e = ke @ u_e), each (nx, ny, nz, 24), in the compute
        dtype (plain tensor code on any device)."""
        ue = gather_element_dofs(u).to(self.ke.dtype)
        q = (ue.reshape(-1, 24) @ self.ke).reshape(ue.shape)
        return ue, q

    def apply_K(self, u, scale):
        """K(rho) @ u with scale = E(rho), no BC masking."""
        return voxel_matvec(u, scale, self.ke)

    def apply(self, u, scale, free_mask):
        """BC-masked SPD operator A u = M K (M u) on the free subspace."""
        return free_mask * self.apply_K(free_mask * u, scale)

    def _corner_scatter(self, scale, per_corner, free_mask):
        nx, ny, nz = self.grid.nels
        out = scale.new_zeros((nx + 1, ny + 1, nz + 1, 3))
        for c, (dx, dy, dz) in enumerate(HEX_CORNERS):
            out[dx:dx + nx, dy:dy + ny, dz:dz + nz, :] += \
                scale[..., None] * per_corner[c]
        return torch.where(free_mask > 0, out, torch.ones_like(out))

    def diagonal(self, scale, free_mask):
        """diag(A) as a node field; 1.0 on constrained dofs."""
        return self._corner_scatter(scale, self.ke_diag, free_mask)

    def row_abs_sums(self, scale, free_mask):
        """Upper bound on global |K| row sums (Gershgorin data); 1.0 on
        constrained dofs."""
        return self._corner_scatter(scale, self.ke_rowabs, free_mask)

    def element_energies_unit(self, u):
        """u_e^T ke u_e per element (unit modulus), shape (nx, ny, nz)."""
        return voxel_energies(u, self.ke)

    def compliance_sensitivities(self, u, rho_phys):
        """d(compliance)/d(rho_phys) = -p rho^(p-1) (E0-Emin) u_e^T ke u_e."""
        dE = self.p * rho_phys ** (self.p - 1.0) * (self.E0 - self.Emin)
        return -dE * self.element_energies_unit(u)
