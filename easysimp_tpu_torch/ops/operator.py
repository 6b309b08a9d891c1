"""Matrix-free stiffness operators.

Port of `VoxelOperator` (easysimp_tpu/ops/operator.py:63-251) and of
`UnstructuredOperator` (:254-382).  The global K is never formed; its action
on a node field is

    K u = scatter( E(rho)_e * (ke_ref @ u_e) )

Dirichlet boundary conditions are masks: A(u) = M * K(M * u), with the
constrained subspace held exactly at zero.

`apply_K` and `element_energies_unit` dispatch on the device of their
tensors: CUDA tensors go to the hand-written kernels of `cuda_kernels.py`,
CPU tensors to their plain versions.  So does the two-field Lamé path of a
`material_model`: both kernels take `ke` as an argument, and ke(lam, mu) =
lam * ke_lam + mu * ke_mu, so K(lam, mu) u is two matvec launches and the
two material-derivative quadratics are two energies launches.

The unstructured operator (imported tet4/hex8 meshes) is the element
product s_e ke_e u_e (gather, per-element matrix, scale: one launch of the
hand kernel `element_apply` on CUDA tensors, its plain gather -> `bmm` ->
scale on CPU ones) -> sum into the dofs.  The sum into the dofs is NOT a
scatter-add (float atomics on CUDA would change the sum order from launch
to launch): a host-built padded incidence table lists, for every node, the
element slots that touch it, and the contributions are gathered and reduced
along the table's row, in a fixed order.  The kernel writes the table's
zero padding row itself.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..tracing import spanned, sync
from .cuda_kernels import (
    compute_dtype,
    element_apply,
    gather_element_dofs,
    scatter_element_dofs,
    voxel_energies,
    voxel_matvec,
)
from .elements import (
    HEX_CORNERS,
    hex8_stiffness,
    hex8_stiffness_lame_basis,
    simp_youngs_modulus,
)

__all__ = ["VoxelOperator", "UnstructuredOperator", "padded_groups",
           "group_sum"]


def padded_groups(index, n_groups):
    """Host: for an integer array `index` (values in [0, n_groups)) the
    (n_groups, max_count) int64 table whose row g lists, ascending, the
    positions i with index[i] == g, padded with len(index): the position of
    the zero row that `group_sum` appends."""
    index = np.asarray(index).reshape(-1)
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=n_groups)
    width = int(counts.max()) if index.size else 0
    table = np.full((n_groups, max(width, 1)), index.size, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = np.arange(index.size) - np.repeat(starts, counts)
    table[index[order], cols] = order
    return table


def group_sum(values, table):
    """out[g] = sum over row g of `table` of values[i], i.e. the
    scatter-add `out.index_add_(0, index, values)` of the index the table
    was built from, with a fixed summation order on every device.
    values: (n, ...) tensor; table: (n_groups, width) int64 tensor from
    `padded_groups`."""
    padded = torch.cat([values, values.new_zeros((1, *values.shape[1:]))])
    return padded[table].sum(dim=1)


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

    @spanned("op.apply")
    def apply(self, u, scale, free_mask):
        """BC-masked SPD operator A u = M K (M u) on the free subspace."""
        return free_mask * self.apply_K(free_mask * u, scale)

    def _corner_scatter(self, terms, free_mask):
        """Node field of sum over `terms` (element field, (8, 3) per-corner
        table) of field_e * table[c], scattered to each element's corners;
        1.0 on constrained dofs."""
        nx, ny, nz = self.grid.nels
        out = terms[0][0].new_zeros((nx + 1, ny + 1, nz + 1, 3))
        for c, (dx, dy, dz) in enumerate(HEX_CORNERS):
            out[dx:dx + nx, dy:dy + ny, dz:dz + nz, :] += \
                sum(field[..., None] * table[c] for field, table in terms)
        return torch.where(free_mask > 0, out, torch.ones_like(out))

    def diagonal(self, scale, free_mask):
        """diag(A) as a node field; 1.0 on constrained dofs."""
        return self._corner_scatter([(scale, self.ke_diag)], free_mask)

    def row_abs_sums(self, scale, free_mask):
        """Upper bound on global |K| row sums (Gershgorin data); 1.0 on
        constrained dofs."""
        return self._corner_scatter([(scale, self.ke_rowabs)], free_mask)

    def element_energies_unit(self, u):
        """u_e^T ke u_e per element (unit modulus), shape (nx, ny, nz)."""
        return voxel_energies(u, self.ke)

    # ----- variable-material (two-field Lamé) path ------------------------
    # Replaces the reference's `assemble_variable_material!` branch
    # (use_cache=false, FiniteElementAnalysis.jl:719-743): ke is linear in
    # (lam, mu), so an arbitrary per-element material, also one whose
    # Poisson ratio varies with density, is two constant-ke contractions
    # against two Lamé fields.
    @cached_property
    def ke_lame_basis(self):
        """(ke_lam, ke_mu) with ke(lam, mu) = lam*ke_lam + mu*ke_mu, on the
        device in the compute dtype (built at first use, then kept)."""
        return tuple(
            torch.as_tensor(k, dtype=compute_dtype(self.dtype),
                            device=self.device)
            for k in hex8_stiffness_lame_basis(self.grid.spacing))

    @cached_property
    def _ke_lame_diag(self):
        """Per-corner diagonals of (ke_lam, ke_mu), each (8, 3)."""
        return tuple(torch.diagonal(k).reshape(8, 3).to(self.dtype)
                     for k in self.ke_lame_basis)

    def apply_K_lame(self, u, lam_field, mu_field):
        """K(lam, mu) @ u with per-element Lamé fields (nx, ny, nz): one
        matvec per basis stiffness."""
        ke_lam, ke_mu = self.ke_lame_basis
        return (voxel_matvec(u, lam_field, ke_lam)
                + voxel_matvec(u, mu_field, ke_mu))

    def apply_K_lame_plain(self, u, lam_field, mu_field):
        """`apply_K_lame` as the reference writes it, in plain tensor code
        on any device: gather, two (N,24)@(24,24), scale, one scatter."""
        ke_lam, ke_mu = self.ke_lame_basis
        ue = gather_element_dofs(u).to(ke_lam.dtype)
        flat = ue.reshape(-1, 24)
        fe = (lam_field.to(ke_lam.dtype)[..., None]
              * (flat @ ke_lam).reshape(ue.shape)
              + mu_field.to(ke_lam.dtype)[..., None]
              * (flat @ ke_mu).reshape(ue.shape))
        return scatter_element_dofs(fe).to(u.dtype)

    @spanned("op.apply")
    def apply_lame(self, u, lam_field, mu_field, free_mask):
        """BC-masked SPD action of the variable-material operator."""
        return free_mask * self.apply_K_lame(free_mask * u, lam_field,
                                             mu_field)

    def diagonal_lame(self, lam_field, mu_field, free_mask):
        """diag of the masked variable-material K; 1.0 on constrained
        dofs."""
        dl, dm = self._ke_lame_diag
        return self._corner_scatter([(lam_field, dl), (mu_field, dm)],
                                    free_mask)

    def element_energies_lame(self, u):
        """(u_e^T ke_lam u_e, u_e^T ke_mu u_e) element fields, the
        material-derivative quadratics of the variable-material
        sensitivities: dc/drho_e = -(lam'(rho) w_lam + mu'(rho) w_mu)."""
        ke_lam, ke_mu = self.ke_lame_basis
        return voxel_energies(u, ke_lam), voxel_energies(u, ke_mu)

    def compliance_sensitivities(self, u, rho_phys):
        """d(compliance)/d(rho_phys) = -p rho^(p-1) (E0-Emin) u_e^T ke u_e."""
        dE = self.p * rho_phys ** (self.p - 1.0) * (self.E0 - self.Emin)
        return -dE * self.element_energies_unit(u)


class UnstructuredOperator:
    """Matrix-free K for imported tet4/hex8 meshes.

    Precomputes the per-element unit-modulus stiffness batch (the analogue of
    `initialize_element_cache`, FiniteElementAnalysis.jl:608-630), the
    connectivity and the node -> element-slot incidence table; the matvec
    is the element product (`element_apply`) -> fixed-order sum into the
    nodes.  Vectors are flat (n_dofs,) with dof = 3*node + comp.
    """

    def __init__(self, ke_unit, connectivity, n_nodes, E0, Emin, nu, p,
                 dtype=torch.float32, device="cuda"):
        self.E0 = float(E0)
        self.Emin = float(Emin)
        self.nu = float(nu)
        self.p = float(p)
        self.dtype = dtype
        self.device = torch.device(device)
        self.ke = torch.as_tensor(np.asarray(ke_unit), dtype=dtype,
                                  device=self.device)        # (E, d, d)
        conn = np.asarray(connectivity, dtype=np.int64)      # (E, nn)
        self.conn = torch.as_tensor(conn, device=self.device)      # (E, nn)
        self.n_nodes = int(n_nodes)
        self.n_dofs = 3 * self.n_nodes
        self.nn = conn.shape[1]
        # node -> the (element, corner) slots that touch it, element-major
        self.node_slots = torch.as_tensor(
            padded_groups(conn, self.n_nodes), device=self.device)

    def youngs_modulus(self, rho):
        return simp_youngs_modulus(rho, self.E0, self.Emin, self.p)

    def scatter_nodes(self, per_corner):
        """Sum per-(element, corner) values (E, nn, ...) into the nodes:
        (n_nodes, ...), in the fixed order of the incidence table."""
        flat = per_corner.reshape(-1, *per_corner.shape[2:])
        return group_sum(flat, self.node_slots)

    def scatter_dofs(self, fe):
        """Sum element dof vectors (E, d) into a flat (n_dofs,) vector."""
        return self.scatter_nodes(fe.reshape(-1, self.nn, 3)).reshape(-1)

    def gather(self, u):
        """u_e = u at each element's dofs, (E, d)."""
        return u.reshape(-1, 3)[self.conn].reshape(self.conn.shape[0], -1)

    def element_products(self, u, scale=None, ke=None, mask=None):
        """Per-corner rows of scale_e ke_e (mask u)_e and the zero row after
        them, (E nn + 1, 3): the padded input of `sum_corners`.  One
        `element_apply` launch on CUDA tensors."""
        return element_apply(u, self.conn, self.ke if ke is None else ke,
                             scale, mask)

    def sum_corners(self, padded):
        """Flat (n_dofs,) sums of `element_products` rows into the nodes, in
        the fixed order of the incidence table."""
        return padded[self.node_slots].sum(dim=1).reshape(-1)

    def apply_elements(self, u, ke=None):
        """(u_e, q_e = ke_e @ u_e), each (E, d)."""
        q = self.element_products(u, ke=ke)[:-1]
        return self.gather(u), q.reshape(self.conn.shape[0], -1)

    def apply_K(self, u, scale, mask=None):
        """K(rho) @ (mask u) with scale = E(rho); the output unmasked."""
        return self.sum_corners(self.element_products(u, scale, mask=mask))

    @spanned("op.apply")
    def apply(self, u, scale, free_mask):
        """BC-masked SPD operator A u = M K (M u) on the free subspace."""
        return free_mask * self.apply_K(u, scale, free_mask)

    def diagonal(self, scale, free_mask):
        """diag(A), flat; 1.0 on constrained dofs."""
        ked = torch.diagonal(self.ke, dim1=1, dim2=2)        # (E, d)
        out = self.scatter_dofs(scale[:, None] * ked)
        return torch.where(free_mask > 0, out, torch.ones_like(out))

    def block_diagonal_inverse(self, scale, free_mask):
        """Inverse 3x3 nodal diagonal blocks of the BC-masked K.

        Block Jacobi couples the three displacement components at each node:
        markedly stronger than scalar Jacobi for elasticity (the off-diagonal
        nodal coupling carries the Poisson effect).  Returns (n_nodes, 3, 3).
        """
        nn = self.nn
        # per-element per-corner 3x3 diagonal blocks of ke
        ke_blocks = torch.stack(
            [self.ke[:, 3 * c: 3 * c + 3, 3 * c: 3 * c + 3]
             for c in range(nn)], dim=1)                     # (E, nn, 3, 3)
        B = self.scatter_nodes(scale[:, None, None, None] * ke_blocks)
        # BC masking: zero constrained rows/cols, identity on the diagonal
        m = free_mask.reshape(self.n_nodes, 3)
        B = B * m[:, :, None] * m[:, None, :]
        B = B + (1.0 - m)[:, :, None] * torch.eye(
            3, dtype=B.dtype, device=B.device)
        with sync("block_jacobi_inv"):  # linalg.inv reads its status back
            return torch.linalg.inv(B)

    def apply_block_jacobi(self, Binv, r):
        """M^-1 r with the inverted nodal blocks; r flat (3*n_nodes,)."""
        z = torch.bmm(Binv, r.reshape(self.n_nodes, 3, 1))
        return z.reshape(-1)

    def element_energies_unit(self, u):
        """u_e^T ke_e u_e per element (unit modulus), (E,)."""
        ue, q = self.apply_elements(u)
        return (ue * q).sum(dim=-1)

    def compliance_sensitivities(self, u, rho_phys):
        """d(compliance)/d(rho_phys) = -p rho^(p-1) (E0-Emin) u_e^T ke u_e."""
        dE = self.p * rho_phys ** (self.p - 1.0) * (self.E0 - self.Emin)
        return -dE * self.element_energies_unit(u)

    # ----- variable-material (two-field Lamé) path ------------------------
    # ke_e is linear in (lam, mu), so the reference's per-cell
    # variable-material re-assembly (`assemble_variable_material!`,
    # FiniteElementAnalysis.jl:719-743) becomes two batched contractions
    # against two per-element Lamé fields.  The basis batches are installed
    # by the SIMP loop only when a material_model is in use (they double the
    # element-matrix storage).
    ke_lam = None
    ke_mu = None

    def set_lame_basis(self, ke_lam, ke_mu):
        """Install per-element (ke_lam, ke_mu) batches with
        ke_e = lam_e * ke_lam_e + mu_e * ke_mu_e (see
        elements.element_stiffness_lame_basis_batch_np)."""
        self.ke_lam = torch.as_tensor(np.asarray(ke_lam), dtype=self.dtype,
                                      device=self.device)
        self.ke_mu = torch.as_tensor(np.asarray(ke_mu), dtype=self.dtype,
                                     device=self.device)

    def apply_K_lame(self, u, lam_field, mu_field, mask=None):
        """K(lam, mu) @ (mask u) with per-element Lamé fields (E,): two
        element products, one sum."""
        return self.sum_corners(
            self.element_products(u, lam_field, self.ke_lam, mask)
            + self.element_products(u, mu_field, self.ke_mu, mask))

    @spanned("op.apply")
    def apply_lame(self, u, lam_field, mu_field, free_mask):
        """BC-masked SPD action of the variable-material operator."""
        return free_mask * self.apply_K_lame(u, lam_field, mu_field,
                                             free_mask)

    def element_energies_lame(self, u):
        """(u_e^T ke_lam u_e, u_e^T ke_mu u_e) element fields, the
        material-derivative quadratics of the variable-material
        sensitivities: dc/drho_e = -(lam'(rho) w_lam + mu'(rho) w_mu)."""
        ue, ql = self.apply_elements(u, self.ke_lam)
        _, qm = self.apply_elements(u, self.ke_mu)
        return (ue * ql).sum(dim=-1), (ue * qm).sum(dim=-1)
