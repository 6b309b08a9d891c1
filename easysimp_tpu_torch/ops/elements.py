"""Element-level math: SIMP material law and the element stiffnesses.

Port of easysimp_tpu/ops/elements.py.  The voxel path
precomputes ONE reference 24x24 stiffness for the uniform box element at E=1
on the host in float64 and scales it per element by E(rho) on the device —
valid because ke is linear in E at fixed Poisson ratio.  A material model
with its own rho -> (lam, mu) law uses the two Lamé basis stiffnesses
instead, since ke is linear in (lam, mu) as well.

Node ordering is the VTK/Ferrite hexahedron order; local dofs are node-major
(node a's dofs at 3a..3a+2).

The unstructured path precomputes one unit-modulus stiffness PER ELEMENT of
an imported tet4/hex8 mesh, on the host in float64 (`*_batch_np`); the same
routines on tensors (`tet4_stiffness_batch`, `hex8_stiffness_batch`) run on
the device of their input.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "HEX_CORNERS",
    "lame_parameters",
    "create_material_model",
    "simp_youngs_modulus",
    "create_simp_material_model",
    "elasticity_matrix",
    "elasticity_matrix_lame",
    "hex8_b_matrices",
    "hex8_stiffness_lame_basis",
    "hex8_stiffness",
    "tet4_stiffness_batch",
    "hex8_stiffness_batch",
    "element_stiffness_batch_np",
    "element_stiffness_lame_basis_batch_np",
    "shape_integrals_batch_np",
]

# VTK / Ferrite RefHexahedron vertex order, as unit-cube corner offsets.
HEX_CORNERS = (
    (0, 0, 0),
    (1, 0, 0),
    (1, 1, 0),
    (0, 1, 0),
    (0, 0, 1),
    (1, 0, 1),
    (1, 1, 1),
    (0, 1, 1),
)

# Corner signs in the reference element [-1, 1]^3 (same order).
_XI = np.array([[2 * c[0] - 1, 2 * c[1] - 1, 2 * c[2] - 1] for c in HEX_CORNERS],
               dtype=np.float64)


def lame_parameters(E, nu):
    """(lambda, mu) from Young's modulus and Poisson ratio
    (FiniteElementAnalysis.jl:52-56).  Works on floats, arrays and tensors."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


def create_material_model(E, nu):
    """The reference's `create_material_model`
    (FiniteElementAnalysis.jl:79-81): the (lambda, mu) tuple."""
    return lame_parameters(E, nu)


def simp_youngs_modulus(rho, E0, Emin, p):
    """SIMP law E(rho) = Emin + (E0 - Emin) * rho^p
    (FiniteElementAnalysis.jl:100-112).  Works on arrays and tensors."""
    return Emin + (E0 - Emin) * rho**p


def create_simp_material_model(E0, nu, Emin=1e-6, p=3.0):
    """rho -> (lambda, mu) under the SIMP law, as the reference's
    `create_simp_material_model` (FiniteElementAnalysis.jl:100-112).  The
    closure is elementwise arithmetic, so it takes tensors (and is
    differentiable by `torch.func.jvp`) as well as arrays and floats."""

    def material_for_density(rho):
        return lame_parameters(simp_youngs_modulus(rho, E0, Emin, p), nu)

    return material_for_density


def elasticity_matrix(E, nu):
    """6x6 isotropic elasticity matrix in Voigt order
    (xx, yy, zz, xy, yz, xz) with engineering shear strains."""
    lam, mu = lame_parameters(E, nu)
    D = np.zeros((6, 6), dtype=np.float64)
    D[:3, :3] = lam
    D[0, 0] = D[1, 1] = D[2, 2] = lam + 2.0 * mu
    D[3, 3] = D[4, 4] = D[5, 5] = mu
    return D


def _gauss_points_2x2x2():
    g = 1.0 / np.sqrt(3.0)
    pts = np.array(
        [[sx * g, sy * g, sz * g]
         for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)],
        dtype=np.float64,
    )
    wts = np.ones(8, dtype=np.float64)
    return pts, wts


def _hex8_shape_gradients_ref(xi):
    """d N_a / d xi at reference point xi, shape (8, 3)."""
    xi = np.asarray(xi, dtype=np.float64)
    grads = np.empty((8, 3), dtype=np.float64)
    for a in range(8):
        sx, sy, sz = _XI[a]
        grads[a, 0] = 0.125 * sx * (1 + sy * xi[1]) * (1 + sz * xi[2])
        grads[a, 1] = 0.125 * sy * (1 + sx * xi[0]) * (1 + sz * xi[2])
        grads[a, 2] = 0.125 * sz * (1 + sx * xi[0]) * (1 + sy * xi[1])
    return grads


def _b_matrix(dNdx):
    """Strain-displacement matrix (6, 3*n) from physical shape gradients
    (n, 3), Voigt order (xx, yy, zz, xy, yz, xz), engineering shear."""
    n = dNdx.shape[0]
    B = np.zeros((6, 3 * n), dtype=np.float64)
    for a in range(n):
        dx, dy, dz = dNdx[a]
        B[0, 3 * a + 0] = dx
        B[1, 3 * a + 1] = dy
        B[2, 3 * a + 2] = dz
        B[3, 3 * a + 0] = dy
        B[3, 3 * a + 1] = dx
        B[4, 3 * a + 1] = dz
        B[4, 3 * a + 2] = dy
        B[5, 3 * a + 0] = dz
        B[5, 3 * a + 2] = dx
    return B


def hex8_b_matrices(spacing):
    """B matrices and integration weights for the uniform box element.

    Returns (B, w): B is (8, 6, 24) — one strain-displacement matrix per
    2x2x2 Gauss point — and w the (8,) integration weights (detJ * gauss
    weight).  float64 numpy.
    """
    hx, hy, hz = (float(s) for s in spacing)
    pts, wts = _gauss_points_2x2x2()
    detJ = (hx * hy * hz) / 8.0
    inv_scale = np.array([2.0 / hx, 2.0 / hy, 2.0 / hz], dtype=np.float64)
    B = np.empty((8, 6, 24), dtype=np.float64)
    w = np.empty(8, dtype=np.float64)
    for q in range(8):
        dNdx = _hex8_shape_gradients_ref(pts[q]) * inv_scale[None, :]
        B[q] = _b_matrix(dNdx)
        w[q] = wts[q] * detJ
    return B, w


def elasticity_matrix_lame(lam, mu):
    """6x6 isotropic elasticity matrix from the Lamé parameters.  D is
    linear in (lam, mu), which is what makes ke(lam, mu) = lam * ke_lam +
    mu * ke_mu with two constant basis matrices."""
    D = np.zeros((6, 6), dtype=np.float64)
    D[:3, :3] = lam
    D[0, 0] = D[1, 1] = D[2, 2] = lam + 2.0 * mu
    D[3, 3] = D[4, 4] = D[5, 5] = mu
    return D


def _hex8_stiffness_from_D(spacing, D):
    B, w = hex8_b_matrices(spacing)
    ke = np.zeros((24, 24), dtype=np.float64)
    for q in range(8):
        ke += w[q] * (B[q].T @ D @ B[q])
    return 0.5 * (ke + ke.T)


def hex8_stiffness_lame_basis(spacing):
    """(ke_lam, ke_mu): the 24x24 stiffnesses of the uniform box element at
    (lam, mu) = (1, 0) and (0, 1), float64 numpy, symmetrised.  An arbitrary
    per-element material is then two constant-ke contractions against two
    Lamé fields, in place of the reference's per-cell re-assembly
    (`assemble_variable_material!`, FiniteElementAnalysis.jl:719-743)."""
    return (_hex8_stiffness_from_D(spacing, elasticity_matrix_lame(1.0, 0.0)),
            _hex8_stiffness_from_D(spacing, elasticity_matrix_lame(0.0, 1.0)))


def hex8_stiffness(spacing, E=1.0, nu=0.3):
    """24x24 stiffness of an axis-aligned box element (hx, hy, hz).

    float64 numpy with exact 2x2x2 Gauss quadrature — the single reference
    `ke` that the voxel matrix-free operator scales by E(rho) per element.
    """
    return _hex8_stiffness_from_D(spacing, elasticity_matrix(E, nu))


# ---------------------------------------------------------------------------
# Unstructured batched elements on tensors (any device)
# ---------------------------------------------------------------------------

_TET_DNDL = ((-1.0, -1.0, -1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
             (0.0, 0.0, 1.0))


def _b_matrix_batch(dNdx):
    """Batched B: (n, a, 3) physical gradients -> (n, 6, 3a) Voigt matrix."""
    n, a, _ = dNdx.shape
    dx, dy, dz = dNdx[..., 0], dNdx[..., 1], dNdx[..., 2]   # (n, a)
    zero = torch.zeros_like(dx)
    # rows of B per node: stack (6, 3) blocks then interleave into (6, 3a)
    blocks = torch.stack(
        [
            torch.stack([dx, zero, zero], dim=-1),
            torch.stack([zero, dy, zero], dim=-1),
            torch.stack([zero, zero, dz], dim=-1),
            torch.stack([dy, dx, zero], dim=-1),
            torch.stack([zero, dz, dy], dim=-1),
            torch.stack([dz, zero, dx], dim=-1),
        ],
        dim=-2,
    )  # (n, a, 6, 3)
    return blocks.permute(0, 2, 1, 3).reshape(n, 6, 3 * a)


def tet4_stiffness_batch(coords, E=1.0, nu=0.3):
    """Batched constant-strain tet4 stiffness: coords (n, 4, 3) tensor ->
    (ke (n, 12, 12), signed volumes (n,)).

    Linear tetrahedra have constant shape gradients, so the quadrature loop
    of the reference (FiniteElementAnalysis.jl:174-193 with RefTetrahedron)
    collapses to one closed-form B^T D B * V per element, evaluated for the
    whole batch at once.
    """
    coords = torch.as_tensor(coords)
    kw = dict(dtype=coords.dtype, device=coords.device)
    # Edge matrix J = [x1-x0; x2-x0; x3-x0] (rows), volume = det(J)/6.
    J = coords[:, 1:4, :] - coords[:, 0:1, :]              # (n, 3, 3)
    vol = torch.linalg.det(J) / 6.0
    invJ = torch.linalg.inv(J)
    # N0 = 1 - L1 - L2 - L3, Ni = Li.  With J_ij = dx_j/dL_i we have
    # dL_i/dx_j = (J^{-1})_ji, so dN_a/dx_j = sum_i dNdL[a,i] * invJ[j,i].
    dNdL = torch.tensor(_TET_DNDL, **kw)                   # (4, 3)
    dNdx = torch.einsum("ai,nxi->nax", dNdL, invJ)         # (n, 4, 3)
    B = _b_matrix_batch(dNdx)                              # (n, 6, 12)
    D = torch.as_tensor(elasticity_matrix(E, nu), **kw)
    ke = torch.einsum("nia,ij,njb,n->nab", B, D, B, vol)
    return 0.5 * (ke + ke.transpose(1, 2)), vol


def hex8_stiffness_batch(coords, E=1.0, nu=0.3):
    """Batched isoparametric hex8 stiffness: coords (n, 8, 3) tensor ->
    (ke (n, 24, 24), volumes (n,)).  General (possibly distorted) hexahedra
    from imported meshes; 2x2x2 Gauss."""
    coords = torch.as_tensor(coords)
    kw = dict(dtype=coords.dtype, device=coords.device)
    pts, wts = _gauss_points_2x2x2()
    ke = torch.zeros((coords.shape[0], 24, 24), **kw)
    vol = torch.zeros(coords.shape[0], **kw)
    D = torch.as_tensor(elasticity_matrix(E, nu), **kw)
    for q in range(8):
        dNdxi = torch.as_tensor(_hex8_shape_gradients_ref(pts[q]), **kw)
        # J_ij = d x_j / d xi_i = sum_a dN_a/dxi_i * x_a_j
        J = torch.einsum("ai,naj->nij", dNdxi, coords)     # (n, 3, 3)
        detJ = torch.linalg.det(J)
        invJ = torch.linalg.inv(J)
        dNdx = torch.einsum("ai,nxi->nax", dNdxi, invJ)    # (n, 8, 3)
        B = _b_matrix_batch(dNdx)                          # (n, 6, 24)
        w = wts[q] * detJ
        ke = ke + torch.einsum("nia,ij,njb,n->nab", B, D, B, w)
        vol = vol + w
    return 0.5 * (ke + ke.transpose(1, 2)), vol


# ---------------------------------------------------------------------------
# Host-side (numpy, float64) batched elements: the one-time precompute for the
# unstructured operator.  Always double precision regardless of the device
# dtype (the unit-ke cache is the analogue of the reference's
# initialize_element_cache and must not inherit float32 truncation).
# ---------------------------------------------------------------------------

def _b_matrix_batch_np(dNdx):
    n, a, _ = dNdx.shape
    B = np.zeros((n, 6, 3 * a), dtype=np.float64)
    dx, dy, dz = dNdx[..., 0], dNdx[..., 1], dNdx[..., 2]
    idx = 3 * np.arange(a)
    B[:, 0, idx + 0] = dx
    B[:, 1, idx + 1] = dy
    B[:, 2, idx + 2] = dz
    B[:, 3, idx + 0] = dy
    B[:, 3, idx + 1] = dx
    B[:, 4, idx + 1] = dz
    B[:, 4, idx + 2] = dy
    B[:, 5, idx + 0] = dz
    B[:, 5, idx + 2] = dx
    return B


def element_stiffness_batch_np(coords, E=1.0, nu=0.3):
    """Batched unit-modulus ke in numpy float64.

    coords: (n, 4, 3) tet4 or (n, 8, 3) hex8 (VTK order).
    Returns (ke (n, d, d), volumes (n,)).
    """
    return _stiffness_batch_np(coords, elasticity_matrix(E, nu))


def element_stiffness_lame_basis_batch_np(coords):
    """Batched Lamé-basis stiffnesses: (ke_lam (n,d,d), ke_mu (n,d,d)).

    ke_e(lam, mu) = lam * ke_lam_e + mu * ke_mu_e exactly (D is linear in
    the Lamé parameters): the unstructured analogue of
    `hex8_stiffness_lame_basis`, which gives the reference's
    variable-material branch (`assemble_variable_material!`,
    FiniteElementAnalysis.jl:719-743) on imported tet4/hex8 meshes without
    per-iteration re-quadrature.
    """
    kl, _ = _stiffness_batch_np(coords, elasticity_matrix_lame(1.0, 0.0))
    km, _ = _stiffness_batch_np(coords, elasticity_matrix_lame(0.0, 1.0))
    return kl, km


def _stiffness_batch_np(coords, D):
    """Batched ke for a fixed 6x6 elasticity matrix D; see
    element_stiffness_batch_np."""
    coords = np.asarray(coords, dtype=np.float64)
    n, nn, _ = coords.shape
    if nn == 4:
        J = coords[:, 1:4, :] - coords[:, 0:1, :]
        detJ = np.linalg.det(J)
        vol = detJ / 6.0
        invJ = np.linalg.inv(J)
        dNdL = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
        dNdx = np.einsum("ai,nxi->nax", dNdL, invJ)
        B = _b_matrix_batch_np(dNdx)
        ke = np.einsum("nia,ij,njb,n->nab", B, D, B, vol)
    elif nn == 8:
        pts, wts = _gauss_points_2x2x2()
        ke = np.zeros((n, 24, 24), dtype=np.float64)
        vol = np.zeros(n, dtype=np.float64)
        for q in range(8):
            dNdxi = _hex8_shape_gradients_ref(pts[q])
            J = np.einsum("ai,naj->nij", dNdxi, coords)
            detJ = np.linalg.det(J)
            invJ = np.linalg.inv(J)
            dNdx = np.einsum("ai,nxi->nax", dNdxi, invJ)
            B = _b_matrix_batch_np(dNdx)
            w = wts[q] * detJ
            ke += np.einsum("nia,ij,njb,n->nab", B, D, B, w)
            vol += w
    else:
        raise ValueError(f"unsupported element with {nn} nodes")
    return 0.5 * (ke + ke.transpose(0, 2, 1)), vol


def shape_integrals_batch_np(coords):
    """integral(N_a) dOmega per element node, numpy float64: (n, nn).

    Used by the variable-density body force (the reference integrates this
    with cell quadrature per element, FiniteElementAnalysis.jl:504-517).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n, nn, _ = coords.shape
    if nn == 4:
        J = coords[:, 1:4, :] - coords[:, 0:1, :]
        vol = np.linalg.det(J) / 6.0
        return np.repeat(vol[:, None] / 4.0, 4, axis=1)
    if nn == 8:
        pts, wts = _gauss_points_2x2x2()
        out = np.zeros((n, 8), dtype=np.float64)
        for q in range(8):
            xi = pts[q]
            s = _XI
            N = 0.125 * (1 + s[:, 0] * xi[0]) * (1 + s[:, 1] * xi[1]) \
                * (1 + s[:, 2] * xi[2])
            dNdxi = _hex8_shape_gradients_ref(xi)
            J = np.einsum("ai,naj->nij", dNdxi, coords)
            detJ = np.linalg.det(J)
            out += wts[q] * detJ[:, None] * N[None, :]
        return out
    raise ValueError(f"unsupported element with {nn} nodes")
