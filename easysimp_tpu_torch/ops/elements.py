"""Element-level math: SIMP material law and the hex8 element stiffness.

Port of the hex8 part of easysimp_tpu/ops/elements.py.  The voxel path
precomputes ONE reference 24x24 stiffness for the uniform box element at E=1
on the host in float64 and scales it per element by E(rho) on the device —
valid because ke is linear in E at fixed Poisson ratio.  A material model
with its own rho -> (lam, mu) law uses the two Lamé basis stiffnesses
instead, since ke is linear in (lam, mu) as well.

Node ordering is the VTK/Ferrite hexahedron order; local dofs are node-major
(node a's dofs at 3a..3a+2).
"""

from __future__ import annotations

import numpy as np

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
