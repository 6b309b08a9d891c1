"""What the voxel and the tet reference share: the material, the OC update,
the TF32 rounding of the control and a Jacobi-preconditioned CG.

Plain PyTorch and NumPy, written from the SIMP method's equations (Sigmund's
99-line code and EasySIMP.jl's OptimalityCriteria.jl).  Nothing here imports
the program under test, and nothing takes a table the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

X_MIN = 1e-3            # lower density bound of the OC update
VOLUME_TOL = 1e-6       # absolute volume tolerance of the bisection
MAX_BISECTION = 200


def isotropic_D(E, nu):
    """6x6 elasticity matrix, Voigt order (xx, yy, zz, yz, xz, xy) with
    engineering shear strains, float64 numpy."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] = lam + 2.0 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    return D


def strain_B(dN):
    """(..., 6, 3n) strain-displacement matrices from shape gradients dN
    (..., n, 3), dofs node-major (x, y, z per node)."""
    n = dN.shape[-2]
    B = dN.new_zeros((*dN.shape[:-2], 6, 3 * n))
    gx, gy, gz = dN[..., 0], dN[..., 1], dN[..., 2]
    B[..., 0, 0::3] = gx
    B[..., 1, 1::3] = gy
    B[..., 2, 2::3] = gz
    B[..., 3, 1::3] = gz
    B[..., 3, 2::3] = gy
    B[..., 4, 0::3] = gz
    B[..., 4, 2::3] = gx
    B[..., 5, 0::3] = gy
    B[..., 5, 1::3] = gx
    return B


def youngs(rho, m):
    """SIMP modulus E(rho) = Emin + (E0 - Emin) rho^p."""
    return m["Emin"] + (m["E0"] - m["Emin"]) * rho ** m["p"]


def dyoungs(rho, m):
    return m["p"] * rho ** (m["p"] - 1.0) * (m["E0"] - m["Emin"])


def round_tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32:
    what a TF32 tensor-core product reads of each operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a, b, precision):
    """a @ b in the reference's precision: "float64", "float32" (TF32 off)
    or "tf32" (both operands rounded to TF32, float32 sums)."""
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def oc_update(x, dc, dv, vol_weights, vf, total_volume, move, damping):
    """Optimality-criteria update with bisection on the Lagrange multiplier
    until the volume error is under VOLUME_TOL (absolute), in x's dtype.

    x_new = clamp(x (|dc| / dv)^damping lam^-damping,
                  max(X_MIN, x - move), min(1, x + move))
    """
    q = x * (dc.abs() / dv) ** damping
    lo_e = torch.clamp(x - move, min=X_MIN)
    hi_e = torch.clamp(x + move, max=1.0)
    target = vf * total_volume
    lo, hi = 1e-9, 1e9
    eps = torch.finfo(x.dtype).eps
    x_new = x
    for _ in range(MAX_BISECTION):
        lam = 0.5 * (lo + hi)
        x_new = torch.clamp(q * lam ** (-damping), lo_e, hi_e)
        err = float((x_new * vol_weights).sum()) - target
        if abs(err) < VOLUME_TOL or hi - lo <= eps * hi:
            break
        if err > 0:
            lo = lam
        else:
            hi = lam
    return x_new


def pcg(A, b, x0, diag, rtol, maxiter):
    """Jacobi-preconditioned CG from x0 until ||r|| <= rtol ||b||; returns
    (x, iterations, ||r|| / ||b||) with r the recurrence residual."""
    x = x0.clone()
    r = b - A(x)
    bnorm = float(torch.linalg.vector_norm(b))
    z = r / diag
    p = z.clone()
    rz = float((r * z).sum())
    k = 0
    rnorm = float(torch.linalg.vector_norm(r))
    while k < maxiter and rnorm > rtol * bnorm:
        Ap = A(p)
        alpha = rz / float((p * Ap).sum())
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / diag
        rz_new = float((r * z).sum())
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = float(torch.linalg.vector_norm(r))
        k += 1
    return x, k, rnorm / max(bnorm, 1e-300)


def forcing_rtol(change, coeff, rtol_min, rtol_max):
    """The adaptive CG tolerance after an iteration whose largest design
    change was `change` (None before the first)."""
    if change is None or not math.isfinite(change):
        return rtol_max
    return min(rtol_max, max(rtol_min, coeff * change))
