"""Finite-difference verification of analytical sensitivities.

Port of easysimp_tpu/opt/verify_sensitivities.py, the user-facing analogue
of the reference's standalone verifier
(test/OptimizationTests/VerifySensitivities.jl:14-78): perturb the first N
element densities, recompute compliance, and print a relative-error table
against the analytical d(u^T K u)/d rho.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bcs import build_free_mask
from ..grids import VoxelGrid
from ..loads import build_load_field
from ..ops.cg import cg_solve
from ..ops.operator import VoxelOperator
from ..utils.terminal import print_data, print_info, print_success, \
    print_warning

__all__ = ["verify_sensitivities"]


def verify_sensitivities(grid, loads, boundary_conditions, params,
                         n_elements: int = 10, perturbation: float = 1e-6,
                         densities=None, cg_rtol: float = 1e-12,
                         device="cuda"):
    """FD-check d(compliance)/d(rho) for the first `n_elements` elements.

    Returns (analytical, finite_difference, relative_errors) arrays and
    prints the comparison table.  Uses float64 on `device`; compliance =
    u^T K u (the reference's sensitivity convention,
    SensitivityAnalysis.jl:74-78).
    """
    if not isinstance(grid, VoxelGrid):
        raise NotImplementedError("FD verification runs on voxel grids")
    dtype = torch.float64
    op = VoxelOperator(grid, E0=params.E0, Emin=params.Emin, nu=params.nu,
                       p=params.p, dtype=dtype, device=device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    mask = dev(build_free_mask(grid, boundary_conditions))
    f = dev(build_load_field(grid, loads)) * mask

    if densities is None:
        rho = np.full(grid.nels, params.volume_fraction)
    else:
        rho = np.asarray(grid.cells_3d(np.asarray(densities).reshape(-1))
                         if np.asarray(densities).ndim == 1 else densities)

    def compliance(rho3d):
        scale = op.youngs_modulus(dev(rho3d))
        diag = op.diagonal(scale, mask)
        sol = cg_solve(lambda v: op.apply(v, scale, mask), f,
                       M=lambda r: r / diag, rtol=cg_rtol, maxiter=50000)
        c = torch.dot(sol.u.reshape(-1), f.reshape(-1)) - sol.u_dot_r
        return float(c), sol.u

    c0, u = compliance(rho)
    sens = op.compliance_sensitivities(u, dev(rho)).cpu().numpy()
    sens_flat = grid.cells_flat(sens)

    n = min(n_elements, grid.n_cells)
    print_info(f"FD sensitivity check: {n} elements, h={perturbation}")
    print_data(f"{'elem':>6} | {'analytical':>14} | {'finite diff':>14} | "
               f"{'rel err':>10}")
    analytical, fd, rel = [], [], []
    nx, ny, nz = grid.nels
    for e in range(n):
        # x-fastest flat id -> ijk
        ix = e % nx
        iy = (e // nx) % ny
        iz = e // (nx * ny)
        pert = rho.copy()
        pert[ix, iy, iz] += perturbation
        c1, _ = compliance(pert)
        d = (c1 - c0) / perturbation
        a = sens_flat[e]
        r = abs(d - a) / max(abs(a), 1e-300)
        analytical.append(a)
        fd.append(d)
        rel.append(r)
        print_data(f"{e:>6} | {a:>14.6e} | {d:>14.6e} | {r:>10.3e}")

    worst = max(rel)
    if worst < 1e-3:
        print_success(f"Sensitivities verified (max rel err {worst:.2e})")
    else:
        print_warning(f"Large sensitivity error (max rel err {worst:.2e})")
    return np.asarray(analytical), np.asarray(fd), np.asarray(rel)
