"""Plain reference of the voxel cantilever: the hex8 stiffness, K(rho) u on
a node field, the element energies, the cone sensitivity filter, the load
and the supports, written from the problem's definition.

A node field is (nx+1, ny+1, nz+1, 3); a cell field (nx, ny, nz).  Every
operation is plain PyTorch in the precision asked for ("float64", "float32"
or "tf32", the last two in float32 storage).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .common import dyoungs, isotropic_D, matmul, strain_B, youngs

# corner offsets of a hex8 element, in VTK order
CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def hex8_ke(h, E, nu):
    """24x24 stiffness of an h-sided cube element, 2x2x2 Gauss, float64."""
    xi = np.array([[2 * c - 1 for c in corner] for corner in CORNERS], float)
    D = isotropic_D(E, nu)
    g = 1.0 / math.sqrt(3.0)
    ke = np.zeros((24, 24))
    for gp in itertools.product((-g, g), repeat=3):
        gp = np.array(gp)
        one = 1.0 + xi * gp                      # (8, 3)
        dN = np.empty((8, 3))
        for a in range(3):
            others = [b for b in range(3) if b != a]
            dN[:, a] = xi[:, a] * one[:, others[0]] * one[:, others[1]] / 8
        dN *= 2.0 / h                            # d/dxi -> d/dx
        B = strain_B(torch.from_numpy(dN)).numpy()
        ke += B.T @ D @ B * (h / 2.0) ** 3
    return ke


class VoxelProblem:
    """The cantilever on an `nels` grid of unit cubes: fixed x=0 face, the
    total force `load` split equally over the nodes of the line x=nx, y=0."""

    def __init__(self, config, nels, device, precision="float64"):
        self.nels = tuple(int(n) for n in nels)
        self.m = config["params"]
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = torch.device(device)
        kw = dict(dtype=self.dtype, device=self.device)
        self.ke = torch.as_tensor(hex8_ke(1.0, 1.0, self.m["nu"]), **kw)
        nx, ny, nz = self.nels
        self.mask = torch.ones((nx + 1, ny + 1, nz + 1, 3), **kw)
        self.mask[0] = 0.0
        self.f = torch.zeros_like(self.mask)
        self.f[nx, 0, :, :] = torch.as_tensor(config["load"]["total_force"],
                                              **kw) / (nz + 1)
        self.cell_volume = torch.ones(self.nels, **kw)
        self.total_volume = float(nx * ny * nz)
        # cone weights max(0, R - |d|) over integer cell offsets
        R = self.m["filter_radius"]
        k = int(math.floor(R))
        self.cone = [(d, R - math.sqrt(sum(c * c for c in d)))
                     for d in itertools.product(range(-k, k + 1), repeat=3)
                     if math.sqrt(sum(c * c for c in d)) < R]
        self.cone_sum = self._cone(torch.ones(self.nels, **kw))

    def cells(self, a):
        return torch.as_tensor(a).to(self.device, self.dtype).reshape(
            self.nels)

    def nodes(self, a):
        nx, ny, nz = self.nels
        return torch.as_tensor(a).to(self.device, self.dtype).reshape(
            nx + 1, ny + 1, nz + 1, 3)

    def _gather(self, u):
        nx, ny, nz = self.nels
        return torch.stack([u[a:a + nx, b:b + ny, c:c + nz]
                            for a, b, c in CORNERS], dim=3).reshape(-1, 24)

    def apply_K(self, u, E):
        """K(E) u for a cell field of moduli E, no supports."""
        nx, ny, nz = self.nels
        q = (matmul(self._gather(u), self.ke, self.precision)
             * E.reshape(-1, 1)).reshape(nx, ny, nz, 8, 3)
        out = torch.zeros_like(u)
        for i, (a, b, c) in enumerate(CORNERS):
            out[a:a + nx, b:b + ny, c:c + nz] += q[:, :, :, i]
        return out

    def A(self, u, E):
        """K on the free dofs: mask K(mask u)."""
        return self.mask * self.apply_K(self.mask * u, E)

    def diag(self, E):
        """diag(A), 1 on fixed dofs."""
        nx, ny, nz = self.nels
        d = torch.diagonal(self.ke).reshape(8, 3)
        out = torch.zeros_like(self.mask)
        for i, (a, b, c) in enumerate(CORNERS):
            out[a:a + nx, b:b + ny, c:c + nz] += E[..., None] * d[i]
        return torch.where(self.mask > 0, out, torch.ones_like(out))

    def energies(self, u):
        """u_e^T ke u_e per cell (unit modulus)."""
        ue = self._gather(u)
        return (ue * matmul(ue, self.ke, self.precision)).sum(1).reshape(
            self.nels)

    def _cone(self, x):
        """sum_j H_ij x_j over in-domain neighbours j."""
        nx, ny, nz = self.nels
        out = torch.zeros_like(x)
        for (dx, dy, dz), w in self.cone:
            src = x[max(dx, 0):nx + min(dx, 0), max(dy, 0):ny + min(dy, 0),
                    max(dz, 0):nz + min(dz, 0)]
            out[max(-dx, 0):nx + min(-dx, 0), max(-dy, 0):ny + min(-dy, 0),
                max(-dz, 0):nz + min(-dz, 0)] += w * src
        return out

    def sensitivity_filter(self, x, dc):
        """Sigmund's filter: sum_j H_ij x_j dc_j / (max(1e-3, x_i) sum_j
        H_ij) (unit cell volumes)."""
        return self._cone(x * dc) / (torch.clamp(x, min=1e-3)
                                     * self.cone_sum)

    def sensitivities(self, x, u):
        return -dyoungs(x, self.m) * self.energies(u)

    def modulus(self, x):
        return youngs(x, self.m)
