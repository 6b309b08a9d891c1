"""Plain reference of the tet cantilever: a voxel grid of unit cubes, each
split into 6 tets around its 0-6 diagonal; linear-tet stiffness, K(rho) u,
element energies, the cone sensitivity filter over cell centroids, the load
and the supports, written from the problem's definition.

Cells are numbered tet-type-major: cell = t * n_voxels + voxel, voxels and
nodes x-fastest.  Fields are flat: cells (n_cells,), dofs (3 n_nodes,).
Every operation is plain PyTorch in the precision asked for ("float64",
"float32" or "tf32", the last two in float32 storage).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .common import dyoungs, isotropic_D, matmul, strain_B, youngs
from .voxel import CORNERS

# the 6 tets of a cube, as corner numbers of CORNERS
TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
        (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def tet_mesh(nels):
    """(node_coords (n_nodes, 3) float64, connectivity (n_cells, 4) int64)
    of the 6-tet split of an `nels` grid of unit cubes, every tet with
    positive volume."""
    nx, ny, nz = nels
    iz, iy, ix = np.meshgrid(np.arange(nz + 1), np.arange(ny + 1),
                             np.arange(nx + 1), indexing="ij")
    coords = np.stack([ix, iy, iz], -1).reshape(-1, 3).astype(np.float64)
    cz, cy, cx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    cx, cy, cz = cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)
    corner = np.stack([(cx + a) + (nx + 1) * ((cy + b) + (ny + 1) * (cz + c))
                       for a, b, c in CORNERS], 1)
    conn = np.concatenate([corner[:, list(t)] for t in TETS])
    J = coords[conn[:, 1:]] - coords[conn[:, :1]]
    neg = np.linalg.det(J) < 0
    conn[neg, 1], conn[neg, 2] = conn[neg, 2].copy(), conn[neg, 1].copy()
    return coords, conn


class TetProblem:
    """The cantilever of `nels` cubes as tets: fixed x=0 face, the total
    force `load` split equally over the nodes of the line x=nx, y=0."""

    def __init__(self, config, nels, device, precision="float64"):
        self.nels = tuple(int(n) for n in nels)
        self.m = config["params"]
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = torch.device(device)
        kw = dict(dtype=self.dtype, device=self.device)
        coords, conn = tet_mesh(self.nels)
        self.coords, self.conn = coords, conn
        nx, ny, nz = self.nels
        n_nodes = coords.shape[0]
        X = torch.as_tensor(coords[conn], dtype=torch.float64,
                            device=self.device)             # (E, 4, 3)
        J = X[:, 1:] - X[:, :1]
        vol = torch.linalg.det(J).abs() / 6.0
        G = torch.linalg.inv(J)                              # columns: grads
        dN = torch.cat([-G.sum(2, keepdim=True), G], 2).transpose(1, 2)
        B = strain_B(dN)                                     # (E, 6, 12)
        D = torch.as_tensor(isotropic_D(1.0, self.m["nu"]), dtype=B.dtype,
                            device=self.device)
        self.ke = (B.transpose(1, 2) @ D @ B * vol[:, None, None]).to(
            self.dtype)
        del X, J, G, dN, B
        self.cell_volume = vol.to(self.dtype)
        self.total_volume = float(vol.sum())
        dof = 3 * torch.as_tensor(conn, device=self.device)
        self.dofmap = (dof[:, :, None] + torch.arange(
            3, device=self.device)).reshape(-1, 12)
        self.mask = torch.ones(3 * n_nodes, **kw)
        fixed = np.flatnonzero(np.abs(coords[:, 0]) < 1e-6)
        self.mask.view(-1, 3)[torch.as_tensor(fixed, device=self.device)] = 0
        tip = np.flatnonzero((np.abs(coords[:, 0] - nx) < 1e-6)
                             & (np.abs(coords[:, 1]) < 1e-6))
        self.f = torch.zeros(3 * n_nodes, **kw)
        self.f.view(-1, 3)[torch.as_tensor(tip, device=self.device)] = \
            torch.as_tensor(config["load"]["total_force"], **kw) / len(tip)
        self._filter_weights()

    def _filter_weights(self):
        """Cone weights max(0, R - d) between centroids, R = filter_radius x
        the mean edge of the first 10 cells (EasySIMP.jl's element size).
        Centroids sit on the voxel lattice: cell (t, v) at v + c_t, so the
        pairs are (t, v) -- (s, v + d) for lattice offsets d."""
        first = self.coords[self.conn[:10]]
        edges = [np.linalg.norm(first[:, j] - first[:, i], axis=1)
                 for i, j in itertools.combinations(range(4), 2)]
        R = self.m["filter_radius"] * float(np.mean(np.mean(edges, 0)))
        corner = np.array(CORNERS, float)
        c = np.array([corner[list(t)].mean(0) for t in TETS])
        k = int(math.ceil(R)) + 1
        self.cone = []
        for t, s in itertools.product(range(6), repeat=2):
            for d in itertools.product(range(-k, k + 1), repeat=3):
                dist = float(np.linalg.norm(np.array(d) + c[s] - c[t]))
                if dist < R:
                    self.cone.append((t, s, d, R - dist))
        self.cone_sum = self._cone(torch.ones(6 * int(np.prod(self.nels)),
                                              dtype=self.dtype,
                                              device=self.device))

    def _cone(self, x):
        """sum_j H_ij x_j over the cells j within R of cell i."""
        nx, ny, nz = self.nels
        x = x.reshape(6, nz, ny, nx)
        out = torch.zeros_like(x)
        for t, s, (dx, dy, dz), w in self.cone:
            src = x[s, max(dz, 0):nz + min(dz, 0), max(dy, 0):ny + min(dy, 0),
                    max(dx, 0):nx + min(dx, 0)]
            out[t, max(-dz, 0):nz + min(-dz, 0), max(-dy, 0):ny + min(-dy, 0),
                max(-dx, 0):nx + min(-dx, 0)] += w * src
        return out.reshape(-1)

    def cells(self, a):
        return torch.as_tensor(a).to(self.device, self.dtype).reshape(-1)

    nodes = cells

    def _products(self, u):
        ue = u[self.dofmap]
        if self.precision == "tf32":
            return ue, matmul(self.ke, ue[:, :, None], "tf32")[:, :, 0]
        return ue, torch.bmm(self.ke, ue[:, :, None])[:, :, 0]

    def apply_K(self, u, E):
        _, q = self._products(u)
        return torch.zeros_like(u).index_add_(
            0, self.dofmap.reshape(-1), (q * E[:, None]).reshape(-1))

    def A(self, u, E):
        return self.mask * self.apply_K(self.mask * u, E)

    def diag(self, E):
        d = torch.diagonal(self.ke, dim1=1, dim2=2) * E[:, None]
        out = torch.zeros_like(self.mask).index_add_(
            0, self.dofmap.reshape(-1), d.reshape(-1))
        return torch.where(self.mask > 0, out, torch.ones_like(out))

    def energies(self, u):
        ue, q = self._products(u)
        return (ue * q).sum(1)

    def sensitivity_filter(self, x, dc):
        """sum_j H_ij x_j dc_j / V_j / (max(1e-3, x_i) / V_i sum_j H_ij)."""
        V = self.cell_volume
        return self._cone(x * dc / V) / (torch.clamp(x, min=1e-3) / V
                                         * self.cone_sum)

    def sensitivities(self, x, u):
        return -dyoungs(x, self.m) * self.energies(u)

    def modulus(self, x):
        return youngs(x, self.m)
