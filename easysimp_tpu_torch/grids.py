"""Structured voxel grids (numpy only; port of easysimp_tpu/grids.py).

Replaces Ferrite's `generate_grid(Hexahedron, nels, corner0, corner1)`
(reference: src/FiniteElementAnalysis/FiniteElementAnalysis.jl:130-157 consumes
such grids) with an array-first representation: densities live as an
``(nx, ny, nz)`` array, node fields as ``(nx+1, ny+1, nz+1, 3)``.  There is no
DofHandler and no sparse matrix — element connectivity is implicit in the array
layout, so the stiffness action becomes a stencil (see ops/operator.py).

Node/cell numbering is x-fastest, matching Ferrite's `generate_grid` so node
ids produced by the geometric selection predicates line up with the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

__all__ = ["VoxelGrid", "generate_grid"]


@dataclass(frozen=True)
class VoxelGrid:
    """A structured grid of identical box (hexahedral) elements.

    Attributes:
      nels: element counts (nx, ny, nz).
      origin: coordinates of the min corner.
      spacing: element edge lengths (hx, hy, hz); may be anisotropic.
    """

    nels: tuple[int, int, int]
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)

    # ----- basic counts -------------------------------------------------
    @property
    def nnodes_per_axis(self) -> tuple[int, int, int]:
        nx, ny, nz = self.nels
        return (nx + 1, ny + 1, nz + 1)

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.nels
        return nx * ny * nz

    @property
    def n_nodes(self) -> int:
        a, b, c = self.nnodes_per_axis
        return a * b * c

    @property
    def n_dofs(self) -> int:
        return 3 * self.n_nodes

    @property
    def element_volume(self) -> float:
        hx, hy, hz = self.spacing
        return hx * hy * hz

    @property
    def total_volume(self) -> float:
        return self.element_volume * self.n_cells

    @property
    def characteristic_element_size(self) -> float:
        """Geometric mean of the three edges.

        Mirrors the reference's `calculate_hex_size`
        (src/Optimization/FilterCommon.jl:177-182); since all voxels are
        identical, sampling the first 10 cells (FilterCommon.jl:109-119)
        reduces to this single value.
        """
        hx, hy, hz = self.spacing
        return float((hx * hy * hz) ** (1.0 / 3.0))

    # ----- coordinates --------------------------------------------------
    @cached_property
    def node_coords(self) -> np.ndarray:
        """(n_nodes, 3) float64 node coordinates, x-fastest numbering."""
        nnx, nny, nnz = self.nnodes_per_axis
        hx, hy, hz = self.spacing
        ox, oy, oz = self.origin
        ix = np.arange(nnx) * hx + ox
        iy = np.arange(nny) * hy + oy
        iz = np.arange(nnz) * hz + oz
        # x-fastest: index = ix + iy*nnx + iz*nnx*nny
        X, Y, Z = np.meshgrid(ix, iy, iz, indexing="ij")
        coords = np.stack(
            [
                X.transpose(2, 1, 0).reshape(-1),
                Y.transpose(2, 1, 0).reshape(-1),
                Z.transpose(2, 1, 0).reshape(-1),
            ],
            axis=1,
        )
        return np.ascontiguousarray(coords)

    @cached_property
    def cell_centers(self) -> np.ndarray:
        """(n_cells, 3) float64 cell centers, x-fastest numbering."""
        nx, ny, nz = self.nels
        hx, hy, hz = self.spacing
        ox, oy, oz = self.origin
        cx = (np.arange(nx) + 0.5) * hx + ox
        cy = (np.arange(ny) + 0.5) * hy + oy
        cz = (np.arange(nz) + 0.5) * hz + oz
        X, Y, Z = np.meshgrid(cx, cy, cz, indexing="ij")
        return np.stack(
            [
                X.transpose(2, 1, 0).reshape(-1),
                Y.transpose(2, 1, 0).reshape(-1),
                Z.transpose(2, 1, 0).reshape(-1),
            ],
            axis=1,
        )

    # ----- index conversions -------------------------------------------
    def node_id_to_ijk(self, node_ids: np.ndarray) -> np.ndarray:
        """Flat (x-fastest) node ids -> (n, 3) integer (ix, iy, iz)."""
        nnx, nny, _ = self.nnodes_per_axis
        node_ids = np.asarray(node_ids)
        ix = node_ids % nnx
        iy = (node_ids // nnx) % nny
        iz = node_ids // (nnx * nny)
        return np.stack([ix, iy, iz], axis=-1)

    def node_ijk_to_id(self, ijk: np.ndarray) -> np.ndarray:
        nnx, nny, _ = self.nnodes_per_axis
        ijk = np.asarray(ijk)
        return ijk[..., 0] + nnx * (ijk[..., 1] + nny * ijk[..., 2])

    def cells_flat(self, arr3d: np.ndarray) -> np.ndarray:
        """(nx, ny, nz) cell array -> flat x-fastest vector (numpy)."""
        return np.asarray(arr3d).transpose(2, 1, 0).reshape(-1)

    def cells_3d(self, flat: np.ndarray) -> np.ndarray:
        nx, ny, nz = self.nels
        return np.asarray(flat).reshape(nz, ny, nx).transpose(2, 1, 0)

    def nodes_flat(self, field: np.ndarray) -> np.ndarray:
        """(nnx, nny, nnz, C) node field -> (n_nodes, C) x-fastest."""
        f = np.asarray(field)
        return f.transpose(2, 1, 0, 3).reshape(-1, f.shape[-1])

    def dofs_flat(self, field: np.ndarray) -> np.ndarray:
        """(nnx, nny, nnz, 3) displacement field -> (3*n_nodes,) dof vector
        with dof = 3*node + component (node-major, x-fastest nodes)."""
        return self.nodes_flat(field).reshape(-1)

    @cached_property
    def hex_connectivity(self) -> np.ndarray:
        """(n_cells, 8) int64 connectivity in VTK/Ferrite hexahedron node
        order, x-fastest cell numbering.  Used for VTU export and for
        cross-checks against explicitly assembled matrices."""
        from .ops.elements import HEX_CORNERS

        nx, ny, nz = self.nels
        nnx, nny, _ = self.nnodes_per_axis
        cix, ciy, ciz = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        base = np.stack(
            [
                cix.transpose(2, 1, 0).reshape(-1),
                ciy.transpose(2, 1, 0).reshape(-1),
                ciz.transpose(2, 1, 0).reshape(-1),
            ],
            axis=1,
        )
        conn = np.empty((self.n_cells, 8), dtype=np.int64)
        for c, (dx, dy, dz) in enumerate(HEX_CORNERS):
            conn[:, c] = (
                (base[:, 0] + dx)
                + nnx * ((base[:, 1] + dy) + nny * (base[:, 2] + dz))
            )
        return conn


def generate_grid(nels, corner0=(0.0, 0.0, 0.0), corner1=None) -> VoxelGrid:
    """Create a structured hexahedral voxel grid.

    API analogue of `Ferrite.generate_grid(Hexahedron, nels, c0, c1)` as used
    throughout the reference examples (e.g. test/runtests.jl:20-25).  When
    `corner1` is omitted the domain is `nels` unit cubes from `corner0`.
    """
    nx, ny, nz = (int(n) for n in nels)
    if min(nx, ny, nz) < 1:
        raise ValueError(f"element counts must be >= 1, got {nels}")
    c0 = np.asarray(corner0, dtype=np.float64)
    if corner1 is None:
        c1 = c0 + np.array([nx, ny, nz], dtype=np.float64)
    else:
        c1 = np.asarray(corner1, dtype=np.float64)
    spacing = (c1 - c0) / np.array([nx, ny, nz], dtype=np.float64)
    if np.any(spacing <= 0):
        raise ValueError("corner1 must be strictly greater than corner0")
    return VoxelGrid(
        nels=(nx, ny, nz),
        origin=tuple(float(v) for v in c0),
        spacing=tuple(float(v) for v in spacing),
    )
