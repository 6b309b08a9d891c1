"""Boundary-condition visualization export.

Parity with `export_boundary_conditions`
(src/PostProcessing/ExportBoundaryConditions.jl:15-100): nodes are marked
1=fixed, 2=force; boundary faces whose nodes all share one marker are written
as a surface-only VTU with `boundary_type` cell data.
"""

from __future__ import annotations

import numpy as np

from ..grids import VoxelGrid
from ..utils.terminal import print_success
from .vtu import VTK_QUAD, VTK_TRIANGLE, write_vtu

__all__ = ["export_boundary_conditions"]


def _all_faces(grid):
    """(faces (n, 3|4) node ids, vtk face type) for every cell face."""
    from ..mesh import HEX_FACES, TET_FACES

    if isinstance(grid, VoxelGrid):
        conn, tables, vtk_type = grid.hex_connectivity, HEX_FACES, VTK_QUAD
    else:
        conn = grid.connectivity
        tables = TET_FACES if grid.cell_type == "tet4" else HEX_FACES
        vtk_type = VTK_TRIANGLE if grid.cell_type == "tet4" else VTK_QUAD
    faces = np.concatenate([conn[:, list(t)] for t in tables], axis=0)
    return faces, vtk_type


def export_boundary_conditions(grid, bcs, loads, path) -> str:
    """Write <path>.vtu marking fixed (1) and loaded (2) boundary faces."""
    markers = np.zeros(grid.n_nodes, dtype=np.int64)
    for bc in bcs:
        markers[np.asarray(bc.nodes)] = 1
    for load in loads:
        markers[np.asarray(load.nodes)] = 2

    faces, vtk_type = _all_faces(grid)
    face_markers = markers[faces]
    btype = np.zeros(faces.shape[0], dtype=np.int64)
    btype[np.all(face_markers == 1, axis=1)] = 1
    btype[np.all(face_markers == 2, axis=1)] = 2
    keep = btype > 0
    faces, btype = faces[keep], btype[keep]

    # compact to used nodes
    used, inv = np.unique(faces.reshape(-1), return_inverse=True)
    faces_local = inv.reshape(faces.shape)
    out = write_vtu(
        path,
        np.asarray(grid.node_coords)[used],
        faces_local,
        vtk_type,
        cell_data={"boundary_type": btype.astype(np.float64)},
        point_data={"marker": markers[used].astype(np.float64)},
    )
    print_success(f"Boundary conditions exported: {out}")
    return out
