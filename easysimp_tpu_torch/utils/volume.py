"""Volume computations (parity: src/Utils/Utils.jl:17-110)."""

from __future__ import annotations

import numpy as np

__all__ = ["calculate_volume", "calculate_element_volumes"]


def calculate_element_volumes(grid) -> np.ndarray:
    """Per-element volumes (x-fastest cell numbering).

    Analogue of `calculate_element_volumes` (FiniteElementAnalysis.jl:754-771);
    uniform voxels collapse to a constant, unstructured meshes carry their
    precomputed (exact for tet4 / quadrature for hex8) volumes.
    """
    from ..grids import VoxelGrid

    if isinstance(grid, VoxelGrid):
        return np.full(grid.n_cells, grid.element_volume, dtype=np.float64)
    return np.asarray(grid.element_volumes, dtype=np.float64)


def calculate_volume(grid, densities=None) -> float:
    """Total (density-weighted) volume — the three reference methods
    (Utils.jl:17-28,44-110) unified: with densities it is the dot product with
    element volumes, without it is the mesh volume."""
    vols = calculate_element_volumes(grid)
    if densities is None:
        return float(np.sum(vols))
    densities = np.asarray(densities, dtype=np.float64).reshape(-1)
    return float(np.dot(densities, vols))
