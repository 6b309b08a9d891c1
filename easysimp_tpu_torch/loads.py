"""Load conditions: point loads, surface tractions, body forces (port of
easysimp_tpu/loads.py).

The external load vector is evaluated ONCE on the host in float64 and reused
every SIMP iteration.  Only the variable-density body force depends on rho and
is recomputed on the device each iteration (`voxel_body_force`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from .grids import VoxelGrid
from .ops.elements import HEX_CORNERS

__all__ = [
    "AbstractLoadCondition",
    "PointLoad",
    "SurfaceTractionLoad",
    "apply_force",
    "build_load_field",
    "get_boundary_facets",
    "voxel_body_force",
]


class AbstractLoadCondition:
    """Base class for load conditions (LoadConditions.jl:19)."""


@dataclass(frozen=True)
class PointLoad(AbstractLoadCondition):
    """Total `force_vector` split equally across `nodes`
    (LoadConditions.jl:40-44 applied via apply_force!,
    FiniteElementAnalysis.jl:357-376)."""

    nodes: np.ndarray
    force_vector: tuple[float, float, float]

    def __post_init__(self):
        object.__setattr__(
            self, "nodes",
            np.asarray(sorted(set(np.asarray(self.nodes).tolist())), dtype=np.int64),
        )
        object.__setattr__(
            self, "force_vector",
            tuple(float(v) for v in np.asarray(self.force_vector).reshape(3)),
        )
        if len(self.nodes) == 0:
            raise ValueError("No nodes provided for force application.")


@dataclass(frozen=True)
class SurfaceTractionLoad(AbstractLoadCondition):
    """Position-dependent traction g(x, y, z) -> (Tx, Ty, Tz) integrated over
    the boundary facets spanned by `nodes` with face Gauss quadrature
    (LoadConditions.jl:72-154, apply_surface_traction!
    FiniteElementAnalysis.jl:390-440)."""

    nodes: np.ndarray
    traction_fn: Callable = field(compare=False)

    def __post_init__(self):
        object.__setattr__(
            self, "nodes",
            np.asarray(sorted(set(np.asarray(self.nodes).tolist())), dtype=np.int64),
        )


# ---------------------------------------------------------------------------
# Host-side load vector construction
# ---------------------------------------------------------------------------

def apply_force(f_nodes: np.ndarray, grid, nodes, force_vector) -> np.ndarray:
    """Accumulate a point load into a (n_nodes, 3) host load array.

    Parity with `apply_force!` (FiniteElementAnalysis.jl:357-376): total force
    divided equally over the nodes.
    """
    nodes = np.asarray(list(nodes), dtype=np.int64)
    if nodes.size == 0:
        raise ValueError("No nodes provided for force application.")
    per_node = np.asarray(force_vector, dtype=np.float64) / nodes.size
    np.add.at(f_nodes, nodes, per_node[None, :])
    return f_nodes


def _voxel_boundary_facets(grid: VoxelGrid, node_set: set[int]):
    """(cell_ijk, local_face) pairs whose 4 face nodes are all in node_set.

    Voxel analogue of `get_boundary_facets` (FiniteElementAnalysis.jl:450-479)
    using the same hex local-face tables.
    """
    # Local face -> corner indices (VTK hex order), matching the reference's
    # get_face_nodes(::Hexahedron) table (1-based there).
    faces = [
        (0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
        (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
    ]
    conn = grid.hex_connectivity  # (n_cells, 8)
    in_set = np.isin(conn, np.fromiter(node_set, dtype=np.int64))
    out = []
    for lf, fnodes in enumerate(faces):
        ok = np.all(in_set[:, list(fnodes)], axis=1)
        for cell in np.nonzero(ok)[0]:
            out.append((int(cell), lf))
    return out, faces, conn


def get_boundary_facets(grid, nodes):
    """Public parity API: facets (cell_id, local_face_id) fully inside `nodes`."""
    if isinstance(grid, VoxelGrid):
        pairs, _, _ = _voxel_boundary_facets(grid, set(int(n) for n in nodes))
        return set(pairs)
    return set(grid.boundary_facets_for_nodes(nodes))


def _face_quadrature_2d():
    """2x2 Gauss on the reference square [-1,1]^2."""
    g = 1.0 / np.sqrt(3.0)
    pts = np.array([[-g, -g], [g, -g], [g, g], [-g, g]], dtype=np.float64)
    wts = np.ones(4, dtype=np.float64)
    return pts, wts


def _quad_face_traction(coords4, traction_fn):
    """Integrate traction over one bilinear quad face.

    coords4: (4, 3) face corner coordinates (cyclic order).
    Returns (4, 3) nodal force contributions.
    """
    pts, wts = _face_quadrature_2d()
    fe = np.zeros((4, 3), dtype=np.float64)
    for q in range(4):
        xi, eta = pts[q]
        N = 0.25 * np.array(
            [(1 - xi) * (1 - eta), (1 + xi) * (1 - eta),
             (1 + xi) * (1 + eta), (1 - xi) * (1 + eta)]
        )
        dNdxi = 0.25 * np.array(
            [[-(1 - eta), -(1 - xi)], [(1 - eta), -(1 + xi)],
             [(1 + eta), (1 + xi)], [-(1 + eta), (1 - xi)]]
        )  # (4, 2)
        x_qp = N @ coords4
        t1 = dNdxi[:, 0] @ coords4
        t2 = dNdxi[:, 1] @ coords4
        dGamma = np.linalg.norm(np.cross(t1, t2)) * wts[q]
        trac = np.asarray(traction_fn(x_qp[0], x_qp[1], x_qp[2]), dtype=np.float64)
        fe += np.outer(N, trac) * dGamma
    return fe


def _tri_face_traction(coords3, traction_fn):
    """Integrate traction over one linear triangle face (3-pt edge-midpoint
    rule, exact for linear tractions; matches 2nd-order face quadrature)."""
    area_vec = 0.5 * np.cross(coords3[1] - coords3[0], coords3[2] - coords3[0])
    area = np.linalg.norm(area_vec)
    # Midpoint rule points (degree-2 exact), weights area/3 each.
    mids = 0.5 * np.array(
        [coords3[0] + coords3[1], coords3[1] + coords3[2], coords3[2] + coords3[0]]
    )
    # Shape values at edge midpoints
    Nvals = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
    fe = np.zeros((3, 3), dtype=np.float64)
    for q in range(3):
        trac = np.asarray(
            traction_fn(mids[q, 0], mids[q, 1], mids[q, 2]), dtype=np.float64
        )
        fe += np.outer(Nvals[q], trac) * (area / 3.0)
    return fe


def apply_surface_traction(f_nodes: np.ndarray, grid, nodes, traction_fn) -> np.ndarray:
    """Accumulate a surface traction into a (n_nodes, 3) host load array.

    Parity with `apply_surface_traction!` (FiniteElementAnalysis.jl:390-440):
    face Gauss quadrature of g(x,y,z) over the boundary facets spanned by the
    node set.
    """
    nodes_set = set(int(n) for n in nodes)
    coords = grid.node_coords
    if isinstance(grid, VoxelGrid):
        pairs, faces, conn = _voxel_boundary_facets(grid, nodes_set)
        for cell, lf in pairs:
            face_nodes = conn[cell, list(faces[lf])]
            fe = _quad_face_traction(coords[face_nodes], traction_fn)
            np.add.at(f_nodes, face_nodes, fe)
        return f_nodes
    # Unstructured: the mesh provides the facets' node lists.
    for face_nodes in grid.facet_node_lists(nodes_set):
        face_nodes = np.asarray(face_nodes, dtype=np.int64)
        if face_nodes.size == 3:
            fe = _tri_face_traction(coords[face_nodes], traction_fn)
        else:
            fe = _quad_face_traction(coords[face_nodes], traction_fn)
        np.add.at(f_nodes, face_nodes, fe)
    return f_nodes


def build_load_field(grid, loads: Sequence[AbstractLoadCondition]) -> np.ndarray:
    """Evaluate all static loads into a host float64 node-force array.

    Returns (nnx, nny, nnz, 3) for a VoxelGrid, (n_nodes, 3) otherwise.
    """
    f = np.zeros((grid.n_nodes, 3), dtype=np.float64)
    for load in loads:
        if isinstance(load, PointLoad):
            apply_force(f, grid, load.nodes, load.force_vector)
        elif isinstance(load, SurfaceTractionLoad):
            apply_surface_traction(f, grid, load.nodes, load.traction_fn)
        else:
            raise TypeError(
                f"Unsupported load condition {type(load)!r}; use PointLoad or "
                "SurfaceTractionLoad.")
    if not isinstance(grid, VoxelGrid):
        return f
    nnx, nny, nnz = grid.nnodes_per_axis
    return f.reshape(nnz, nny, nnx, 3).transpose(2, 1, 0, 3)


# ---------------------------------------------------------------------------
# Device-side variable-density body force (voxel path)
# ---------------------------------------------------------------------------

def voxel_body_force(rho_phys, accel, base_density, element_volume):
    """f_body node field from per-element density: rho_e * base_density *
    accel * integral(N_a) dOmega, with integral(N_a) = V/8 for a box element.

    Parity with `apply_variable_density_volume_force!`
    (FiniteElementAnalysis.jl:486-526) including its skip of cells with
    rho < 1e-6.  Runs on rho's device, in rho's dtype.
    """
    nx, ny, nz = rho_phys.shape
    accel = torch.as_tensor(accel, dtype=rho_phys.dtype,
                            device=rho_phys.device)
    w = torch.where(rho_phys < 1e-6, torch.zeros_like(rho_phys), rho_phys) \
        * (base_density * element_volume / 8.0)
    contrib = w[..., None] * accel
    out = rho_phys.new_zeros((nx + 1, ny + 1, nz + 1, 3))
    for dx, dy, dz in HEX_CORNERS:
        out[dx : dx + nx, dy : dy + ny, dz : dz + nz, :] += contrib
    return out
