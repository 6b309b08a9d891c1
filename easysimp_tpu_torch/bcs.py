"""Dirichlet boundary conditions and geometric node selection (numpy only;
port of easysimp_tpu/bcs.py).

Matrix-free, a BC is a 0/1 mask over node dofs: the operator becomes
A u = M K (M u) with identity on the constrained subspace, which preserves
SPD-ness.  Only homogeneous constraints
exist in the reference (`Dirichlet(:u, nodes, (x,t)->0.0, d)`), so masking is
exact.

Node selection predicates are vectorized numpy ports of
src/FiniteElementAnalysis/SelectNodesForBC.jl (O(n_nodes) scans become single
array expressions); node ids are 0-based.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "DirichletBC",
    "apply_fixed_boundary",
    "apply_sliding_boundary",
    "build_free_mask",
    "select_nodes_by_plane",
    "select_nodes_by_circle",
    "select_nodes_by_cylinder",
    "select_nodes_by_arc",
    "select_nodes_by_box",
    "closest_node",
]


@dataclass(frozen=True)
class DirichletBC:
    """Homogeneous Dirichlet constraint on `components` of `nodes`.

    components: subset of (0, 1, 2) = (X, Y, Z). The reference's
    `apply_fixed_boundary!` uses all three, `apply_sliding_boundary!` a
    user-chosen subset (FiniteElementAnalysis.jl:293-340).
    """

    nodes: np.ndarray
    components: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "nodes", np.asarray(sorted(set(np.asarray(self.nodes).tolist())),
                                      dtype=np.int64)
        )
        comps = tuple(sorted(set(int(c) for c in self.components)))
        if any(c not in (0, 1, 2) for c in comps):
            raise ValueError(f"components must be in (0,1,2), got {comps}")
        object.__setattr__(self, "components", comps)


def apply_fixed_boundary(grid, nodes) -> DirichletBC:
    """All three displacement components fixed to zero.

    Parity with `apply_fixed_boundary!` (FiniteElementAnalysis.jl:293-309);
    returns the constraint object to pass into `simp_optimize`.
    """
    return DirichletBC(nodes=np.asarray(list(nodes)), components=(0, 1, 2))


def apply_sliding_boundary(grid, nodes, fixed_components) -> DirichletBC:
    """Fix only the listed components (0=X, 1=Y, 2=Z).

    Parity with `apply_sliding_boundary!` (FiniteElementAnalysis.jl:326-340);
    note the reference uses 1-based (1=X,2=Y,3=Z) — this API is 0-based.
    """
    return DirichletBC(nodes=np.asarray(list(nodes)),
                       components=tuple(int(c) for c in fixed_components))


def build_free_mask(grid, bcs, dtype=np.float64) -> np.ndarray:
    """Build the free-dof mask (1 = free, 0 = constrained).

    For a VoxelGrid returns an (nnx, nny, nnz, 3) node-field mask; for an
    unstructured mesh a flat (3*n_nodes,) vector.
    """
    from .grids import VoxelGrid

    if not isinstance(grid, VoxelGrid):
        mask = np.ones(3 * grid.n_nodes, dtype=dtype)
        for bc in bcs:
            for c in bc.components:
                mask[3 * np.asarray(bc.nodes) + c] = 0.0
        return mask
    nnx, nny, nnz = grid.nnodes_per_axis
    mask = np.ones((nnx, nny, nnz, 3), dtype=dtype)
    for bc in bcs:
        ijk = grid.node_id_to_ijk(bc.nodes)
        for c in bc.components:
            mask[ijk[:, 0], ijk[:, 1], ijk[:, 2], c] = 0.0
    return mask


# ---------------------------------------------------------------------------
# Geometric node selection (vectorized ports of SelectNodesForBC.jl)
# ---------------------------------------------------------------------------

def _coords(grid) -> np.ndarray:
    return np.asarray(grid.node_coords, dtype=np.float64)


def select_nodes_by_plane(grid, point, normal, tolerance=1e-4) -> np.ndarray:
    """Nodes with |(x - p) . n_hat| < tolerance (SelectNodesForBC.jl:18-46)."""
    coords = _coords(grid)
    point = np.asarray(point, dtype=np.float64)
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    dist = np.abs((coords - point) @ n)
    return np.nonzero(dist < tolerance)[0].astype(np.int64)


def select_nodes_by_circle(grid, center, normal, radius, tolerance=1e-6) -> np.ndarray:
    """Nodes on the plane within in-plane distance radius+tol of center
    (SelectNodesForBC.jl:67-102)."""
    coords = _coords(grid)
    center = np.asarray(center, dtype=np.float64)
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    on_plane = np.abs((coords - center) @ n) < tolerance
    v = coords - center
    proj = v - np.outer(v @ n, n)
    in_radius = np.linalg.norm(proj, axis=1) <= radius + tolerance
    return np.nonzero(on_plane & in_radius)[0].astype(np.int64)


def select_nodes_by_cylinder(grid, axis_point, axis_direction, radius,
                             tolerance=1e-4) -> np.ndarray:
    """Nodes ON the cylindrical surface: |radial_dist - r| < tol
    (SelectNodesForBC.jl:123-153)."""
    coords = _coords(grid)
    p = np.asarray(axis_point, dtype=np.float64)
    a = np.asarray(axis_direction, dtype=np.float64)
    a = a / np.linalg.norm(a)
    v = coords - p
    radial = v - np.outer(v @ a, a)
    rdist = np.linalg.norm(radial, axis=1)
    return np.nonzero(np.abs(rdist - radius) < tolerance)[0].astype(np.int64)


def select_nodes_by_arc(grid, center, axis, radius, angle_start, angle_end,
                        tolerance=1e-4) -> np.ndarray:
    """Nodes on a cylindrical arc; angles in degrees CCW with wraparound
    (SelectNodesForBC.jl:167-225)."""
    coords = _coords(grid)
    center = np.asarray(center, dtype=np.float64)
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    # Reference in-plane axes (same construction as the reference)
    if abs(a[2]) > 0.9:
        ref_x = np.array([1.0, 0.0, 0.0]) - np.dot([1.0, 0.0, 0.0], a) * a
    else:
        ref_x = np.cross([0.0, 0.0, 1.0], a)
    ref_x = ref_x / np.linalg.norm(ref_x)
    ref_y = np.cross(a, ref_x)

    v = coords - center
    radial = v - np.outer(v @ a, a)
    rdist = np.linalg.norm(radial, axis=1)
    on_surface = np.abs(rdist - radius) < tolerance

    safe = np.where(rdist > 0, rdist, 1.0)
    vn = radial / safe[:, None]
    ang = np.degrees(np.arctan2(vn @ ref_y, vn @ ref_x))
    ang = np.where(ang < 0, ang + 360.0, ang)
    if angle_start <= angle_end:
        in_range = (ang >= angle_start) & (ang <= angle_end)
    else:
        in_range = (ang >= angle_start) | (ang <= angle_end)
    return np.nonzero(on_surface & in_range)[0].astype(np.int64)


def select_nodes_by_box(grid, min_corner, max_corner, tolerance=1e-9) -> np.ndarray:
    """Nodes inside an axis-aligned box (convenience used by several reference
    examples as raw coordinate-predicate loops, e.g.
    test/Examples/05_3D_2x1x1_4Legs.jl:54-73)."""
    coords = _coords(grid)
    lo = np.asarray(min_corner, dtype=np.float64) - tolerance
    hi = np.asarray(max_corner, dtype=np.float64) + tolerance
    inside = np.all((coords >= lo) & (coords <= hi), axis=1)
    return np.nonzero(inside)[0].astype(np.int64)


def closest_node(grid, point) -> int:
    """Index of the node closest to `point` — the reference examples' fallback
    when a selection comes back empty (test/runtests.jl:45-58)."""
    coords = _coords(grid)
    d = np.linalg.norm(coords - np.asarray(point, dtype=np.float64), axis=1)
    return int(np.argmin(d))
