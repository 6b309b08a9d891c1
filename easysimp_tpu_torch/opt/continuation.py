"""Coarse-to-fine continuation for voxel SIMP runs.

Port of easysimp_tpu/opt/continuation.py (no analogue in EasySIMP.jl, which
always starts from the uniform volume-fraction design,
src/Optimization/Optimization.jl:222).  A cold run spends its first
iterations at the full move limit with high CG counts, because the uniform
design has no structure for the warm start, subspace recycling or adaptive
forcing to exploit.  Running the SAME problem at half (or quarter...)
resolution first and prolonging the result onto the fine grid starts the
fine trajectory at developed contrast.

Design prolongation is piecewise-constant 2x injection (each coarse cell
fills its 2x2x2 fine children), which preserves the volume fraction
EXACTLY; displacement prolongation is the multigrid trilinear `prolong`
(ops/multigrid.py), whose coarse-lattice nodes coincide with even fine
nodes, so homogeneous Dirichlet planes stay satisfied.

Loads and BCs are remapped onto the coarse grid by snapping node indices:
fine node (i, j, k) -> coarse node (round(i/2), round(j/2), round(k/2)),
deduplicated.  PointLoad keeps its TOTAL force (the equal split just runs
over the mapped set); SurfaceTractionLoad keeps its position-dependent
traction_fn (the physical domain is identical); DirichletBC keeps its
component set.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..bcs import DirichletBC
from ..config import resolve_dtype
from ..grids import VoxelGrid, generate_grid
from ..loads import PointLoad, SurfaceTractionLoad
from ..ops.multigrid import prolong
from ..utils.terminal import print_info

__all__ = ["coarsen_problem", "prolong_design", "prolong_displacement",
           "continuation_init"]


def _snap_nodes(grid: VoxelGrid, coarse: VoxelGrid, nodes) -> np.ndarray:
    """Map fine node ids onto the coarse lattice by index rounding."""
    ijk = grid.node_id_to_ijk(np.asarray(nodes, dtype=np.int64))
    cijk = np.rint(ijk / 2.0).astype(np.int64)
    lim = np.asarray(coarse.nnodes_per_axis, dtype=np.int64) - 1
    cijk = np.clip(cijk, 0, lim)
    return np.unique(coarse.node_ijk_to_id(cijk))


def coarsen_problem(grid: VoxelGrid, loads, bcs):
    """Half-resolution (grid, loads, bcs) for the same physical problem.

    Requires every grid dimension to be even.  Raises ValueError on load
    types that cannot be remapped automatically.
    """
    nels = grid.nels
    if any(n % 2 for n in nels):
        raise ValueError(f"continuation needs even grid dims, got {nels}")
    corner0 = tuple(grid.origin)
    corner1 = tuple(o + n * h for o, n, h in
                    zip(grid.origin, nels, grid.spacing))
    coarse = generate_grid(tuple(n // 2 for n in nels), corner0, corner1)
    closs = []
    for ld in loads:
        if isinstance(ld, PointLoad):
            closs.append(PointLoad(_snap_nodes(grid, coarse, ld.nodes),
                                   ld.force_vector))
        elif isinstance(ld, SurfaceTractionLoad):
            closs.append(SurfaceTractionLoad(
                _snap_nodes(grid, coarse, ld.nodes), ld.traction_fn))
        else:
            raise ValueError(
                f"continuation cannot remap load type {type(ld).__name__}")
    cbcs = [DirichletBC(_snap_nodes(grid, coarse, bc.nodes), bc.components)
            for bc in bcs]
    return coarse, closs, cbcs


def prolong_design(design_c):
    """Coarse cell field (nx, ny, nz) -> fine (2nx, 2ny, 2nz), piecewise-
    constant injection — exactly volume-preserving."""
    for axis in range(3):
        design_c = design_c.repeat_interleave(2, dim=axis)
    return design_c


def prolong_displacement(u_c):
    """Coarse node field (ncx+1, ncy+1, ncz+1, 3) -> fine, trilinear."""
    return prolong(u_c)


def continuation_init(grid, loads, bcs, params, acceleration_data=None,
                      device="cuda"):
    """Run the coarse problem on `device` and return (design0, u0) for the
    fine grid, as tensors there.

    Recurses params.continuation_levels times (each level halves the
    resolution); each coarse stage runs params.continuation_iters SIMP
    iterations (or to params.tolerance, whichever first).  The coarse
    stages inherit every solver knob from `params` but never export,
    checkpoint, or profile.
    """
    from .optimize import simp_optimize

    coarse, closs, cbcs = coarsen_problem(grid, loads, bcs)
    cparams = replace(
        params,
        continuation_levels=params.continuation_levels - 1,
        max_iterations=params.continuation_iters,
        export_interval=0, export_path="", tolerance_checkpoints=[],
        checkpoint_interval=0, checkpoint_path="", profile_dir="",
    )
    print_info(
        f"Continuation: level-{params.continuation_levels} coarse stage "
        f"{coarse.nels} ({cparams.max_iterations} iterations max)")
    res = simp_optimize(coarse, closs, cbcs, cparams,
                        acceleration_data=acceleration_data, device=device)
    dtype = resolve_dtype(params.dtype, device)
    design_c = torch.as_tensor(res.densities_3d, dtype=dtype, device=device)
    # invert dofs_flat: flat x-fastest dofs -> (nnx, nny, nnz, 3)
    nnx, nny, nnz = coarse.nnodes_per_axis
    u_c = torch.as_tensor(
        np.ascontiguousarray(
            np.asarray(res.displacements).reshape(nnz, nny, nnx, 3)
            .transpose(2, 1, 0, 3)), dtype=dtype, device=device)
    return prolong_design(design_c), prolong_displacement(u_c)
