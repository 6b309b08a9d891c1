"""easysimp_tpu_torch — the PyTorch / CUDA port of easysimp_tpu.

The SIMP loop of the JAX package, on voxel grids and on imported tet4/hex8
meshes, run on tensors on a CUDA device unless the caller asks for the CPU
(`device="cpu"`).  On a CUDA device the voxel stiffness matvec and element
energies run as hand-written CUDA kernels for sm_90a (ops/cuda_kernels.py);
on the CPU their plain PyTorch versions run.  The unstructured path
(mesh.py, ops/amg.py, opt/optimize_unstructured.py) is library tensor ops
on both, as the reference runs it outside any hand kernel.  Both run over
a device mesh too (`simp_optimize(mesh=...)`, parallel/).  The package
imports torch, numpy and scipy, never jax: the JAX package stays the
reference that the tests hold the port against.

Module names follow easysimp_tpu, so each port has its counterpart there.
"""

from .config import resolve_dtype
from .grids import VoxelGrid, generate_grid
from .params import OptimizationParameters, OptimizationResult
from .bcs import (
    DirichletBC,
    apply_fixed_boundary,
    apply_sliding_boundary,
    build_free_mask,
    closest_node,
    select_nodes_by_arc,
    select_nodes_by_box,
    select_nodes_by_circle,
    select_nodes_by_cylinder,
    select_nodes_by_plane,
)
from .loads import (
    AbstractLoadCondition,
    PointLoad,
    SurfaceTractionLoad,
    apply_force,
    apply_surface_traction,
    build_load_field,
    get_boundary_facets,
)
from .ops.elements import (
    create_material_model,
    create_simp_material_model,
    hex8_stiffness,
    lame_parameters,
    simp_youngs_modulus,
)
from .mesh import UnstructuredMesh, import_mesh, tet_mesh_from_grid
from .ops.filters import (
    FilterCacheTypes,
    UnstructuredFilter,
    VoxelFilter,
    create_filter_cache,
)
from .ops.operator import UnstructuredOperator, VoxelOperator
from .opt.optimize import build_voxel_step, simp_optimize
from .opt.optimize_unstructured import (
    build_unstructured_step,
    simp_optimize_unstructured,
)
from .opt.verify_sensitivities import verify_sensitivities
from .post.bc_export import export_boundary_conditions
from .post.vtu import create_results_data, export_results_vtu
from .stress import StressField, unstructured_stresses, voxel_stresses
from .utils.terminal import (
    print_data,
    print_error,
    print_info,
    print_success,
    print_warning,
)
from .utils.volume import calculate_element_volumes, calculate_volume

__version__ = "0.1.0"

__all__ = [
    "resolve_dtype",
    "VoxelGrid", "generate_grid", "setup_problem",
    "OptimizationParameters", "OptimizationResult",
    "DirichletBC", "apply_fixed_boundary", "apply_sliding_boundary",
    "build_free_mask", "closest_node", "select_nodes_by_arc",
    "select_nodes_by_box", "select_nodes_by_circle",
    "select_nodes_by_cylinder", "select_nodes_by_plane",
    "AbstractLoadCondition", "PointLoad", "SurfaceTractionLoad",
    "apply_force", "apply_surface_traction", "build_load_field",
    "get_boundary_facets",
    "create_material_model", "create_simp_material_model",
    "hex8_stiffness", "lame_parameters", "simp_youngs_modulus",
    "UnstructuredMesh", "import_mesh", "tet_mesh_from_grid",
    "VoxelFilter", "UnstructuredFilter", "FilterCacheTypes",
    "create_filter_cache", "VoxelOperator", "UnstructuredOperator",
    "build_voxel_step", "simp_optimize", "build_unstructured_step",
    "simp_optimize_unstructured", "verify_sensitivities",
    "StressField", "voxel_stresses", "unstructured_stresses",
    "create_results_data", "export_results_vtu",
    "export_boundary_conditions",
    "calculate_volume", "calculate_element_volumes",
    "print_data", "print_error", "print_info", "print_success",
    "print_warning",
]


def setup_problem(grid, interpolation_order: int = 1):
    """API-parity shim for the reference `setup_problem`
    (FiniteElementAnalysis.jl:130-157).  The array-first design needs no
    DofHandler/CellValues/sparse K; returns the grid itself so reference-style
    scripts keep their shape."""
    if interpolation_order != 1:
        raise NotImplementedError("only first-order elements are supported")
    print_success(f"FEM setup complete: {grid.n_dofs} DOFs")
    return grid
