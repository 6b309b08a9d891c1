"""easysimp_tpu_torch — the PyTorch / CUDA port of easysimp_tpu.

The voxel SIMP loop of the JAX package, run on tensors on a CUDA device
unless the caller asks for the CPU (`device="cpu"`).  On a CUDA device the
stiffness matvec and the element energies run as hand-written CUDA kernels
for sm_90a (ops/cuda_kernels.py); on the CPU their plain PyTorch versions
run.  The package imports torch, numpy and scipy, never jax: the JAX
package stays the reference that the tests hold the port against.

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
from .ops.elements import hex8_stiffness, lame_parameters, simp_youngs_modulus
from .ops.filters import VoxelFilter, create_filter_cache
from .ops.operator import VoxelOperator
from .opt.optimize import build_voxel_step, simp_optimize
from .stress import StressField, voxel_stresses
from .utils.terminal import (
    print_data,
    print_error,
    print_info,
    print_success,
    print_warning,
)

__version__ = "0.1.0"

__all__ = [
    "resolve_dtype",
    "VoxelGrid", "generate_grid",
    "OptimizationParameters", "OptimizationResult",
    "DirichletBC", "apply_fixed_boundary", "apply_sliding_boundary",
    "build_free_mask", "closest_node", "select_nodes_by_arc",
    "select_nodes_by_box", "select_nodes_by_circle",
    "select_nodes_by_cylinder", "select_nodes_by_plane",
    "AbstractLoadCondition", "PointLoad", "SurfaceTractionLoad",
    "apply_force", "apply_surface_traction", "build_load_field",
    "get_boundary_facets",
    "hex8_stiffness", "lame_parameters", "simp_youngs_modulus",
    "VoxelFilter", "create_filter_cache", "VoxelOperator",
    "build_voxel_step", "simp_optimize",
    "StressField", "voxel_stresses",
    "print_data", "print_error", "print_info", "print_success",
    "print_warning",
]
