"""Optimization parameters and result containers.

Field for field the same as easysimp_tpu/params.py, so that `carry.py` can
copy a reference parameter object by attribute.  On one device every field
acts as in the reference; the AMG knobs belong to the unstructured path
(ops/amg.py), the mg_* knobs to the voxel path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["OptimizationParameters", "OptimizationResult"]


@dataclass
class OptimizationParameters:
    """SIMP optimization parameters (defaults match Optimization.jl:86-103)."""

    # Material
    E0: float = 1.0
    Emin: float = 1e-9
    nu: float = 0.3
    p: float = 3.0

    # Optimization
    volume_fraction: float = 0.5
    max_iterations: int = 200
    tolerance: float = 0.01

    # Filter
    filter_radius: float = 1.5          # x characteristic element size
    filter_type: str = "sensitivity"    # "sensitivity" | "density"

    # OC
    move_limit: float = 0.2
    damping: float = 0.5

    use_cache: bool = True              # kept for API parity; always cached

    # Variable-material interpolation rho -> (lam, mu), a closure on
    # tensors that `torch.func.jvp` can differentiate (the reference's
    # use_cache=false branch); None = the SIMP law with constant nu.
    material_model: object = None

    # Intermediate export: <export_path>/iter_NNNN.vtu every
    # export_interval iterations, final_results_XXtol.vtu when the change
    # first falls below each of tolerance_checkpoints; the CSV log and the
    # summary go to export_path as well
    export_interval: int = 0
    export_path: str = ""
    task_name: str = "SIMP_Optimization"
    tolerance_checkpoints: list[float] = field(default_factory=list)

    # --- solver knobs (no reference analogue: CHOLMOD was exact) ---
    dtype: str = "auto"                 # "auto" | "float32" | "float64"
    cg_rtol: float = 1e-8               # relative residual for the CG solve
    cg_maxiter: int = 20000
    cg_recycle_k: int = 0               # ring of the last k solutions whose
                                        # deltas deflate the warm-start
                                        # residual (ops/cg.py); 0 = off
    cg_recycle_dtype: str = ""          # storage dtype of the ring;
                                        # "" = operator dtype
    cg_forcing: str = "fixed"           # "fixed" | "adaptive": adaptive sets
                                        #   rtol_i = clip(coeff * change_{i-1},
                                        #                 cg_rtol, cg_rtol_max)
                                        # (first iteration uses cg_rtol_max)
    cg_rtol_max: float = 1e-3           # loosest adaptive tolerance
    cg_forcing_coeff: float = 0.05      # rtol_i = coeff * change_{i-1}
    preconditioner: str = "auto"        # auto|jacobi|block_jacobi|amg|multigrid|none

    # Unstructured AMG knobs (ops/amg.py: the coarsest dense level's size
    # bound; smoothed-aggregation transfers rebuilt every iteration) and
    # the voxel geometric multigrid's knobs (ops/multigrid.py)
    amg_max_coarse_dofs: int = 6000
    amg_smooth_prolongator: bool = False
    mg_levels: int = 0
    mg_smooth_iters: object = (1, 3)
    mg_cycle_dtype: str = ""
    mg_stencil_dtype: str = ""
    mg_galerkin: bool = True
    mg_coarsen: str = "arithmetic"
    mg_refresh_iters: int = 2
    mg_setup_every: int = 1
    mg_full_setup_every: int = 1
    mg_cycle: str = "v"
    use_pallas_matvec: bool = True      # ignored: CUDA tensors always take
                                        # the hand-written kernels

    # Coarse-to-fine continuation (opt/continuation.py): start from the
    # prolonged result of continuation_levels half-resolution stages of
    # continuation_iters iterations each; 0 = off
    continuation_levels: int = 0
    continuation_iters: int = 40

    # Checkpoint every checkpoint_interval iterations into checkpoint_path
    # (opt/checkpoint.py); profile_dir: a torch.profiler chrome trace of
    # iterations 2-4 is written there
    checkpoint_interval: int = 0
    checkpoint_path: str = ""
    profile_dir: str = ""

    def __post_init__(self):
        if self.filter_type not in ("sensitivity", "density"):
            raise ValueError(
                f"filter_type must be 'sensitivity' or 'density', got "
                f"{self.filter_type!r}"
            )
        if self.preconditioner not in ("auto", "jacobi", "block_jacobi",
                                       "amg", "multigrid", "none"):
            raise ValueError(f"unknown preconditioner {self.preconditioner!r}")


@dataclass
class OptimizationResult:
    """Final design and history (parity: Optimization.jl:145-155)."""

    densities: np.ndarray          # final PHYSICAL densities (flat, x-fastest)
    displacements: np.ndarray      # final displacement dof vector (flat)
    stresses: object               # StressField: cell -> qp stress tensors
    energy: float
    volume: float
    iterations: int
    converged: bool
    energy_history: list[float]
    volume_history: list[float]

    # extras (not in the reference result)
    densities_3d: np.ndarray | None = None   # (nx, ny, nz) for voxel grids
    cg_iterations_history: list[int] = field(default_factory=list)
    change_history: list[float] = field(default_factory=list)
    element_energies: np.ndarray | None = None  # 0.5*E(rho)*u_e^T ke u_e, flat
    iteration_seconds: list[float] = field(default_factory=list)  # host
                                   # wall time of each SIMP iteration
