"""The SIMP optimization loop (voxel grids).

Port of `build_voxel_step` and `simp_optimize` (easysimp_tpu/opt/optimize.py
:215, :527).  One SIMP iteration: density filter -> matrix-free PCG solve ->
compliance -> sensitivities -> filter -> OC bisection -> convergence metric.
PyTorch runs eagerly, so the iteration is one Python function on tensors
that live on the chosen device.

Iteration semantics match the reference:
  * initial design = fill(volume_fraction)             (Optimization.jl:222)
  * energy logged for the PRE-update design             (:317-324)
  * change = max|new_design - old_design| in DESIGN space (:374)
  * convergence break AFTER logging                     (:484-488)
  * final analysis: re-filter, re-solve, stress recovery (:494-539)

Preconditioners: "jacobi" and "none"; "block_jacobi" and "amg" fall through
to Jacobi on voxel grids, as in the reference.  Geometric multigrid
("auto", "multigrid") is not ported yet and raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..bcs import build_free_mask
from ..config import resolve_dtype
from ..grids import VoxelGrid
from ..loads import build_load_field, voxel_body_force
from ..ops.cg import cg_solve, recycle_deflate, recycle_init, recycle_push
from ..ops.filters import create_filter_cache
from ..ops.oc import (
    MAX_BISECTION,
    host_median_abs,
    oc_update,
    sensitivity_health,
)
from ..ops.operator import VoxelOperator
from ..params import OptimizationParameters, OptimizationResult
from ..stress import voxel_stresses
from ..utils.terminal import (
    print_data,
    print_info,
    print_success,
    print_warning,
)

__all__ = ["simp_optimize", "build_voxel_step", "VoxelStep"]

_MULTIGRID_TODO = ("geometric multigrid (preconditioner='auto' or "
                   "'multigrid') is not ported yet (ROADMAP.md, queue 1: "
                   "stencil + multigrid); use preconditioner='jacobi'")


def _warn_sensitivity_health(frac_neg, max_abs, fsens) -> bool:
    """The reference's three health warnings (OptimalityCriteria.jl:19-40):
    <50% negative, median effectively zero, max/median > 1e8.  Returns True
    if a warning fired (simp_optimize warns once, not per iteration)."""
    if frac_neg < 0.5:
        print_warning(
            "Less than 50% of sensitivities are negative. Check if "
            "energy sensitivities are computed correctly."
        )
        return True
    med = host_median_abs(fsens)
    if med < np.finfo(np.float64).eps:
        print_warning(f"Sensitivities are effectively zero (median: {med}).")
        return True
    if max_abs / med > 1e8:
        print_warning(
            f"Sensitivity range too large (max/median: {max_abs / med:.3e})."
            " Check problem scaling."
        )
        return True
    return False


def _build_preconditioner(op, params):
    """factory(scale, free_mask) -> M(r)."""
    choice = params.preconditioner
    if choice in ("auto", "multigrid"):
        raise NotImplementedError(_MULTIGRID_TODO)
    if choice == "none":
        return lambda scale, mask: (lambda r: r)

    def jacobi_factory(scale, mask):
        diag = op.diagonal(scale, mask)
        return lambda r: r / diag

    return jacobi_factory


@dataclass
class StepOutput:
    """What one SIMP iteration returns (tensors stay on the device)."""

    new_design: torch.Tensor
    u: torch.Tensor
    phys: torch.Tensor
    energy: torch.Tensor
    volume: torch.Tensor
    lam: float
    cg_iters: int
    cg_residual: float
    bisect_iters: int
    bisect_verr: float
    fsens: torch.Tensor


@dataclass
class VoxelStep:
    """The SIMP iteration and its companion state.

    `step(design, u_prev, recycle=None, rtol=None)` runs one full SIMP
    iteration; `solve(design)` is the final re-analysis; `metrics` the
    convergence and diagnostic reductions."""

    grid: VoxelGrid
    op: VoxelOperator
    filt: Any
    step: Callable
    metrics: Callable
    solve: Callable
    element_energy: Callable
    design0: torch.Tensor
    u0: torch.Tensor
    vol_sens: torch.Tensor
    elem_vol: float
    total_volume: float
    dtype: torch.dtype
    device: torch.device


def build_voxel_step(grid, loads, boundary_conditions,
                     params: OptimizationParameters, acceleration_data=None,
                     device="cuda") -> VoxelStep:
    """Build the SIMP iteration for a voxel problem on `device`."""
    if params.material_model is not None:
        raise NotImplementedError(
            "material_model (the two-field Lame path) is not ported yet")
    device = torch.device(device)
    dtype = resolve_dtype(params.dtype, device)
    elem_vol = grid.element_volume
    total_volume = grid.total_volume

    op = VoxelOperator(grid, E0=params.E0, Emin=params.Emin, nu=params.nu,
                       p=params.p, dtype=dtype, device=device)
    filt = create_filter_cache(grid, params.filter_radius, dtype=dtype,
                               device=device)
    use_density_filter = params.filter_type == "density"
    precond_factory = _build_preconditioner(op, params)

    def dev(a):
        # contiguous: build_load_field returns a transposed view, and a
        # strided right-hand side would make every CG field strided
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    free_mask = dev(build_free_mask(grid, boundary_conditions))
    f_ext = dev(build_load_field(grid, loads))
    if acceleration_data is not None:
        accel_vec, base_density = acceleration_data

    # Volume sensitivities: geometry-only, chain-ruled ONCE for the density
    # filter (Optimization.jl:241-248).
    vol_sens_physical = torch.full(grid.nels, elem_vol / total_volume,
                                   dtype=dtype, device=device)
    vol_sens = (filt.chain_rule(vol_sens_physical) if use_density_filter
                else vol_sens_physical)
    design0 = torch.full(grid.nels, params.volume_fraction, dtype=dtype,
                         device=device)
    u0 = torch.zeros((*grid.nnodes_per_axis, 3), dtype=dtype, device=device)

    def forward(design, u_prev, recycle=None, rtol=None):
        """filter -> loads -> solve -> energy/volume."""
        phys = filt.density_filter(design) if use_density_filter else design
        scale = op.youngs_modulus(phys)
        f = f_ext
        if acceleration_data is not None:
            f = f + voxel_body_force(phys, accel_vec, base_density, elem_vol)
        f_bc = f * free_mask
        sol = cg_solve(lambda v: op.apply(v, scale, free_mask), f_bc,
                       x0=u_prev * free_mask,
                       M=precond_factory(scale, free_mask),
                       rtol=params.cg_rtol if rtol is None else rtol,
                       maxiter=params.cg_maxiter,
                       deflate=recycle_deflate(free_mask, recycle))
        # 0.5 u^T K u without an extra matvec: K u = f - r at the CG exit.
        energy = 0.5 * (torch.dot(sol.u.reshape(-1), f_bc.reshape(-1))
                        - sol.u_dot_r)
        volume = phys.sum() * elem_vol
        return phys, sol, energy, volume

    def step(design, u_prev, recycle=None, rtol=None) -> StepOutput:
        phys, sol, energy, volume = forward(design, u_prev, recycle, rtol)
        sens = op.compliance_sensitivities(sol.u, phys)
        if use_density_filter:
            fsens = filt.chain_rule(sens)
        else:
            fsens = filt.sensitivity_filter(design, sens)
        # volume_weights = H^T V = total_volume * vsens for both filter
        # types (see ops/oc.py).
        new_design, lam, bisect_iters, bisect_verr = oc_update(
            design, fsens, vol_sens, params.volume_fraction, total_volume,
            vol_sens * total_volume, params.move_limit, params.damping)
        return StepOutput(new_design, sol.u, phys, energy, volume, lam,
                          sol.iterations, sol.residual_norm, bisect_iters,
                          bisect_verr, fsens)

    def metrics(new_design, design, phys, u, fsens):
        """(change, grayness, max_disp, frac_neg, mean_abs, max_abs)."""
        change = (new_design - design).abs().max()
        grayness = ((phys > 0.1) & (phys < 0.9)).to(dtype).mean()
        max_disp = u.abs().max()
        return (change, grayness, max_disp, *sensitivity_health(fsens))

    def solve(design):
        """Final analysis (Optimization.jl:494-539): re-filter + re-solve
        from a cold start."""
        phys, sol, energy, _ = forward(design, torch.zeros_like(u0))
        return phys, sol.u, energy

    def element_energy(phys, u):
        """0.5 * u_e^T K_e u_e element field (PostProcessing.jl:172-197)."""
        return 0.5 * op.youngs_modulus(phys) * op.element_energies_unit(u)

    return VoxelStep(
        grid=grid, op=op, filt=filt, step=step, metrics=metrics, solve=solve,
        element_energy=element_energy, design0=design0, u0=u0,
        vol_sens=vol_sens, elem_vol=elem_vol, total_volume=total_volume,
        dtype=dtype, device=device)


def _check_ported(params, mesh, resume_from):
    missing = []
    if params.export_interval > 0 or params.tolerance_checkpoints:
        missing.append("VTU exports (export_interval, tolerance_checkpoints)")
    if params.continuation_levels > 0:
        missing.append("continuation_levels")
    if params.checkpoint_path or params.checkpoint_interval > 0 \
            or resume_from:
        missing.append("checkpoint_path / resume_from")
    if params.profile_dir:
        missing.append("profile_dir")
    if mesh is not None:
        missing.append("mesh (multi-device)")
    if missing:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(missing)
            + " (see ROADMAP.md, queue 1)")


def simp_optimize(grid, loads, boundary_conditions,
                  params: OptimizationParameters, acceleration_data=None,
                  mesh=None, resume_from=None, *,
                  device="cuda") -> OptimizationResult:
    """Run SIMP topology optimization on a voxel grid.

    Args:
      grid: VoxelGrid.
      loads: list of PointLoad / SurfaceTractionLoad.
      boundary_conditions: list of DirichletBC.
      params: OptimizationParameters.
      acceleration_data: optional (acceleration_vector, base_density) for
        variable-density body forces (Optimization.jl:195-198, 301-311).
      mesh, resume_from: not ported yet; must be None.
      device: where every tensor lives, "cuda[:N]" (the default) or "cpu".
        CUDA runs the operator through the hand-written kernels; without a
        CUDA device the default raises, and the CPU runs only when asked
        for.
    """
    if not isinstance(grid, VoxelGrid):
        raise NotImplementedError("unstructured meshes are not ported yet")
    _check_ported(params, mesh, resume_from)
    if params.cg_forcing not in ("fixed", "adaptive"):
        raise ValueError(f"cg_forcing must be 'fixed' or 'adaptive', "
                         f"got {params.cg_forcing!r}")

    print_info("Starting SIMP topology optimization (voxel path)")
    logger = None
    if params.export_path:
        from .logger import OptimizationLogger

        logger = OptimizationLogger(params.export_path, params.task_name)
    if acceleration_data is not None:
        print_info(
            f"Variable density acceleration enabled: {acceleration_data[0]}")
    print_data(f"Total mesh volume: {grid.total_volume}")

    vs = build_voxel_step(grid, loads, boundary_conditions, params,
                          acceleration_data, device=device)
    total_volume, elem_vol = vs.total_volume, vs.elem_vol
    design, u = vs.design0, vs.u0

    # Subspace-recycled CG: ring buffer of the last k solutions, whose
    # deltas deflate the warm-start residual (ops/cg.py).
    recycle_k = params.cg_recycle_k
    rhist = None
    if recycle_k > 1:
        recycle_dtype = (resolve_dtype(params.cg_recycle_dtype, vs.device)
                         if params.cg_recycle_dtype else None)
        rhist = recycle_init(recycle_k, u, dtype=recycle_dtype)

    # Adaptive CG forcing: the tolerance follows how fast the design moves.
    adaptive_forcing = params.cg_forcing == "adaptive"

    def _forcing_rtol(change_prev):
        if change_prev is None:
            return params.cg_rtol_max
        return min(params.cg_rtol_max,
                   max(params.cg_rtol, params.cg_forcing_coeff * change_prev))

    rtol_now = _forcing_rtol(None) if adaptive_forcing else None
    energy_history: list[float] = []
    volume_history: list[float] = []
    change_history: list[float] = []
    cg_history: list[int] = []
    iteration_seconds: list[float] = []
    converged = False
    iteration = 0
    warned_health = False
    warned_bisection = False

    for it in range(1, params.max_iterations + 1):
        iteration = it
        t0 = time.perf_counter()
        out = vs.step(design, u, recycle=rhist, rtol=rtol_now)
        if rhist is not None:
            rhist = recycle_push(rhist, out.u)
        (change, grayness, max_disp, frac_neg, _mean_abs, max_abs) = \
            vs.metrics(out.new_design, design, out.phys, out.u, out.fsens)
        u = out.u

        energy = float(out.energy)
        volume = float(out.volume)
        change = float(change)
        if adaptive_forcing:
            rtol_now = _forcing_rtol(change)
        vol_frac = volume / total_volume
        energy_history.append(energy)
        volume_history.append(volume)
        change_history.append(change)
        cg_history.append(out.cg_iters)
        # float() above waited for the device: this is the iteration's time
        iteration_seconds.append(time.perf_counter() - t0)

        # Sensitivity health warnings, warn once (OptimalityCriteria.jl
        # :19-40); the median comes from a host-side subsample.
        if not warned_health and (it == 1 or it % 10 == 0):
            warned_health = _warn_sensitivity_health(
                float(frac_neg), float(max_abs), out.fsens)

        # OC bisection non-convergence warning, only when all 200 bisection
        # iterations exhaust without meeting the tolerance
        # (OptimalityCriteria.jl:139-142); warn once.
        if not warned_bisection and out.bisect_iters >= MAX_BISECTION \
                and abs(out.bisect_verr) >= 1e-6:
            print_warning(
                f"OC bisection did not converge after {out.bisect_iters} "
                f"iterations (|volume error| = {abs(out.bisect_verr):.3e})")
            warned_bisection = True

        if logger is not None:
            logger.log_iteration(it, energy, vol_frac, change, out.lam,
                                 float(grayness), float(max_disp))

        print(
            f"Iter {it:4d} | Energy: {energy:.4e} | Vol.Frac: {vol_frac:.4f} "
            f"| Change: {change:.4e} | CG: {out.cg_iters:4d}"
        )

        design = out.new_design
        if change < params.tolerance:
            print_success(f"Converged after {it} iterations")
            converged = True
            break

    # ----- final analysis (Optimization.jl:494-539) -------------------------
    phys, u, final_energy = vs.solve(design)
    final_energy = float(final_energy)
    final_volume = float(phys.sum()) * elem_vol

    stresses = voxel_stresses(grid, u, phys, params.E0, params.Emin,
                              params.nu, params.p)
    print_data(
        f"Maximum von Mises stress: {stresses.max_von_mises} "
        f"at cell {stresses.max_vm_cell}"
    )
    # 0.5 * integral(sigma:eps) per cell == 0.5 * u_e^T K_e u_e
    elem_energies = grid.cells_flat(
        vs.element_energy(phys, u).cpu().double().numpy())

    if logger is not None:
        logger.write_summary(final_energy, final_volume, converged)
        logger.close()

    print_success("Optimization completed")
    print_data(f"Final energy: {final_energy}")
    print_data(f"Final volume fraction: {final_volume / total_volume}")

    phys_np = phys.cpu().double().numpy()
    return OptimizationResult(
        densities=grid.cells_flat(phys_np),
        displacements=grid.dofs_flat(u.cpu().double().numpy()),
        stresses=stresses,
        energy=final_energy,
        volume=final_volume,
        iterations=iteration,
        converged=converged,
        energy_history=energy_history,
        volume_history=volume_history,
        densities_3d=phys_np,
        cg_iterations_history=cg_history,
        change_history=change_history,
        element_energies=elem_energies,
        iteration_seconds=iteration_seconds,
    )
