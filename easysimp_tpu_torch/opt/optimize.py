"""The SIMP optimization loop (voxel grids; `simp_optimize` hands an
UnstructuredMesh to opt/optimize_unstructured.py).

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

Preconditioners: geometric multigrid ("multigrid", and "auto" when the grid
has a coarser level; ops/multigrid.py), "jacobi" and "none"; "block_jacobi"
and "amg" fall through to Jacobi on voxel grids, as in the reference.

A `material_model` (a rho -> (lam, mu) closure on tensors) replaces the
SIMP law: CG applies the two-field Lamé operator (two kernel launches per
matvec), the sensitivities are the exact material derivative by
`torch.func.jvp`, and the preconditioner is built on the equivalent modulus
mu(rho) / mu_unit through the ordinary operator.

Around the loop, as in the reference: coarse-to-fine continuation
(opt/continuation.py), checkpoint save and resume (opt/checkpoint.py),
interval and tolerance VTU exports (post/vtu.py) and a `torch.profiler`
trace of iterations 2-4 (`profile_dir`).  The reference's split of the
iteration into several programs is a TPU matter and has no counterpart.

Under a device mesh (`mesh=`, parallel/sharding.py `make_mesh`) the same
iteration runs on sharded fields: the operator, filter and multigrid are
their halo-exchanging twins (parallel/), every other step is this file's
code on fields whose elementwise ops run per shard and whose reductions are
global.  Results, histories and checkpoints are in the global layout.

Multigrid carries state across iterations (easysimp_tpu/opt/optimize.py
:720-819): per-level power vectors, estimated cold once before the loop and
refreshed by every setup; and the V-cycle state, rebuilt every
`mg_setup_every` iterations (in full every `mg_full_setup_every`, the
fine half only in between) or at once when the last solve's CG count grew
past 1.5x (and +3) of the count after the last full setup.  The reference
runs that as separate programs; here it is one eager loop.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..bcs import build_free_mask
from ..config import resolve_dtype
from ..grids import VoxelGrid
from ..loads import build_load_field, voxel_body_force
from ..ops.cg import (
    _vdot,
    cg_solve,
    recycle_deflate,
    recycle_init,
    recycle_push,
)
from ..ops.filters import create_filter_cache
from ..ops.multigrid import MultigridPreconditioner
from ..ops.oc import (
    MAX_BISECTION,
    host_median_abs,
    oc_update,
    sensitivity_health,
)
from ..ops.operator import VoxelOperator
from ..parallel.sharded_step import material_derivative
from ..parallel.sharding import mesh_device
from ..params import OptimizationParameters, OptimizationResult
from ..stress import voxel_stresses
from ..utils.terminal import (
    print_data,
    print_info,
    print_success,
    print_warning,
)

__all__ = ["simp_optimize", "build_voxel_step", "VoxelStep"]


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


class DiagonalPreconditioner:
    """Jacobi (M = D^-1) or "none" (M = I) behind the multigrid's
    interface: the state is the operator diagonal (None for "none") and
    there are no power vectors to carry."""

    supports_light_setup = False

    def __init__(self, op: VoxelOperator, jacobi: bool = True):
        self.op = op
        self.jacobi = jacobi

    def init_power_vectors(self):
        return ()

    def power_init(self, scale, free_mask):
        return ()

    def setup(self, scale, free_mask, power_vectors=()):
        diag = self.op.diagonal(scale, free_mask) if self.jacobi else None
        return diag, power_vectors

    def make_M(self, diag):
        if diag is None:
            return lambda r: r
        return lambda r: r / diag


def _build_preconditioner(op, params):
    """(preconditioner, setup_every).  Both kinds have power_init(scale,
    mask) -> power vectors, setup(scale, mask, power_vectors) -> (state,
    power vectors) and make_M(state) -> M(r).  Multigrid refreshes its state
    every `mg_setup_every` iterations; Jacobi and "none" every iteration.
    "auto" resolves to multigrid when the grid has a coarser level, else to
    Jacobi; "multigrid" without one warns and falls back to Jacobi
    (easysimp_tpu/opt/optimize.py:84-126)."""
    choice = params.preconditioner
    if choice in ("auto", "multigrid"):
        def dtype(name):
            return resolve_dtype(name, op.device) if name else None

        mg_class = MultigridPreconditioner
        if hasattr(op, "layout"):  # a HaloVoxelOperator: the sharded cycle
            from ..parallel.sharded_multigrid import ShardedMultigrid

            mg_class = ShardedMultigrid
        mg = mg_class(
            op, levels=params.mg_levels, smooth_iters=params.mg_smooth_iters,
            cycle_dtype=dtype(params.mg_cycle_dtype),
            galerkin=params.mg_galerkin, cycle=params.mg_cycle,
            coarsen=params.mg_coarsen,
            stencil_dtype=dtype(params.mg_stencil_dtype),
            refresh_iters=params.mg_refresh_iters)
        if mg.n_levels > 1:
            return mg, params.mg_setup_every
        if choice == "multigrid":
            print_warning(
                "multigrid requested but grid has no coarsenable levels; "
                "falling back to Jacobi"
            )
    return DiagonalPreconditioner(op, jacobi=choice != "none"), 1


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

    `power_init(design)` is the cold estimation of the carried power
    vectors (multigrid; () otherwise), and `setup(design, pvecs,
    prev_state=None)` returns (state, new pvecs) of `precond`: a full
    setup, or multigrid's light one on top of `prev_state`, due every
    `setup_every` iterations.  `step(design, u_prev, state, recycle=None,
    rtol=None)` runs one full SIMP iteration with that state; `solve(design,
    pvecs)` is the final re-analysis; `metrics` the convergence and
    diagnostic reductions."""

    grid: VoxelGrid
    op: VoxelOperator
    filt: Any
    precond: MultigridPreconditioner | DiagonalPreconditioner
    setup_every: int
    power_init: Callable
    setup: Callable
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
    layout: Any = None    # parallel.sharding.GridLayout under a device mesh

    def place(self, a, kind):
        """A global array or tensor ("cell" or "node" field) as the step
        holds it: on the device, or split over the mesh."""
        return _place(a, kind, self.dtype, self.device, self.layout)

    def gather(self, t):
        """A field as one tensor on the (first) device."""
        return t if isinstance(t, torch.Tensor) else self.layout.gather(t)


def _place(a, kind, dtype, device, layout):
    if not isinstance(a, torch.Tensor):
        # contiguous: build_load_field returns a transposed view, and a
        # strided right-hand side would make every CG field strided
        a = torch.as_tensor(np.ascontiguousarray(a))
    if layout is not None:
        return layout.split(a.to(dtype), kind)
    return a.to(dtype=dtype, device=device).contiguous()


def build_voxel_step(grid, loads, boundary_conditions,
                     params: OptimizationParameters, acceleration_data=None,
                     device="cuda", mesh=None) -> VoxelStep:
    """Build the SIMP iteration for a voxel problem on `device`, or over
    the shards of an ("x","y","z") device `mesh`."""
    device = (torch.device(device) if mesh is None
              else mesh_device(mesh, device, ("x", "y", "z")))
    dtype = resolve_dtype(params.dtype, device)
    elem_vol = grid.element_volume
    total_volume = grid.total_volume

    op = VoxelOperator(grid, E0=params.E0, Emin=params.Emin, nu=params.nu,
                       p=params.p, dtype=dtype, device=device)
    layout = None
    if mesh is None:
        filt = create_filter_cache(grid, params.filter_radius, dtype=dtype,
                                   device=device)
    else:
        from ..parallel.halo import HaloVoxelOperator
        from ..parallel.sharded_step import ShardedVoxelFilter
        from ..parallel.sharding import GridLayout

        layout = GridLayout(mesh, grid.nels)
        op = HaloVoxelOperator(op, layout)
        filt = ShardedVoxelFilter(grid, params.filter_radius, layout,
                                  dtype=dtype)
    use_density_filter = params.filter_type == "density"
    precond, setup_every = _build_preconditioner(op, params)

    def place(a, kind):
        return _place(a, kind, dtype, device, layout)

    free_mask = place(build_free_mask(grid, boundary_conditions), "node")
    f_ext = place(build_load_field(grid, loads), "node")
    if acceleration_data is not None:
        accel_vec, base_density = acceleration_data

    # Volume sensitivities: geometry-only, chain-ruled ONCE for the density
    # filter (Optimization.jl:241-248).
    vol_sens_physical = place(torch.full(grid.nels, elem_vol / total_volume,
                                         dtype=dtype), "cell")
    vol_sens = (filt.chain_rule(vol_sens_physical) if use_density_filter
                else vol_sens_physical)
    design0 = place(torch.full(grid.nels, params.volume_fraction,
                               dtype=dtype), "cell")
    u0 = place(torch.zeros((*grid.nnodes_per_axis, 3), dtype=dtype), "node")

    material_model = params.material_model
    # Equivalent-modulus field for the PRECONDITIONER under a custom
    # material: E_eff = 2(1+nu)*mu(rho), exact when nu does not depend on
    # the density; for varying-nu models an SPD approximation (the
    # preconditioner only steers CG, the operator itself is exact).
    mu_unit = 1.0 / (2.0 * (1.0 + params.nu))

    def physical(design):
        return filt.density_filter(design) if use_density_filter else design

    def precond_scale(phys):
        if material_model is None:
            return op.youngs_modulus(phys)
        return material_model(phys)[1] / mu_unit

    def forward(design, u_prev, state, recycle=None, rtol=None):
        """filter -> loads -> solve -> energy/volume."""
        phys = physical(design)
        f = f_ext
        if acceleration_data is not None:
            force = (voxel_body_force if layout is None
                     else op.body_force)
            f = f + force(phys, accel_vec, base_density, elem_vol)
        f_bc = f * free_mask
        if material_model is None:
            scale = op.youngs_modulus(phys)

            def A(v):
                return op.apply(v, scale, free_mask)
        else:
            lam_f, mu_f = material_model(phys)

            def A(v):
                return op.apply_lame(v, lam_f, mu_f, free_mask)
        sol = cg_solve(A, f_bc,
                       x0=u_prev * free_mask, M=precond.make_M(state),
                       rtol=params.cg_rtol if rtol is None else rtol,
                       maxiter=params.cg_maxiter,
                       deflate=recycle_deflate(free_mask, recycle))
        # 0.5 u^T K u without an extra matvec: K u = f - r at the CG exit.
        energy = 0.5 * (_vdot(sol.u, f_bc) - sol.u_dot_r)
        volume = phys.sum() * elem_vol
        return phys, sol, energy, volume

    def step(design, u_prev, state, recycle=None, rtol=None) -> StepOutput:
        phys, sol, energy, volume = forward(design, u_prev, state, recycle,
                                            rtol)
        if material_model is None:
            sens = op.compliance_sensitivities(sol.u, phys)
        else:
            # the exact material derivative by one elementwise jvp: dc/drho
            # = -(lam'(rho) u_e^T ke_lam u_e + mu'(rho) u_e^T ke_mu u_e)
            dlam, dmu = material_derivative(material_model, phys)
            wl, wm = op.element_energies_lame(sol.u)
            sens = -(dlam * wl + dmu * wm)
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

    def setup(design, pvecs, prev_state=None):
        """Preconditioner setup on the design's moduli: full, or
        multigrid's light one on top of prev_state.  Returns (state, new
        power vectors)."""
        scale = precond_scale(physical(design))
        if prev_state is None:
            return precond.setup(scale, free_mask, pvecs)
        return precond.setup_light(scale, free_mask, pvecs, prev_state)

    def power_init(design):
        """The one-time cold lambda_max estimation on the initial design."""
        return precond.power_init(precond_scale(physical(design)), free_mask)

    def solve(design, pvecs):
        """Final analysis (Optimization.jl:494-539): re-filter + re-solve
        from a cold start, after a full setup from the carried power
        vectors."""
        state = setup(design, pvecs)[0]
        phys, sol, energy, _ = forward(design, torch.zeros_like(u0), state)
        return phys, sol.u, energy

    def element_energy(phys, u):
        """0.5 * u_e^T K_e u_e element field (PostProcessing.jl:172-197)."""
        if material_model is None:
            return 0.5 * op.youngs_modulus(phys) * op.element_energies_unit(u)
        lam_f, mu_f = material_model(phys)
        wl, wm = op.element_energies_lame(u)
        return 0.5 * (lam_f * wl + mu_f * wm)

    return VoxelStep(
        grid=grid, op=op, filt=filt, precond=precond,
        setup_every=setup_every, power_init=power_init, setup=setup,
        step=step, metrics=metrics, solve=solve,
        element_energy=element_energy, design0=design0, u0=u0,
        vol_sens=vol_sens, elem_vol=elem_vol, total_volume=total_volume,
        dtype=dtype, device=device, layout=layout)


def _to_numpy(t):
    """A tensor (or a sharded field, gathered) as float64 numpy on the
    host."""
    if not isinstance(t, torch.Tensor):
        t = t.gather()
    return t.cpu().double().numpy()


def simp_optimize(grid, loads, boundary_conditions,
                  params: OptimizationParameters, acceleration_data=None,
                  mesh=None, resume_from=None, *,
                  device="cuda") -> OptimizationResult:
    """Run SIMP topology optimization on a voxel grid or an imported mesh.

    Args:
      grid: VoxelGrid, or an UnstructuredMesh (tet4/hex8; mesh.py), which
        runs through opt/optimize_unstructured.py.
      loads: list of PointLoad / SurfaceTractionLoad.
      boundary_conditions: list of DirichletBC.
      params: OptimizationParameters.
      acceleration_data: optional (acceleration_vector, base_density) for
        variable-density body forces (Optimization.jl:195-198, 301-311).
      mesh: optional device mesh.  Voxel grids take an ("x","y","z") mesh
        (parallel.sharding.make_mesh): the grid is split over its shards,
        each on its own device (a device may repeat), with explicit halo
        exchanges.  An UnstructuredMesh takes a 1-axis ("e",) mesh
        (make_element_mesh): its elements are split.  The device of the
        mesh must agree with `device`.
      resume_from: optional checkpoint path (opt/checkpoint.py, the JAX
        package's format): restores design, displacements, iteration,
        histories, power vectors and recycle ring, and continues.
      device: where every tensor lives, "cuda[:N]" (the default) or "cpu".
        CUDA runs the operator through the hand-written kernels; without a
        CUDA device the default raises, and the CPU runs only when asked
        for.
    """
    if mesh is not None:  # checked up front, as the reference does
        mesh_device(mesh, device, ("x", "y", "z")
                    if isinstance(grid, VoxelGrid) else ("e",))
    if not isinstance(grid, VoxelGrid):
        from .optimize_unstructured import simp_optimize_unstructured

        return simp_optimize_unstructured(
            grid, loads, boundary_conditions, params, acceleration_data,
            resume_from=resume_from, device_mesh=mesh, device=device)
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
                          acceleration_data, device=device, mesh=mesh)
    total_volume, elem_vol = vs.total_volume, vs.elem_vol
    design, u = vs.design0, vs.u0
    # Coarse-to-fine continuation: replace the uniform initial design with
    # the prolonged result of a half-resolution run of the same problem
    # (opt/continuation.py).  Resuming a checkpoint supersedes it: the
    # checkpointed state is already developed.
    if params.continuation_levels > 0 and not resume_from:
        from .continuation import continuation_init

        design, u = continuation_init(grid, loads, boundary_conditions,
                                      params, acceleration_data,
                                      device=vs.device)
        design, u = vs.place(design, "cell"), vs.place(u, "node")

    # Subspace-recycled CG: ring buffer of the last k solutions, whose
    # deltas deflate the warm-start residual (ops/cg.py).
    recycle_k = params.cg_recycle_k
    rhist = None
    recycle_dtype = (resolve_dtype(params.cg_recycle_dtype, vs.device)
                     if params.cg_recycle_dtype else None)
    if recycle_k > 1:
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
    checkpoint_triggered = [False] * len(params.tolerance_checkpoints)
    start_iteration = 1
    pvecs = None
    if resume_from:
        from .checkpoint import load_checkpoint, restore_triggered

        saved = load_checkpoint(resume_from)
        design = vs.place(saved["design"], "cell")
        u = vs.place(saved["u"], "node")
        start_iteration = saved["iteration"] + 1
        energy_history = saved["energy_history"]
        volume_history = saved["volume_history"]
        change_history = saved["change_history"]
        cg_history = saved["cg_history"]
        checkpoint_triggered = restore_triggered(
            saved["checkpoint_triggered"], params.tolerance_checkpoints)
        saved_pvecs = saved["pvecs"]
        starts = vs.precond.init_power_vectors()
        if starts and [tuple(v.shape) for v in saved_pvecs] == \
                [tuple(v.shape) for v in starts]:
            # each level as its start vector lies (sharded or on the
            # first device)
            pvecs = tuple(
                vs.place(v, "node") if not isinstance(s, torch.Tensor)
                else torch.as_tensor(v, dtype=vs.dtype, device=vs.device)
                for v, s in zip(saved_pvecs, starts))
        if rhist is not None:
            saved_rec = saved["recycle"]
            if saved_rec is not None and saved_rec.shape[0] == recycle_k:
                rhist = vs.place(saved_rec, "node").to(
                    recycle_dtype or vs.dtype)
            else:
                # the checkpoint predates recycling (or has another k): seed
                # the ring with the restored warm start
                rhist = recycle_init(recycle_k, u, dtype=recycle_dtype)
        if adaptive_forcing and change_history:
            # a resumed run restarts the forcing schedule from the restored
            # change
            rtol_now = _forcing_rtol(change_history[-1])
    if params.tolerance_checkpoints:
        print_info(
            f"Tolerance checkpoints enabled: {params.tolerance_checkpoints}")

    # Preconditioner state: the carried power vectors (multigrid's cold
    # estimation once, here, unless a checkpoint brought them) and the
    # state with its setup cadence and the CG watchdog.
    if pvecs is None:
        pvecs = vs.power_init(design)
    light_ok = (vs.precond.supports_light_setup
                and params.mg_full_setup_every > 1)
    state = None
    last_setup_it = 0
    last_full_it = 0
    cg_baseline = None        # CG count of the first solve after a full setup
    cg_since_refresh = None   # CG count of the most recent solve

    iteration_seconds: list[float] = []   # of this run's own iterations
    converged = False
    iteration = start_iteration - 1
    warned_health = False
    warned_bisection = False

    def maybe_save_checkpoint(it):
        if params.checkpoint_interval > 0 and params.checkpoint_path and \
                it % params.checkpoint_interval == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(
                params.checkpoint_path, design=_to_numpy(design),
                u=_to_numpy(u), iteration=it, energy_history=energy_history,
                volume_history=volume_history, change_history=change_history,
                cg_history=cg_history,
                checkpoint_triggered=checkpoint_triggered,
                pvecs=[_to_numpy(v) for v in pvecs],
                recycle=_to_numpy(rhist) if rhist is not None else None)

    profiler = None
    for it in range(start_iteration, params.max_iterations + 1):
        iteration = it
        if params.profile_dir and it == 2:
            profiler = _start_profiler(vs.device)
        t0 = time.perf_counter()
        # Refresh the preconditioner every setup_every iterations (CG
        # always applies the current operator), at once when the last solve
        # degraded; between multigrid's full setups only the fine half.
        stale_steps = it - last_setup_it if state is not None else 0
        degraded = (cg_since_refresh is not None and cg_baseline
                    and cg_since_refresh > max(1.5 * cg_baseline,
                                               cg_baseline + 3))
        if state is None or stale_steps >= vs.setup_every or degraded:
            if (light_ok and state is not None and not degraded
                    and it - last_full_it < params.mg_full_setup_every):
                state, pvecs = vs.setup(design, pvecs, state)
            else:
                state, pvecs = vs.setup(design, pvecs)
                last_full_it = it
                cg_baseline = None
            last_setup_it = it
        out = vs.step(design, u, state, recycle=rhist, rtol=rtol_now)
        if rhist is not None:
            rhist = recycle_push(rhist, out.u)
        (change, grayness, max_disp, frac_neg, _mean_abs, max_abs) = \
            vs.metrics(out.new_design, design, out.phys, out.u, out.fsens)
        u = out.u
        if profiler is not None and it >= 4:
            _stop_profiler(profiler, vs.device, params.profile_dir)
            profiler = None

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
        cg_since_refresh = out.cg_iters
        if cg_baseline is None:
            cg_baseline = cg_since_refresh
        # float() above waited for the device: this is the iteration's time
        iteration_seconds.append(time.perf_counter() - t0)

        # Sensitivity health warnings, warn once (OptimalityCriteria.jl
        # :19-40); the median comes from a host-side subsample.
        if not warned_health and (it == start_iteration or it % 10 == 0):
            warned_health = _warn_sensitivity_health(
                float(frac_neg), float(max_abs), vs.gather(out.fsens))

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

        # Tolerance checkpoints (Optimization.jl:407-445)
        if params.tolerance_checkpoints and params.export_path:
            for idx, cp in enumerate(params.tolerance_checkpoints):
                if not checkpoint_triggered[idx] and change < cp:
                    checkpoint_triggered[idx] = True
                    print_info(
                        f"Tolerance checkpoint {cp} reached at iteration {it}")
                    _export_intermediate(
                        vs, params, out.phys, u, energy, volume, it,
                        energy_history, volume_history,
                        name=f"final_results_{int(round(cp * 100)):02d}tol")

        # Periodic interval export (Optimization.jl:448-477)
        if (params.export_interval > 0
                and it % params.export_interval == 0
                and params.export_path):
            _export_intermediate(
                vs, params, out.phys, u, energy, volume, it,
                energy_history, volume_history, name=f"iter_{it:04d}")

        design = out.new_design
        maybe_save_checkpoint(it)
        if change < params.tolerance:
            print_success(f"Converged after {it} iterations")
            converged = True
            break

    if profiler is not None:  # max_iterations < 4
        _stop_profiler(profiler, vs.device, params.profile_dir)

    # ----- final analysis (Optimization.jl:494-539) -------------------------
    phys, u, final_energy = vs.solve(design, pvecs)
    final_energy = float(final_energy)
    final_volume = float(phys.sum()) * elem_vol
    energies = vs.gather(vs.element_energy(phys, u))
    phys, u = vs.gather(phys), vs.gather(u)

    stresses = voxel_stresses(grid, u, phys, params.E0, params.Emin,
                              params.nu, params.p,
                              material_model=params.material_model)
    print_data(
        f"Maximum von Mises stress: {stresses.max_von_mises} "
        f"at cell {stresses.max_vm_cell}"
    )
    # 0.5 * integral(sigma:eps) per cell == 0.5 * u_e^T K_e u_e
    elem_energies = grid.cells_flat(_to_numpy(energies))

    if logger is not None:
        logger.write_summary(final_energy, final_volume, converged)
        logger.close()

    print_success("Optimization completed")
    print_data(f"Final energy: {final_energy}")
    print_data(f"Final volume fraction: {final_volume / total_volume}")

    phys_np = _to_numpy(phys)
    return OptimizationResult(
        densities=grid.cells_flat(phys_np),
        displacements=grid.dofs_flat(_to_numpy(u)),
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


def _start_profiler(device):
    """A running `torch.profiler` over the host and, on a CUDA device, the
    card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, device, profile_dir):
    """Waits for the device, stops `profiler` and writes its chrome trace
    into `profile_dir`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "simp_iterations.trace.json")
    profiler.export_chrome_trace(path)
    print_info(f"Profiler trace written to {path}")


def _export_intermediate(vs, params, phys, u, energy, volume, iteration,
                         energy_history, volume_history, name):
    """Stress recovery + VTU export for checkpoints/interval dumps."""
    from ..post.vtu import create_results_data, export_main_results

    grid = vs.grid
    energies = vs.gather(vs.element_energy(phys, u))
    phys, u = vs.gather(phys), vs.gather(u)
    stresses = voxel_stresses(grid, u, phys, params.E0, params.Emin,
                              params.nu, params.p,
                              material_model=params.material_model)
    phys_np = _to_numpy(phys)
    interim = OptimizationResult(
        densities=grid.cells_flat(phys_np),
        displacements=grid.dofs_flat(_to_numpy(u)),
        stresses=stresses,
        energy=float(energy),
        volume=float(volume),
        iterations=iteration,
        converged=False,
        energy_history=list(energy_history),
        volume_history=list(volume_history),
        densities_3d=phys_np,
        element_energies=grid.cells_flat(_to_numpy(energies)),
    )
    data = create_results_data(grid, interim)
    export_main_results(data, os.path.join(params.export_path, name))
    print_success(f"Exported: {name}.vtu")
