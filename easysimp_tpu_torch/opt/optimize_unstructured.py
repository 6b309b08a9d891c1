"""The SIMP loop for imported unstructured meshes (tet4 / hex8).

Port of easysimp_tpu/opt/optimize_unstructured.py.  Same iteration semantics
as the voxel loop (see optimize.py and
src/Optimization/Optimization.jl:178-565); the differences are mechanical:
flat (n_cells,) density vectors, flat (3*n_nodes,) dof vectors, the
gather / batched-product / fixed-order-sum UnstructuredOperator,
padded-neighbor-list filters, and CG preconditioned by the multilevel
RBM-aggregation AMG (ops/amg.py; the algebraic stand-in for the voxel path's
geometric multigrid).  Every tensor lives on `device`; PyTorch runs eagerly,
so the iteration is one Python function.

Under a 1-axis ("e",) device mesh (`device_mesh=`, parallel/sharding.py
`make_element_mesh`) the elements are split over the shards: the operator,
filter rows and AMG assembly inputs are the element-sharded twins of
parallel/element_step.py, element fields are sharded fields and dof vectors
stay on the mesh's first device.  The reference's split of the iteration
into three programs has no counterpart: it is a matter of its compile
transport.
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
from ..loads import build_load_field
from ..ops.cg import cg_solve, recycle_deflate, recycle_init, recycle_push
from ..ops.elements import (
    element_stiffness_batch_np,
    element_stiffness_lame_basis_batch_np,
    shape_integrals_batch_np,
)
from ..ops.filters import UnstructuredFilter
from ..ops.oc import MAX_BISECTION, oc_update, sensitivity_health
from ..ops.operator import UnstructuredOperator
from ..params import OptimizationParameters, OptimizationResult
from ..parallel.sharded_step import material_derivative
from ..stress import unstructured_stresses
from ..utils.terminal import (
    print_data,
    print_info,
    print_success,
    print_warning,
)

__all__ = ["simp_optimize_unstructured", "build_unstructured_step",
           "UnstructuredStep"]


@dataclass
class UnstructuredStep:
    """The SIMP iteration on an imported mesh and its companion state.

    `step(design, u_prev, recycle=None, rtol=None)` runs one full iteration
    (the preconditioner setup included) and returns the reference's tuple;
    `solve(design)` is the final re-analysis from a cold start;
    `build_seconds` holds the host time of the one-time build by part."""

    mesh: Any
    op: UnstructuredOperator
    filt: UnstructuredFilter
    amg: Any
    step: Callable
    solve: Callable
    element_energy: Callable
    design0: torch.Tensor
    u0: torch.Tensor
    element_volumes: torch.Tensor
    total_volume: float
    dtype: torch.dtype
    device: torch.device
    use_density_filter: bool
    shape_integrals: Any
    build_seconds: dict
    layout: Any = None    # parallel.sharding.ElementLayout under a mesh

    def place(self, a):
        """A global element array as the step holds it (split over the mesh
        under one)."""
        t = torch.as_tensor(np.asarray(a), dtype=self.dtype)
        return (t.to(self.device) if self.layout is None
                else self.layout.split(t))

    def gather(self, t):
        """An element field as one tensor on the (first) device."""
        return t if isinstance(t, torch.Tensor) else self.layout.gather(t)


def build_unstructured_step(mesh, loads, boundary_conditions,
                            params: OptimizationParameters,
                            acceleration_data=None,
                            device="cuda",
                            device_mesh=None) -> UnstructuredStep:
    """Construct the SIMP iteration for an imported mesh on `device`, or
    with its elements split over an ("e",) `device_mesh`."""
    layout = None
    if device_mesh is not None:
        from ..parallel.sharding import ElementLayout, mesh_device

        device = mesh_device(device_mesh, device, ("e",))
        layout = ElementLayout(device_mesh, mesh.n_cells)
    device = torch.device(device)
    dtype = resolve_dtype(params.dtype, device)

    if not getattr(mesh, "is_volume_mesh", True):
        raise ValueError(
            f"SIMP optimization needs a volume mesh (tet4/hex8); got "
            f"{mesh.cell_type} cells")

    build_seconds = {}
    t0 = time.perf_counter()
    coords = mesh.node_coords[mesh.connectivity]       # (E, nn, 3)
    ke_unit, vols = element_stiffness_batch_np(coords, E=1.0, nu=params.nu)
    if layout is None:
        op = UnstructuredOperator(
            ke_unit, mesh.connectivity, mesh.n_nodes, E0=params.E0,
            Emin=params.Emin, nu=params.nu, p=params.p, dtype=dtype,
            device=device)
    else:
        from ..parallel.element_step import (
            ElementShardedAMG,
            ElementShardedFilter,
            ElementShardedOperator,
        )

        op = ElementShardedOperator(
            ke_unit, mesh.connectivity, mesh.n_nodes, E0=params.E0,
            Emin=params.Emin, nu=params.nu, p=params.p, layout=layout,
            dtype=dtype)
    material_model = params.material_model
    # Equivalent-modulus field for the PRECONDITIONER under a custom
    # material: E_eff = mu(rho) / mu_unit, exact when nu is density-
    # independent; an SPD approximation otherwise (the preconditioner only
    # steers CG, the operator itself stays exact).  Same recipe as the
    # voxel loop.
    mu_unit = 1.0 / (2.0 * (1.0 + params.nu))
    if material_model is not None:
        op.set_lame_basis(*element_stiffness_lame_basis_batch_np(coords))
    build_seconds["elements"] = time.perf_counter() - t0

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def elem(a):
        """An element array on the device, or split over the mesh."""
        return dev(a) if layout is None else layout.split(dev(a))

    def precond_scale(phys):
        if material_model is None:
            return op.youngs_modulus(phys)
        return material_model(phys)[1] / mu_unit

    element_volumes = elem(vols)
    total_volume = float(vols.sum())

    t0 = time.perf_counter()
    radius = params.filter_radius * mesh.characteristic_element_size
    filt = UnstructuredFilter(mesh.cell_centers, vols, radius, dtype=dtype,
                              device=device)
    if layout is not None:
        filt = ElementShardedFilter(filt, layout)
    build_seconds["neighbor_search"] = time.perf_counter() - t0
    use_density_filter = params.filter_type == "density"

    free_mask_np = build_free_mask(mesh, boundary_conditions)
    free_mask = dev(free_mask_np)
    f_ext = dev(build_load_field(mesh, loads).reshape(-1))

    shape_integrals = None
    if acceleration_data is not None:
        accel_vec, base_density = acceleration_data
        shape_integrals = elem(shape_integrals_batch_np(coords))
        accel = dev(np.asarray(accel_vec, dtype=np.float64))

    vol_sens_physical = element_volumes / total_volume
    vol_sens = (filt.chain_rule(vol_sens_physical) if use_density_filter
                else vol_sens_physical)

    design0 = elem(np.full(mesh.n_cells, params.volume_fraction))
    u0 = torch.zeros(mesh.n_dofs, dtype=dtype, device=device)

    def body_force(phys):
        # f_a += rho_e * base_density * integral(N_a) * accel, skipping
        # rho < 1e-6 (FiniteElementAnalysis.jl:486-526).
        w = torch.where(phys < 1e-6, torch.zeros_like(phys), phys) \
            * base_density
        fe = (w[:, None] * shape_integrals)[:, :, None] * accel
        return op.scatter_nodes(fe).reshape(-1)

    # "auto" resolves to the multilevel RBM-aggregation AMG (ops/amg.py),
    # the multigrid answer to the reference's CHOLMOD at SIMP contrast;
    # "block_jacobi" keeps the 3x3 nodal blocks, "jacobi" the scalar
    # diagonal.
    choice = params.preconditioner
    use_amg = choice in ("auto", "multigrid", "amg")
    use_block_jacobi = use_amg or choice == "block_jacobi"
    amg = None
    if use_amg:
        from ..ops.amg import MultilevelAMG

        amg_kw = dict(max_coarse_dofs=params.amg_max_coarse_dofs,
                      smooth_prolongator=params.amg_smooth_prolongator)
        if layout is None:
            amg = MultilevelAMG(op, mesh, free_mask_np, **amg_kw)
        else:
            amg = ElementShardedAMG(op, ke_unit, mesh, free_mask_np, **amg_kw)
        build_seconds.update(
            {f"amg_{k}": v for k, v in amg.build_seconds.items()})

    def forward(design, u_prev, recycle=None, rtol=None):
        phys = filt.density_filter(design) if use_density_filter else design
        scale = precond_scale(phys)
        f = f_ext if shape_integrals is None else f_ext + body_force(phys)
        f_bc = f * free_mask
        if material_model is None:
            def A(v):
                return op.apply(v, scale, free_mask)
        else:
            lam_f, mu_f = material_model(phys)

            def A(v):
                return op.apply_lame(v, lam_f, mu_f, free_mask)
        if use_amg:
            Binv = op.block_diagonal_inverse(scale, free_mask)
            amg_state = amg.setup(scale, free_mask, Binv, A)

            def M(r):
                return amg.apply(r, A, Binv, amg_state, free_mask)
        elif use_block_jacobi:
            Binv = op.block_diagonal_inverse(scale, free_mask)

            def M(r):
                return op.apply_block_jacobi(Binv, r)
        else:
            diag = op.diagonal(scale, free_mask)

            def M(r):
                return r / diag
        sol = cg_solve(A, f_bc, x0=u_prev * free_mask, M=M,
                       rtol=params.cg_rtol if rtol is None else rtol,
                       maxiter=params.cg_maxiter,
                       deflate=recycle_deflate(free_mask, recycle))
        energy = 0.5 * (torch.dot(sol.u, f_bc) - sol.u_dot_r)
        volume = (phys * element_volumes).sum()
        return phys, sol, energy, volume

    def update_core(design, phys, u):
        """Sensitivities -> filter -> OC -> convergence metrics (the
        post-solve half of the iteration)."""
        if material_model is None:
            sens = op.compliance_sensitivities(u, phys)
        else:
            # exact material derivative via one elementwise jvp: dc/drho =
            # -(lam'(rho) u_e^T ke_lam u_e + mu'(rho) u_e^T ke_mu u_e)
            dlam, dmu = material_derivative(material_model, phys)
            wl, wm = op.element_energies_lame(u)
            sens = -(dlam * wl + dmu * wm)
        if use_density_filter:
            fsens = filt.chain_rule(sens)
        else:
            fsens = filt.sensitivity_filter(design, sens)
        # volume_weights = H^T V = total_volume * vol_sens for both filter
        # types: replaces the reference's filter-in-bisection with a dot
        # product (see ops/oc.py).
        new_design, lam, bisect_iters, bisect_verr = oc_update(
            design, fsens, vol_sens, params.volume_fraction, total_volume,
            vol_sens * total_volume, params.move_limit, params.damping)
        change = (new_design - design).abs().max()
        grayness = ((phys > 0.1) & (phys < 0.9)).to(dtype).mean()
        max_disp = u.abs().max()
        frac_neg, _mean_abs, max_abs = sensitivity_health(fsens)
        return (new_design, change, lam, grayness, max_disp, bisect_iters,
                bisect_verr, frac_neg, max_abs, fsens)

    def step(design, u_prev, recycle=None, rtol=None):
        phys, sol, energy, volume = forward(design, u_prev, recycle=recycle,
                                            rtol=rtol)
        u = sol.u
        (new_design, change, lam, grayness, max_disp, bisect_iters,
         bisect_verr, frac_neg, max_abs, fsens) = update_core(design, phys,
                                                              u)
        return (new_design, u, phys, energy, volume, change, lam, grayness,
                max_disp, sol.iterations, sol.residual_norm, bisect_iters,
                bisect_verr, frac_neg, max_abs, fsens)

    def solve_only(design):
        phys, sol, energy, _ = forward(design, torch.zeros_like(u0))
        return phys, sol.u, energy

    def element_energy(phys, u):
        """0.5 * u_e^T K_e u_e element field (PostProcessing.jl:172-197)."""
        if material_model is None:
            return 0.5 * op.youngs_modulus(phys) * op.element_energies_unit(u)
        lam_f, mu_f = material_model(phys)
        wl, wm = op.element_energies_lame(u)
        return 0.5 * (lam_f * wl + mu_f * wm)

    return UnstructuredStep(
        mesh=mesh, op=op, filt=filt, amg=amg, step=step, solve=solve_only,
        element_energy=element_energy, design0=design0, u0=u0,
        element_volumes=element_volumes, total_volume=total_volume,
        dtype=dtype, device=device, use_density_filter=use_density_filter,
        shape_integrals=shape_integrals, build_seconds=build_seconds,
        layout=layout)


def _to_numpy(t):
    """A tensor (or a sharded field, gathered) as float64 numpy on the
    host."""
    if not isinstance(t, torch.Tensor):
        t = t.gather()
    return t.cpu().double().numpy()


def simp_optimize_unstructured(mesh, loads, boundary_conditions,
                               params: OptimizationParameters,
                               acceleration_data=None,
                               resume_from=None,
                               device_mesh=None, *,
                               device="cuda") -> OptimizationResult:
    """SIMP topology optimization on an UnstructuredMesh, on `device`
    ("cuda[:N]", the default, or "cpu" when asked for), or with its elements
    split over an ("e",) `device_mesh` whose devices agree with `device`."""
    if params.cg_forcing not in ("fixed", "adaptive"):
        raise ValueError(f"cg_forcing must be 'fixed' or 'adaptive', "
                         f"got {params.cg_forcing!r}")
    print_info("Starting SIMP topology optimization (unstructured path)")
    logger = None
    if params.export_path:
        from .logger import OptimizationLogger

        logger = OptimizationLogger(params.export_path, params.task_name)
    if acceleration_data is not None:
        print_info(
            f"Variable density acceleration enabled: {acceleration_data[0]}")
    print_data(f"Total mesh volume: {mesh.total_volume}")

    us = build_unstructured_step(mesh, loads, boundary_conditions, params,
                                 acceleration_data, device=device,
                                 device_mesh=device_mesh)
    total_volume = us.total_volume

    def dev(a):
        return torch.as_tensor(a, dtype=us.dtype, device=us.device)

    design, u = us.design0, us.u0
    # Subspace-recycled CG (params.cg_recycle_k, same recipe as the voxel
    # loop): ring buffer of recent solutions whose deltas deflate the
    # warm-start residual.
    rhist = None
    recycle_dtype = (resolve_dtype(params.cg_recycle_dtype, us.device)
                     if params.cg_recycle_dtype else None)
    if params.cg_recycle_k > 1:
        rhist = recycle_init(params.cg_recycle_k, u, dtype=recycle_dtype)
    # Adaptive CG forcing (inexact SIMP): same schedule as the voxel loop.
    adaptive_forcing = params.cg_forcing == "adaptive"

    def _forcing_rtol(change_prev):
        if change_prev is None:
            return params.cg_rtol_max
        return min(params.cg_rtol_max,
                   max(params.cg_rtol, params.cg_forcing_coeff * change_prev))

    rtol_now = _forcing_rtol(None) if adaptive_forcing else None
    energy_history, volume_history = [], []
    change_history, cg_history = [], []
    checkpoint_triggered = [False] * len(params.tolerance_checkpoints)
    start_iteration = 1
    if resume_from:
        from .checkpoint import load_checkpoint, restore_triggered

        state = load_checkpoint(resume_from)
        design, u = us.place(state["design"]), dev(state["u"])
        start_iteration = state["iteration"] + 1
        energy_history = state["energy_history"]
        volume_history = state["volume_history"]
        change_history = state["change_history"]
        cg_history = state["cg_history"]
        checkpoint_triggered = restore_triggered(
            state["checkpoint_triggered"], params.tolerance_checkpoints)
        if rhist is not None:
            saved_rec = state.get("recycle")
            if saved_rec is not None and \
                    saved_rec.shape[0] == params.cg_recycle_k:
                rhist = dev(saved_rec).to(recycle_dtype or us.dtype)
            else:
                # checkpoint predates recycling (or different k): seed the
                # buffer with the restored warm start.
                rhist = recycle_init(params.cg_recycle_k, u,
                                     dtype=recycle_dtype)

    if adaptive_forcing and change_history:
        # resumed runs restart the forcing schedule from the restored change
        rtol_now = _forcing_rtol(change_history[-1])

    def _maybe_save_checkpoint(it, design, u):
        if params.checkpoint_interval > 0 and params.checkpoint_path and \
                it % params.checkpoint_interval == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(
                params.checkpoint_path,
                design=_to_numpy(design), u=_to_numpy(u), iteration=it,
                energy_history=energy_history, volume_history=volume_history,
                change_history=change_history, cg_history=cg_history,
                checkpoint_triggered=checkpoint_triggered,
                recycle=(_to_numpy(rhist) if rhist is not None else None),
            )

    iteration_seconds: list[float] = []
    converged = False
    iteration = start_iteration - 1
    warned_health = False
    warned_bisection = False

    for it in range(start_iteration, params.max_iterations + 1):
        iteration = it
        t0 = time.perf_counter()
        (new_design, u, phys, energy, volume, change, lam, grayness,
         max_disp, cg_iters, _, bisect_iters, bisect_verr, frac_neg,
         max_abs, fsens) = us.step(design, u, recycle=rhist, rtol=rtol_now)
        if rhist is not None:
            rhist = recycle_push(rhist, u)

        energy, volume, change = float(energy), float(volume), float(change)
        if adaptive_forcing:
            rtol_now = _forcing_rtol(change)
        vol_frac = volume / total_volume
        energy_history.append(energy)
        volume_history.append(volume)
        change_history.append(change)
        cg_history.append(int(cg_iters))
        # float() above waited for the device: this is the iteration's time
        iteration_seconds.append(time.perf_counter() - t0)

        # Median-centered health warnings (OptimalityCriteria.jl:19-40);
        # the median is a host-side subsample (see ops/oc.py).  The three
        # reductions come to the host only on these iterations.
        if not warned_health and (it == start_iteration or it % 10 == 0):
            from .optimize import _warn_sensitivity_health

            warned_health = _warn_sensitivity_health(
                float(frac_neg), float(max_abs), us.gather(fsens))

        # OC bisection non-convergence warning, gated like the reference:
        # only when 200 iterations exhaust (OptimalityCriteria.jl:139-142)
        if not warned_bisection and bisect_iters >= MAX_BISECTION \
                and abs(bisect_verr) >= 1e-6:
            print_warning(
                f"OC bisection did not converge after {bisect_iters} "
                f"iterations (|volume error| = {abs(bisect_verr):.3e})"
            )
            warned_bisection = True

        if logger is not None:
            logger.log_iteration(it, energy, vol_frac, change, float(lam),
                                 float(grayness), float(max_disp))
        print(
            f"Iter {it:4d} | Energy: {energy:.4e} | Vol.Frac: {vol_frac:.4f} "
            f"| Change: {change:.4e} | CG: {int(cg_iters):4d}"
        )

        if params.tolerance_checkpoints and params.export_path:
            for idx, cp in enumerate(params.tolerance_checkpoints):
                if not checkpoint_triggered[idx] and change < cp:
                    checkpoint_triggered[idx] = True
                    print_info(
                        f"Tolerance checkpoint {cp} reached at iteration {it}")
                    _export_intermediate(
                        us, params, phys, u, energy, volume, it,
                        energy_history, volume_history,
                        name=f"final_results_{int(round(cp * 100)):02d}tol")

        if (params.export_interval > 0 and it % params.export_interval == 0
                and params.export_path):
            _export_intermediate(
                us, params, phys, u, energy, volume, it,
                energy_history, volume_history, name=f"iter_{it:04d}")

        design = new_design
        _maybe_save_checkpoint(it, design, u)
        if change < params.tolerance:
            print_success(f"Converged after {it} iterations")
            converged = True
            break

    phys, u, final_energy = us.solve(design)
    final_energy = float(final_energy)
    final_volume = float((phys * us.element_volumes).sum())

    phys_np, u_np = _to_numpy(phys), _to_numpy(u)
    stresses = unstructured_stresses(
        us.mesh, u_np, phys_np, params.E0, params.Emin, params.nu, params.p,
        material_model=params.material_model)
    print_data(
        f"Maximum von Mises stress: {stresses.max_von_mises} "
        f"at cell {stresses.max_vm_cell}")
    elem_energies = _to_numpy(us.element_energy(phys, u))

    if logger is not None:
        logger.write_summary(final_energy, final_volume, converged)
        logger.close()

    print_success("Optimization completed")
    print_data(f"Final energy: {final_energy}")
    print_data(f"Final volume fraction: {final_volume / total_volume}")

    return OptimizationResult(
        densities=phys_np,
        displacements=u_np,
        stresses=stresses,
        energy=final_energy,
        volume=final_volume,
        iterations=iteration,
        converged=converged,
        energy_history=energy_history,
        volume_history=volume_history,
        cg_iterations_history=cg_history,
        change_history=change_history,
        element_energies=elem_energies,
        iteration_seconds=iteration_seconds,
    )


def _export_intermediate(us, params, phys, u, energy, volume, iteration,
                         energy_history, volume_history, name):
    """Stress recovery + VTU export for checkpoints/interval dumps."""
    from ..post.vtu import create_results_data, export_main_results

    phys_np, u_np = _to_numpy(phys), _to_numpy(u)
    stresses = unstructured_stresses(
        us.mesh, u_np, phys_np, params.E0, params.Emin, params.nu, params.p,
        material_model=params.material_model)
    interim = OptimizationResult(
        densities=phys_np,
        displacements=u_np,
        stresses=stresses,
        energy=float(energy),
        volume=float(volume),
        iterations=iteration,
        converged=False,
        energy_history=list(energy_history),
        volume_history=list(volume_history),
        element_energies=_to_numpy(us.element_energy(phys, u)),
    )
    data = create_results_data(us.mesh, interim)
    export_main_results(data, os.path.join(params.export_path, name))
    print_success(f"Exported: {name}.vtu")
