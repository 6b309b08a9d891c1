"""Cantilever-beam model family.

Covers the reference's canonical workloads:
  * `basic`       — test/Examples/01_basic_cantilever.jl + test/runtests.jl:16-106
                    (60x20x4 hex, fixed x=0 plane, tip circle load)
  * `sliding`     — 02_sliding_support.jl (sliding-plane + roller supports)
  * `acceleration`— 03_with_acceleration.jl (body force, polymer material)
Each `build_*` function returns (grid, loads, bcs, params, acceleration_data).
Port of easysimp_tpu/models/cantilever.py; `run` takes the device.
"""

from __future__ import annotations

import numpy as np

from .. import (
    OptimizationParameters,
    PointLoad,
    apply_fixed_boundary,
    apply_sliding_boundary,
    closest_node,
    generate_grid,
    select_nodes_by_circle,
    select_nodes_by_plane,
)

__all__ = ["build_basic", "build_sliding", "build_acceleration", "run"]


def _grid(nels=(60, 20, 4)):
    return generate_grid(nels, (0.0, 0.0, 0.0),
                         (float(nels[0]), float(nels[1]), float(nels[2])))


def build_basic(nels=(60, 20, 4), **overrides):
    """01_basic_cantilever.jl / runtests.jl: fixed wall, tip point load."""
    grid = _grid(nels)
    nx, ny, nz = grid.nels
    fixed = select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-3)
    force = select_nodes_by_circle(
        grid, [float(nx), 0.0, nz / 2.0], [1.0, 0.0, 0.0], 1.0)
    if len(force) == 0:  # fallback (runtests.jl:45-58)
        force = np.array([closest_node(grid, [float(nx), 0.0, nz / 2.0])])
    bcs = [apply_fixed_boundary(grid, fixed)]
    loads = [PointLoad(force, [0.0, -1.0, 0.0])]
    kw = dict(E0=200.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.4,
              max_iterations=20, tolerance=0.08, filter_radius=2.5,
              move_limit=0.2, damping=0.5)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), None


def build_sliding(nels=(60, 20, 4), **overrides):
    """02_sliding_support.jl: X-sliding wall, Y-roller, load at the far top.

    Deliberate deviation (documented per SURVEY.md §7): the reference's BC set
    leaves rigid modes unconstrained — the Z translation AND the rotation
    about the x-parallel axis through the two point supports — a positive
    SEMI-definite system that its own runtests disable (RUN_BEAM_slide=false,
    runtests.jl:12).  A direct solver may limp through rank deficiency; an
    iterative solver should not be asked to.  We add two Z pins (the device
    the reference's own MBB example uses for rigid-body suppression,
    06_3D_2x1x1_MBB.jl:65-78,110) which together kill both modes.
    """
    grid = _grid(nels)
    nx, ny, nz = grid.nels
    sliding = select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-3)
    support = select_nodes_by_circle(
        grid, [float(nx), 0.0, nz / 2.0], [0.0, 1.0, 0.0], 0.5)
    if len(support) == 0:
        support = np.array([closest_node(grid, [float(nx), 0.0, nz / 2.0])])
    force = select_nodes_by_circle(
        grid, [0.0, float(ny), nz / 2.0], [1.0, 0.0, 0.0], 1.0)
    if len(force) == 0:
        force = np.array([closest_node(grid, [0.0, float(ny), nz / 2.0])])
    z_pins = np.array([
        closest_node(grid, [0.0, 0.0, 0.0]),
        closest_node(grid, [0.0, float(ny), 0.0]),
    ])
    bcs = [
        apply_sliding_boundary(grid, sliding, [0]),   # fix X only
        apply_sliding_boundary(grid, support, [1]),   # fix Y only
        apply_sliding_boundary(grid, z_pins, [2]),    # Z pins (see docstring)
    ]
    loads = [PointLoad(force, [0.0, -1.0, 0.0])]
    kw = dict(E0=200.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.4,
              max_iterations=100, tolerance=0.01, filter_radius=2.0)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), None


def build_acceleration(nels=(60, 20, 4), **overrides):
    """03_with_acceleration.jl: polymer beam under 6 m/s^2 body force."""
    grid = _grid(nels)
    nx, ny, nz = grid.nels
    sliding = select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-3)
    support = select_nodes_by_circle(
        grid, [float(nx), 0.0, nz / 2.0], [0.0, 1.0, 0.0], 0.5)
    if len(support) == 0:
        support = np.array([closest_node(grid, [float(nx), 0.0, nz / 2.0])])
    force = select_nodes_by_circle(
        grid, [0.0, float(ny), nz / 2.0], [1.0, 0.0, 0.0], 1.0)
    if len(force) == 0:
        force = np.array([closest_node(grid, [0.0, float(ny), nz / 2.0])])
    bcs = [
        apply_sliding_boundary(grid, sliding, [0]),
        apply_sliding_boundary(grid, support, [1]),
    ]
    loads = [PointLoad(force, [0.0, -1000.0, 0.0])]
    rho = 1.04e-6                       # polymer density [kg/mm^3]
    accel = ([0.0, 6000.0, 0.0], rho)   # 6 m/s^2 in Y [mm/s^2]
    kw = dict(E0=2.4e3, Emin=1e-6, nu=0.35, p=3.0, volume_fraction=0.4,
              max_iterations=100, tolerance=0.01, filter_radius=2.0)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), accel


def run(variant="basic", device="cuda", **overrides):
    from ..opt.optimize import simp_optimize

    build = {"basic": build_basic, "sliding": build_sliding,
               "acceleration": build_acceleration}[variant]
    grid, loads, bcs, params, accel = build(**overrides)
    return simp_optimize(grid, loads, bcs, params, accel, device=device)
