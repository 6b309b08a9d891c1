"""The 2x1x1 benchmark beam family (40x20x20 hex, 16k elements).

Encodes the four study variants of the reference's tolerance-study scripts:
  * `four_legs`    — 05_3D_2x1x1_4Legs.jl: 4 corner fixations at x=0,
                     circular -Z load at the x=2 face center
  * `mbb`          — 06_3D_2x1x1_MBB.jl: X-symmetry plane, Y-roller edge,
                     Z pin, semicircular top load
  * `michell`      — 07_3D_2x1x1_Michell_tol_study.jl: 4 bottom corner
                     supports, circular bottom-center load
  * `michell_half` — 08_3D_2x1x1_Michell-half_tol_study.jl: 2 bottom corners
                     + Z-symmetry plane at z=1, load circle on the symmetry
                     edge
Port of easysimp_tpu/models/beam_2x1x1.py; `run` takes the device.
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
    select_nodes_by_plane,
)

__all__ = ["build_four_legs", "build_mbb", "build_michell",
           "build_michell_half", "run"]

XMAX, YMAX, ZMAX = 2.0, 1.0, 1.0


def _grid(nels=(40, 20, 20)):
    return generate_grid(nels, (0.0, 0.0, 0.0), (XMAX, YMAX, ZMAX))


def _coords(grid):
    return np.asarray(grid.node_coords)


def build_four_legs(nels=(40, 20, 20), **overrides):
    grid = _grid(nels)
    c = _coords(grid)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    fs = 0.3
    on_face = np.abs(x) < 1e-6
    corner = (
        ((y <= fs + 1e-6) & (z <= fs + 1e-6))
        | ((y >= YMAX - fs - 1e-6) & (z <= fs + 1e-6))
        | ((y <= fs + 1e-6) & (z >= ZMAX - fs - 1e-6))
        | ((y >= YMAX - fs - 1e-6) & (z >= ZMAX - fs - 1e-6))
    )
    fixed = np.nonzero(on_face & corner)[0]
    r = 0.1
    on_tip = np.abs(x - XMAX) < 1e-6
    in_circle = (y - YMAX / 2) ** 2 + (z - ZMAX / 2) ** 2 <= r**2 + 1e-6
    force = np.nonzero(on_tip & in_circle)[0]
    if force.size == 0:
        force = np.array([closest_node(grid, [XMAX, YMAX / 2, ZMAX / 2])])
    bcs = [apply_fixed_boundary(grid, fixed)]
    loads = [PointLoad(force, [0.0, 0.0, -1.0])]
    kw = dict(E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.4,
              max_iterations=2000, tolerance=0.08, filter_radius=2.0)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), None


def build_mbb(nels=(40, 20, 20), **overrides):
    grid = _grid(nels)
    c = _coords(grid)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    eps_ = 1e-12
    symmetry = select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-9)
    support = np.nonzero((np.abs(y) < eps_) & (x >= XMAX - 0.05 - eps_))[0]
    z_fix = np.array([closest_node(grid, [0.0, 1.0, 0.5])])
    r = 0.1 + 1e-12
    on_top = np.abs(y - 1.0) < eps_
    d = np.sqrt(x**2 + (z - 0.5) ** 2)
    force = np.nonzero(on_top & (d <= r) & (x >= -eps_))[0]
    if force.size == 0:
        force = np.array([closest_node(grid, [0.0, 1.0, 0.5])])
    bcs = [
        apply_sliding_boundary(grid, symmetry, [0]),
        apply_sliding_boundary(grid, support, [1]),
        apply_sliding_boundary(grid, z_fix, [2]),
    ]
    loads = [PointLoad(force, [0.0, -1.0, 0.0])]
    kw = dict(E0=1.0, Emin=1e-6, nu=0.3, p=3.0, volume_fraction=0.4,
              max_iterations=2000, tolerance=0.01, filter_radius=2.0)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), None


def build_michell(nels=(40, 20, 20), **overrides):
    grid = _grid(nels)
    c = _coords(grid)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    cs = 0.15
    eps_ = 1e-12
    bottom = np.abs(y) < eps_
    left = bottom & (x <= cs + eps_) & (
        (z <= cs + eps_) | (z >= ZMAX - cs - eps_))
    right = bottom & (x >= XMAX - cs - eps_) & (
        (z <= cs + eps_) | (z >= ZMAX - cs - eps_))
    r = 0.1 + 1e-12
    d = np.sqrt((x - 1.0) ** 2 + (z - 0.5) ** 2)
    force = np.nonzero(bottom & (d <= r))[0]
    if force.size == 0:
        force = np.array([closest_node(grid, [1.0, 0.0, 0.5])])
    bcs = [
        apply_fixed_boundary(grid, np.nonzero(left)[0]),
        apply_fixed_boundary(grid, np.nonzero(right)[0]),
    ]
    loads = [PointLoad(force, [0.0, -1.0, 0.0])]
    kw = dict(E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.4,
              max_iterations=3000, tolerance=0.08, filter_radius=2.0)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), None


def build_michell_half(nels=(40, 20, 20), **overrides):
    grid = _grid(nels)
    c = _coords(grid)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    cs = 0.15
    eps_ = 1e-12
    bottom = np.abs(y) < eps_
    left = bottom & (x <= cs + eps_) & (z <= cs + eps_)
    right = bottom & (x >= XMAX - cs - eps_) & (z <= cs + eps_)
    symmetry_z = select_nodes_by_plane(grid, [0, 0, 1.0], [0, 0, 1.0], 1e-6)
    r = 0.1 + 1e-12
    d = np.sqrt((x - 1.0) ** 2 + (z - 1.0) ** 2)
    force = np.nonzero(bottom & (d <= r))[0]
    if force.size == 0:
        force = np.array([closest_node(grid, [1.0, 0.0, 1.0])])
    bcs = [
        apply_fixed_boundary(grid, np.nonzero(left)[0]),
        apply_fixed_boundary(grid, np.nonzero(right)[0]),
        apply_sliding_boundary(grid, symmetry_z, [2]),
    ]
    loads = [PointLoad(force, [0.0, -1.0, 0.0])]
    kw = dict(E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.4,
              max_iterations=3000, tolerance=0.08, filter_radius=2.0)
    kw.update(overrides)
    return grid, loads, bcs, OptimizationParameters(**kw), None


def run(variant="four_legs", device="cuda", **overrides):
    from ..opt.optimize import simp_optimize

    build = {"four_legs": build_four_legs, "mbb": build_mbb,
               "michell": build_michell, "michell_half": build_michell_half}[
        variant]
    grid, loads, bcs, params, accel = build(**overrides)
    return simp_optimize(grid, loads, bcs, params, accel, device=device)
