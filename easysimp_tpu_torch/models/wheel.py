"""Wheel model: tetrahedral import + surface traction + body force.

The reference ships the mesh (data/Wheel_3d_coarse.msh: hub bore at r=0.1
around the z-axis, rim at r=1.0, thickness z in [-0.15, 0.15]) and its
Wheel configuration calls for tet4 + SurfaceTractionLoad + body force; no
reference example exists, so the load case here is the natural one: hub
bore fixed, tangential traction on the rim (drive torque), gravity body
force.  Port of easysimp_tpu/models/wheel.py; the mesh file is not part of
this repository, so `mesh_path` names it, and `run` takes the device.
"""

from __future__ import annotations

import numpy as np

from .. import (
    OptimizationParameters,
    SurfaceTractionLoad,
    apply_fixed_boundary,
    select_nodes_by_cylinder,
)

__all__ = ["build", "run"]


def build(mesh_path, traction_magnitude=1.0, **overrides):
    """(mesh, loads, bcs, params, acceleration_data) on the mesh file
    `mesh_path` (Wheel_3d_coarse.msh)."""
    from ..mesh import import_mesh

    mesh = import_mesh(mesh_path)

    hub = select_nodes_by_cylinder(mesh, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                   0.1, 1e-3)
    rim = select_nodes_by_cylinder(mesh, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                   1.0, 1e-3)

    def tangential_traction(x, y, z):
        r = max(np.hypot(x, y), 1e-12)
        return [-traction_magnitude * y / r, traction_magnitude * x / r, 0.0]

    bcs = [apply_fixed_boundary(mesh, hub)]
    loads = [SurfaceTractionLoad(rim, tangential_traction)]
    accel = ([0.0, -9.81, 0.0], 7.85e3)   # steel under gravity

    kw = dict(E0=200e9, Emin=200e3, nu=0.3, p=3.0, volume_fraction=0.35,
              max_iterations=100, tolerance=0.01, filter_radius=1.5)
    kw.update(overrides)
    return mesh, loads, bcs, OptimizationParameters(**kw), accel


def run(mesh_path, device="cuda", **overrides):
    from ..opt.optimize import simp_optimize

    mesh, loads, bcs, params, accel = build(mesh_path, **overrides)
    return simp_optimize(mesh, loads, bcs, params, accel, device=device)
