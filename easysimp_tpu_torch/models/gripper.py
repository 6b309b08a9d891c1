"""Gripper compliant-mount model (test/Examples/04_gripper_complex.jl).

Imported hex mesh (the reference's data/stul14.vtu), multiple point loads,
circular fixed support, X-symmetry sliding plane, and a 6 m/s^2 body force:
the reference's most feature-complete workload.  Port of
easysimp_tpu/models/gripper.py; the mesh file is not part of this
repository, so `mesh_path` names it, and `run` takes the device.
"""

from __future__ import annotations

from .. import (
    OptimizationParameters,
    PointLoad,
    apply_fixed_boundary,
    apply_sliding_boundary,
    select_nodes_by_circle,
    select_nodes_by_plane,
)

__all__ = ["build", "run"]


def build(mesh_path, **overrides):
    """(mesh, loads, bcs, params, acceleration_data) on the mesh file
    `mesh_path` (stul14.vtu)."""
    from ..mesh import import_mesh

    mesh = import_mesh(mesh_path)

    fixed = select_nodes_by_circle(
        mesh, [0.0, 75.0, 115.0], [0.0, -1.0, 0.0], 16.11, 1e-3)
    symmetry = select_nodes_by_plane(mesh, [0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                     1e-3)
    legs = select_nodes_by_plane(mesh, [0.0, 0.0, -90.0], [0.0, 0.0, 1.0],
                                 1.0)
    camera = select_nodes_by_circle(mesh, [0.0, 0.0, 5.0], [0.0, 0.0, 1.0],
                                    21.5, 1e-3)

    bcs = [
        apply_fixed_boundary(mesh, fixed),
        apply_sliding_boundary(mesh, symmetry, [0]),
    ]
    loads = [
        PointLoad(legs, [0.0, 0.0, -13000.0]),    # legs: 13 N [mN units]
        PointLoad(camera, [0.0, 0.0, -500.0]),    # camera: 0.5 N
    ]
    rho = 1.04e-6                                 # polymer [kg/mm^3]
    accel = ([0.0, 6000.0, 0.0], rho)             # 6 m/s^2 in Y

    kw = dict(E0=2.4e3, Emin=1e-6, nu=0.35, p=3.0, volume_fraction=0.3,
              max_iterations=100, tolerance=0.01, filter_radius=1.5)
    kw.update(overrides)
    return mesh, loads, bcs, OptimizationParameters(**kw), accel


def run(mesh_path, device="cuda", **overrides):
    from ..opt.optimize import simp_optimize

    mesh, loads, bcs, params, accel = build(mesh_path, **overrides)
    return simp_optimize(mesh, loads, bcs, params, accel, device=device)
