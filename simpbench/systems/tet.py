"""The port's unstructured SIMP iteration: `UnstructuredStep`, built once by
`build_unstructured_step` on the port's 6-tet mesh of the grid
(`tet_mesh_from_grid`), stepped as
`run_unstructured` in `easysimp_tpu_torch/bench.py` steps it.  That
schedule is a closure there, so its lines are repeated here exactly: push
the new displacements into the recycle ring, and with adaptive forcing set
the next CG tolerance from the iteration's design change.

Traffic `start` "uniform" only: the episode starts at the seeded start
design, zero displacements, the ring seeded from them and the loosest
tolerance.  Every iteration sets the AMG up in full.
"""

from __future__ import annotations

import math

import torch

from ..cells import start_design
from . import make_params


class System:
    def __init__(self, cell, device):
        import easysimp_tpu_torch as pt
        from easysimp_tpu_torch.opt.optimize_unstructured import (
            build_unstructured_step,
        )

        if cell.traffic["start"] != "uniform":
            raise ValueError("the tet system starts from the uniform design")
        self.cell, self.device = cell, torch.device(device)
        nx, ny, nz = cell.grid()
        self.mesh = mesh = pt.tet_mesh_from_grid(pt.generate_grid(
            (nx, ny, nz)))
        bcs = [pt.apply_fixed_boundary(mesh, pt.select_nodes_by_plane(
            mesh, [0, 0, 0], [1, 0, 0], 1e-6))]
        loads = [pt.PointLoad(pt.select_nodes_by_box(
            mesh, [nx, 0, 0], [nx, 0, nz], 1e-6),
            cell.config["load"]["total_force"])]
        self.params = make_params(pt, cell.config)
        self.us = build_unstructured_step(mesh, loads, bcs, self.params,
                                          None, device=self.device)
        s = cell.config["schedule"]
        self.recycle_k = s["recycle_k"]
        self.adaptive = s["forcing"] == "adaptive"
        self.start = None

    def prepare(self, seed, records):
        design = self.us.place(start_design(
            self.cell.config, seed, (6 * math.prod(self.cell.grid()),)))
        records.append(dict(exact="start_design", level=0,
                            got=design.cpu(), seed=seed))
        records.append(dict(exact="mesh", level=0,
                            coords=self.mesh.node_coords,
                            conn=self.mesh.connectivity))
        self.start = (design, self.us.u0)

    def restore(self):
        from easysimp_tpu_torch.ops.cg import recycle_init

        self.design, self.u = self.start
        self.rhist = (recycle_init(self.recycle_k, self.u)
                      if self.recycle_k > 1 else None)
        self.rtol = self.params.cg_rtol_max if self.adaptive else None

    def one_step(self):
        from easysimp_tpu_torch.ops.cg import recycle_push

        p = self.params
        out = self.us.step(self.design, self.u, recycle=self.rhist,
                           rtol=self.rtol)
        self.design, self.u = out[0], out[1]
        if self.rhist is not None:
            self.rhist = recycle_push(self.rhist, self.u)
        if self.adaptive:
            self.rtol = min(p.cg_rtol_max,
                            max(p.cg_rtol, p.cg_forcing_coeff * float(out[5])))
        return out[3], int(out[9])

    def fields(self):
        return self.design, self.u

    def spans(self, wrap):
        self.us.step = wrap("step", self.us.step)
