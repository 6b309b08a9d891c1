"""The port's voxel SIMP iteration: `VoxelStep`, built once by
`build_voxel_step`, stepped by the port's own host schedule (`_Stepper` of
`easysimp_tpu_torch/bench.py`: setup cadence, CG watchdog, recycle ring,
adaptive forcing).

Traffic `start`:
  "uniform"     the episode starts at the seeded start design, zero
                displacements, the cold power estimation on that design;
  "trajectory"  set-up first runs the bench's trajectory: `prelude`
                iterations at half resolution from the seeded design, the
                design prolonged by repetition and the displacements
                trilinearly, then `advance` fine iterations; the episode
                starts where that ends.
Every episode starts with a full preconditioner setup.
"""

from __future__ import annotations

import gc

import torch

from ..cells import SEED_SAMPLE, rng, start_design
from . import make_params


class System:
    def __init__(self, cell, device):
        import easysimp_tpu_torch as pt
        from easysimp_tpu_torch.bench import _Stepper

        self.pt, self._Stepper = pt, _Stepper
        self.cell, self.device = cell, torch.device(device)
        self.vs, self.params = self._build(cell.grid())
        self.st = self._stepper(self.vs, self.params)
        self.start = None

    def _build(self, nels):
        from easysimp_tpu_torch.opt.optimize import build_voxel_step

        pt, config = self.pt, self.cell.config
        nx, ny, nz = nels
        grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                                tuple(float(n) for n in nels))
        bc = pt.apply_fixed_boundary(
            grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
        load = pt.PointLoad(
            pt.select_nodes_by_box(grid, [nx, 0, 0], [nx, 0, nz]),
            config["load"]["total_force"])
        params = make_params(pt, config)
        return build_voxel_step(grid, [load], [bc], params,
                                device=self.device), params

    def _stepper(self, vs, params):
        s = self.cell.config["schedule"]
        st = self._Stepper(vs, params, recycle_k=s["recycle_k"],
                           adaptive=s["forcing"] == "adaptive",
                           setup_every=s["setup_every"])
        if st.full_every != s["full_setup_every"]:
            raise RuntimeError(f"the stepper sets up in full every "
                               f"{st.full_every}, the configuration says "
                               f"{s['full_setup_every']}")
        return st

    @staticmethod
    def _recorded_step(st, level, records):
        x_in = st.design.cpu()
        energy, cg = st.one_step()
        records.append(dict(level=level, x_in=x_in, u=st.u.cpu(),
                            energy=float(energy), x_out=st.design.cpu(),
                            cg=cg))

    def prepare(self, seed, records):
        """Make the episode's start state from `seed`; append to `records`
        the set-up iterations drawn for the check, and exact checks."""
        traffic, st = self.cell.traffic, self.st
        if traffic["start"] == "uniform":
            st.design = self.vs.place(
                start_design(self.cell.config, seed, self.cell.grid()), "cell")
            st.u = self.vs.u0
            st.cold_power()
            records.append(dict(exact="start_design", level=0,
                                got=st.design.cpu(), seed=seed))
        else:
            self._trajectory(seed, records)
        self.start = dict(vars(st))
        self.start.update(state=None, steps_since_setup=0,
                          steps_since_full=0, cg_baseline=None,
                          last_cg=None, pending_cg=None)
        if traffic["start"] == "uniform":
            self.start["rhist"] = None      # re-seeded from u at restore

    def _trajectory(self, seed, records):
        from easysimp_tpu_torch.ops.multigrid import prolong
        from easysimp_tpu_torch.opt.continuation import prolong_design

        t = self.cell.traffic
        pick = rng(seed, SEED_SAMPLE)
        prelude_rec = set(pick.choice(t["prelude"], t["check_prelude"],
                                      replace=False).tolist())
        advance_rec = set(pick.choice(t["advance"], t["check_advance"],
                                      replace=False).tolist())
        level = 1
        vs_c, params_c = self._build(self.cell.grid(level))
        st_c = self._stepper(vs_c, params_c)
        st_c.design = vs_c.place(
            start_design(self.cell.config, seed, self.cell.grid(level)),
            "cell")
        records.append(dict(exact="start_design", level=level,
                            got=st_c.design.cpu(), seed=seed))
        st_c.cold_power()
        for j in range(t["prelude"]):
            if j in prelude_rec:
                self._recorded_step(st_c, level, records)
            else:
                st_c.one_step()
        st = self.st
        st.design, st.u = prolong_design(st_c.design), prolong(st_c.u)
        st.rtol_now = st_c.rtol_now
        records.append(dict(exact="prolonged_design", level=0,
                            got=st.design.cpu(), coarse=st_c.design.cpu()))
        # the coarse stage's ring and hierarchy go before the fine ones grow
        del st_c, vs_c
        gc.collect()
        st.reset_recycle()
        st.cold_power()
        for j in range(t["advance"]):
            if j in advance_rec:
                self._recorded_step(st, 0, records)
            else:
                st.one_step()

    def restore(self):
        st = self.st
        vars(st).update(self.start)
        if self.start["rhist"] is None:
            st.reset_recycle()

    def one_step(self):
        return self.st.one_step()

    def fields(self):
        return self.st.design, self.st.u

    def spans(self, wrap):
        self.vs.setup = wrap("setup", self.vs.setup)
        self.vs.step = wrap("step", self.vs.step)
