"""The host schedule of the voxel SIMP loop around a `VoxelStep`, one for
`simp_optimize` and the bench's `_Stepper` (which the benchmark drives).

Before each iteration a preconditioner setup is due every `setup_every`
iterations: multigrid's light one (the fine half on top of the previous
state) while fewer than `full_every` iterations have passed since the last
full setup, else a full one.  The CG watchdog forces a full setup at once
when the last solve's CG count grew past max(1.5 b, b + 3) of the count b
of the first solve after the last full setup.  The stepper also carries
the ring of recent solutions that deflates CG's warm start and the
adaptive CG tolerance (`forcing_rtol`), kept on the device.
"""

from __future__ import annotations

import torch

from ..config import resolve_dtype
from ..ops.cg import recycle_init, recycle_push
from ..tracing import count

__all__ = ["Stepper", "forcing_rtol"]


def forcing_rtol(params, change):
    """The adaptive CG tolerance after a design change `change`: the
    change times cg_forcing_coeff, clipped to [cg_rtol, cg_rtol_max].
    `change` is a host float (None before the first iteration, which takes
    cg_rtol_max), or a device scalar, which gives a device scalar in its
    dtype with no host read."""
    if change is None:
        return params.cg_rtol_max
    rtol = params.cg_forcing_coeff * change
    if isinstance(rtol, torch.Tensor):
        return torch.clamp(rtol, min=params.cg_rtol, max=params.cg_rtol_max)
    return min(params.cg_rtol_max, max(params.cg_rtol, rtol))


class Stepper:
    """The carried state of a voxel SIMP run and the schedule that steps it.

    `design`, `u`, `pvecs` (the preconditioner's power vectors), `rhist`
    (the recycle ring of `recycle_k` solutions, stored in `recycle_dtype`,
    "" for the step's dtype; None for k <= 1) and `rtol_now` (the next
    solve's CG tolerance, None unless `adaptive`) may be set between
    iterations.  The counters `steps_since_setup`, `steps_since_full`,
    `cg_baseline`, `last_cg` and `pending_cg` and the preconditioner
    `state` drive the schedule; a fresh stepper starts with a full setup.
    """

    def __init__(self, vs, params, *, recycle_k, adaptive, setup_every,
                 full_every, recycle_dtype=""):
        self.vs, self.params = vs, params
        self.adaptive = adaptive
        self.setup_every = setup_every
        self.full_every = full_every
        self.light_ok = full_every > 1 and vs.precond.supports_light_setup
        self.rtol_now = (torch.tensor(params.cg_rtol_max, dtype=vs.dtype,
                                      device=vs.device)
                         if adaptive else None)
        self.recycle_k = recycle_k
        self.recycle_dtype = (resolve_dtype(recycle_dtype, vs.device)
                              if recycle_dtype else None)
        self.design, self.u = vs.design0, vs.u0
        self.pvecs = vs.precond.init_power_vectors()
        self.rhist = None
        self.reset_recycle()
        self.state = None
        self.steps_since_setup = 0
        self.steps_since_full = 0
        self.cg_baseline = None
        self.last_cg = None
        self.pending_cg = None

    def cold_power(self):
        """The one-time cold lambda_max estimation on the current design."""
        self.pvecs = self.vs.power_init(self.design)

    def reset_recycle(self):
        """Seed the ring from the current warm start (after the design and
        displacements were set from elsewhere)."""
        if self.recycle_k > 1:
            self.rhist = recycle_init(self.recycle_k, self.u,
                                      dtype=self.recycle_dtype)

    def force(self, change):
        """With adaptive forcing, the next solve's tolerance from a design
        change (a device scalar or a host float)."""
        if self.adaptive:
            self.rtol_now = forcing_rtol(self.params, torch.as_tensor(
                change, dtype=self.vs.dtype, device=self.vs.device))

    def _setup(self):
        """The preconditioner setup that is due before this iteration, if
        any."""
        vs = self.vs
        if self.pending_cg is not None:
            # the previous iteration's CG count, read at the start of this
            # one as the JAX bench reads it
            self.last_cg, self.pending_cg = self.pending_cg, None
            if self.cg_baseline is None:
                self.cg_baseline = self.last_cg
        # additive slack: at CG counts of ~2, 1.5x alone would refresh on
        # one extra iteration
        degraded = (self.last_cg is not None and self.cg_baseline
                    and self.last_cg > max(1.5 * self.cg_baseline,
                                           self.cg_baseline + 3))
        if self.state is None or degraded \
                or self.steps_since_setup >= self.setup_every:
            # light (fine-half) setup unless the full cadence expired, CG
            # degraded or there is no state yet; the watchdog's baseline
            # pins to the last full setup
            if (self.light_ok and self.state is not None and not degraded
                    and self.steps_since_full < self.full_every):
                self.state, self.pvecs = vs.setup(self.design, self.pvecs,
                                                  self.state)
            else:
                if degraded:
                    count("setup.watchdog")
                self.state, self.pvecs = vs.setup(self.design, self.pvecs)
                self.steps_since_full = 0
                self.cg_baseline = None
            self.steps_since_setup = 0
        self.steps_since_setup += 1
        self.steps_since_full += 1

    def advance(self):
        """One SIMP iteration from the carried state, which moves on to the
        new design.  Returns the step's `StepOutput` and the design change
        max|new - old| as a device scalar."""
        self._setup()
        out = self.vs.step(self.design, self.u, self.state,
                           recycle=self.rhist, rtol=self.rtol_now)
        self.pending_cg = out.cg_iters
        if self.rhist is not None:
            self.rhist = recycle_push(self.rhist, out.u)
        change = (out.new_design - self.design).abs().max()
        self.force(change)
        self.design, self.u = out.new_design, out.u
        return out, change

    def one_step(self):
        """One SIMP iteration; returns (energy as a device scalar, CG
        iterations)."""
        out, _ = self.advance()
        return out.energy, out.cg_iters
