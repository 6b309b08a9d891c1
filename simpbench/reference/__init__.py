"""The plain reference that decides `correct`, and the control.

`judge` follows the program step by step: for each recorded iteration it
takes the design the program started the iteration from and the
displacements, energy and new design the program produced, and measures in
float64 how far they are from what the SIMP iteration defines:

  residual     ||f - K(x) u|| / ||f|| on the free dofs: the solve;
  energy_gap   |E - u^T K(x) u / 2| / (u^T K(x) u / 2): the energy;
  design_gap   max |x_new - OC(x, filter(dc(x, u)))|: sensitivities,
               filter and OC update;
  step_gap     ||x_new - x_ref|| / ||x_ref - x||, x_ref that OC update:
               the same, as a share of the step the iteration should
               take, so a step left untaken reads 1 however small it is.

`step` is the reference put in the program's place (Jacobi-preconditioned
CG, then the same update), which the control runs in TF32.
"""

from __future__ import annotations

import importlib

import torch

from .common import forcing_rtol, oc_update, pcg


def module(kind):
    """The reference of a kind of configuration: `reference/<kind>.py`."""
    name = f"{__name__}.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference for the kind {kind!r}: no module "
                         f"{name}") from None


def problem(config, nels, device, precision="float64"):
    """The configuration's plain problem on an `nels` grid: its kind's
    `Problem`."""
    return module(config["kind"]).Problem(config, nels, device, precision)


def _oc(P, x, fdc):
    m = P.m
    return oc_update(x, fdc, P.cell_volume / P.total_volume, P.cell_volume,
                     m["volume_fraction"], P.total_volume, m["move_limit"],
                     m["damping"])


def judge_iteration(P, x_in, u, energy, x_out):
    """{residual, energy_gap, design_gap, step_gap} of one iteration of the program,
    measured in P's precision (float64 for the judge)."""
    x = P.cells(x_in)
    um = P.mask * P.nodes(u)
    E = P.modulus(x)
    Ku = P.apply_K(um, E)
    r = P.mask * (P.f - Ku)
    e_ref = 0.5 * float((um * Ku).sum())
    fdc = P.sensitivity_filter(x, P.sensitivities(x, um))
    x_ref = _oc(P, x, fdc)
    return {
        "residual": float(torch.linalg.vector_norm(r)
                          / torch.linalg.vector_norm(P.mask * P.f)),
        "energy_gap": abs(float(energy) - e_ref) / max(abs(e_ref), 1e-300),
        "design_gap": float((P.cells(x_out) - x_ref).abs().max()),
        "step_gap": float(torch.linalg.vector_norm(P.cells(x_out) - x_ref)
                          / max(float(torch.linalg.vector_norm(x_ref - x)),
                                1e-300)),
    }


def step(P, x, u_prev, rtol, maxiter):
    """One SIMP iteration of the reference from design x and warm start
    u_prev: (x_new, u, energy, CG iterations, recurrence residual)."""
    E = P.modulus(x)
    b = P.mask * P.f
    u, k, res = pcg(lambda v: P.A(v, E), b, P.mask * u_prev, P.diag(E),
                    rtol, maxiter)
    # the compliance as the textbook SIMP code sums it, over the elements
    energy = 0.5 * (E * P.energies(u)).sum()
    fdc = P.sensitivity_filter(x, P.sensitivities(x, u))
    return _oc(P, x, fdc), u, energy, k, res


__all__ = ["module", "problem", "judge_iteration", "step", "forcing_rtol"]
