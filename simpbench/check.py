"""`correct`: the program's recorded iterations judged by the plain
reference, each number beside the cell's limit.

A record is one iteration the program ran (`level`: 0 the cell's grid, 1
the half-resolution prelude; `x_in`, `u`, `energy`, `x_out` as the program
produced them) or an exact check of a state the benchmark can rebuild
itself (`exact`: the seeded start design, the prolonged design, the tet
mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference
from .cells import start_design

NUMBERS = ("residual", "energy_gap", "design_gap", "step_gap")


def _exact(cell, rec):
    if rec["exact"] == "mesh":               # the program's tet mesh
        coords, conn = reference.module(cell.config["kind"]).mesh(
            cell.grid(rec["level"]))
        got_coords = np.asarray(rec["coords"], dtype=np.float64)
        got_conn = np.asarray(rec["conn"])
        if got_coords.shape != coords.shape or got_conn.shape != conn.shape:
            return float("inf")
        return float(np.abs(got_coords - coords).max()
                     + (got_conn != conn).sum())
    got = rec["got"].double().numpy()
    if rec["exact"] == "start_design":
        want = start_design(cell.config, rec["seed"], got.shape)
    else:                                   # prolonged by repetition
        want = rec["coarse"].double().numpy()
        for axis in range(want.ndim):
            want = np.repeat(want, 2, axis=axis)
    want = torch.as_tensor(want).to(rec["got"].dtype).double().numpy()
    return float(np.abs(got - want).max())


def measure(cell, records, device):
    """{number: worst value over the records} in float64."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    worst["start_gap"] = 0.0
    problems = {}
    for rec in records:
        if "exact" in rec:
            worst["start_gap"] = max(worst["start_gap"], _exact(cell, rec))
            continue
        level = rec["level"]
        if level not in problems:
            problems[level] = reference.problem(cell.config,
                                                cell.grid(level), device)
        got = reference.judge_iteration(problems[level], rec["x_in"],
                                        rec["u"], rec["energy"],
                                        rec["x_out"])
        for k in NUMBERS:
            # a NaN reads as infinitely far off
            v = got[k] if np.isfinite(got[k]) else float("inf")
            worst[k] = max(worst[k], v)
    if not problems:                        # nothing judged is no pass
        worst.update(dict.fromkeys(NUMBERS, float("inf")))
    return worst


def checks(cell, values):
    """{number: {"value", "limit"}} in the cell's order of limits."""
    return {k: {"value": values[k], "limit": cell.limits[k]}
            for k in cell.limits}


def is_correct(checks_):
    return all(c["value"] <= c["limit"] for c in checks_.values())
