"""Readings that a cell's correctness limits are set from, at the cell's own
size, in one process:

    python3 simpbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 --fault-seeds 201,202,203

For each of --seeds: the program's start state from the seed, one episode
of the cell's traffic, judged by the plain reference as a run judges it
(plus the set-up iterations a run draws for its check).  For each of
--control-seeds: the control, the reference itself in the program's place
in the next precision below the configuration's (TF32 for float32 with
TF32 off), from the program's start state for CONTROL_ITERATIONS
iterations, judged the same way.  For each of --fault-seeds: one episode
of the program with each fault of `faults.py` that the cell compares
planted in it, from the same start state.  One JSON line per reading on
stdout, each with `correct` as the cell's committed limits decide it
(`check.checks`, `check.is_correct`).  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from simpbench import cells, check, faults, reference, systems  # noqa: E402

CONTROL_PRECISION = {"float32": "tf32"}
CONTROL_ITERATIONS = 3
CONTROL_MAXITER = 2000


def episode_records(system, n):
    """One episode of the program from the prepared start state, copied to
    the host after each iteration: (records, CG counts)."""
    system.restore()
    records, cgs = [], []
    for _ in range(n):
        x_in = system.fields()[0].cpu()
        energy, cg = system.one_step()
        x_out, u = system.fields()
        records.append(dict(level=0, x_in=x_in, u=u.cpu(),
                            energy=float(energy), x_out=x_out.cpu(), cg=cg))
        cgs.append(cg)
    return records, cgs


def program_records(system, seed, n):
    """The program's episode from the seed's start state (set-up's drawn
    iterations first)."""
    records = []
    system.prepare(seed, records)
    episode, cgs = episode_records(system, n)
    return records + episode, cgs


def fault_records(system, seed, n, names):
    """{fault: (records, CG counts)}: an episode with each fault planted,
    all from the seed's one start state."""
    setup = []
    system.prepare(seed, setup)
    out = {}
    for name in names:
        faults.plant(system, name)
        try:
            episode, cgs = episode_records(system, n)
        finally:
            del system.one_step
        out[name] = (setup + episode, cgs)
    return out


def control_records(cell, system, seed, device):
    """The control from the program's start state for the seed: the
    reference's own iteration in the lower precision, CONTROL_ITERATIONS
    times."""
    system.prepare(seed, [])
    system.restore()
    x, u = (t.detach() for t in system.fields())
    rtol_now = getattr(getattr(system, "st", None), "rtol_now", None)
    rtol = float(rtol_now) if rtol_now is not None else \
        cell.config["params"]["cg_rtol_max"]
    P = reference.problem(cell.config, cell.grid(), device,
                          CONTROL_PRECISION[cell.config["params"]["dtype"]])
    x, u = P.cells(x), P.nodes(u)
    p = cell.config["params"]
    records, info = [], []
    for _ in range(CONTROL_ITERATIONS):
        x_new, u, energy, k, res = reference.step(P, x, u, rtol,
                                                  CONTROL_MAXITER)
        records.append(dict(level=0, x_in=x.cpu(), u=u.cpu(),
                            energy=float(energy), x_out=x_new.cpu(), cg=k))
        info.append({"cg": k, "recurrence_residual": res, "rtol": rtol})
        rtol = reference.forcing_rtol(float((x_new - x).abs().max()),
                                      p["cg_forcing_coeff"], p["cg_rtol"],
                                      p["cg_rtol_max"])
        x = x_new
    return records, info


def reading(cell, kind, seed, records, info, device, t0, fault=None):
    """One line: the values, and `correct` under the cell's limits."""
    t1 = time.perf_counter()
    values = check.measure(cell, records, device)
    checks = check.checks(cell, values)
    line = {"kind": kind, "seed": seed, "values": values,
            "correct": check.is_correct(checks), "checks": checks,
            "iterations": info, "run_s": t1 - t0,
            "judge_s": time.perf_counter() - t1}
    if fault is not None:
        line["fault"] = fault
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nels", default="",
                        help="voxels per axis, to rehearse at a tiny size")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    cell = cells.load_cell(args.workload, overrides={
        "nels": [int(v) for v in args.nels.split(",")]} if args.nels else None)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    stdout, sys.stdout = sys.stdout, sys.stderr
    try:
        system = systems.build(cell, device)
        n = cell.traffic["episode_iterations"]

        def emit(line):
            print(json.dumps(line), file=stdout, flush=True)

        for seed in seeds(args.seeds):
            t0 = time.perf_counter()
            records, info = program_records(system, seed, n)
            emit(reading(cell, "program", seed, records, info, device, t0))
        for seed in seeds(args.control_seeds):
            t0 = time.perf_counter()
            records, info = control_records(cell, system, seed, device)
            emit(reading(cell, "control", seed, records, info, device, t0))
        for seed in seeds(args.fault_seeds):
            t0 = time.perf_counter()
            for name, (records, info) in fault_records(
                    system, seed, n, faults.for_cell(cell)).items():
                emit(reading(cell, "fault", seed, records, info, device, t0,
                             fault=name))
                t0 = time.perf_counter()
    finally:
        sys.stdout = stdout
    return 0


if __name__ == "__main__":
    sys.exit(main())
