"""Batch tolerance-study harness.

Reproduces the reference's study scripts
(test/Examples/05_3D_2x1x1_4Legs_tol_study.jl:192-385 and 06/07/08 twins):
loop over a tolerance ladder, duplicate the FIRST tolerance as a warmup run
for fair timing (07_...tol_study.jl:45-47; here it pays for the kernels'
build and the device's first allocations), time each full
optimization, write per-run summaries, and emit the cross-run comparison
table (energy / volume fraction / iterations / wall time per tolerance) to
stdout and a batch summary file.  Port of easysimp_tpu/models/tol_study.py;
`run_tolerance_study` takes the device.
"""

from __future__ import annotations

import os
import time

from ..utils.terminal import print_info, print_success

__all__ = ["run_tolerance_study", "DEFAULT_TOLERANCES"]

DEFAULT_TOLERANCES = (0.16, 0.08, 0.04, 0.02, 0.01, 0.005)


def run_tolerance_study(build, tolerances=DEFAULT_TOLERANCES,
                        results_root=None, task_name="tol_study",
                        warmup=True, device="cuda", **overrides):
    """Run `build(tolerance=tol, **overrides)` across the tolerance ladder.

    Args:
      build: a model's `build_*` function, returning (grid, loads, bcs,
        params, accel), e.g. models.beam_2x1x1.build_four_legs.
      tolerances: ladder, coarsest first.
      results_root: if set, per-run exports land in
        <root>/<task_name>_<NN>tol and the batch table is written there too.
      warmup: duplicate the first tolerance as a warmup run (untimed, not
        in the table).
      device: where the runs live, "cuda[:N]" (the default) or "cpu".

    Returns list of row dicts (one per timed run).
    """
    from ..opt.optimize import simp_optimize

    schedule = ([tolerances[0]] if warmup else []) + list(tolerances)
    rows = []
    for i, tol in enumerate(schedule):
        is_warmup = warmup and i == 0
        run_name = f"{task_name}_{int(round(tol * 100)):02d}tol"
        kwargs = dict(overrides)
        kwargs["tolerance"] = tol
        if results_root and not is_warmup:
            export_path = os.path.join(results_root, run_name)
            os.makedirs(export_path, exist_ok=True)
            kwargs["export_path"] = export_path
            kwargs["task_name"] = run_name
        grid, loads, bcs, params, accel = build(**kwargs)

        print_info(("[warmup] " if is_warmup else "") +
                   f"Running tolerance {tol}")
        t0 = time.time()
        result = simp_optimize(grid, loads, bcs, params, accel,
                               device=device)
        elapsed = time.time() - t0
        if is_warmup:
            continue
        rows.append({
            "tolerance": tol,
            "energy": result.energy,
            "volume_fraction": result.volume / grid.total_volume,
            "iterations": result.iterations,
            "converged": result.converged,
            "wall_time_s": elapsed,
        })

    table = _format_table(rows)
    print(table)
    if results_root:
        os.makedirs(results_root, exist_ok=True)
        path = os.path.join(results_root, f"{task_name}_batch_summary.txt")
        with open(path, "w") as fh:
            fh.write(table + "\n")
        print_success(f"Batch summary written: {path}")
    return rows


def _format_table(rows):
    header = (
        f"{'Tolerance':>10} | {'Energy':>14} | {'Vol.Frac':>9} | "
        f"{'Iters':>6} | {'Conv':>5} | {'Time [s]':>9}"
    )
    lines = ["=" * len(header), "TOLERANCE STUDY SUMMARY",
             "=" * len(header), header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r['tolerance']:>10.4g} | {r['energy']:>14.6e} | "
            f"{r['volume_fraction']:>9.4f} | {r['iterations']:>6d} | "
            f"{str(r['converged']):>5} | {r['wall_time_s']:>9.2f}"
        )
    lines.append("=" * len(header))
    return "\n".join(lines)
