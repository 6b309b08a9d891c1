"""Batch tolerance study: 4-corner-fixed 2x1x1 beam.

Port of examples/05_3D_2x1x1_4Legs_tol_study.py (analogue of
test/Examples/05_3D_2x1x1_4Legs_tol_study.jl): run the 4-legs problem
across the tolerance ladder {0.16, 0.08, 0.04, 0.02, 0.01, 0.005} with a
duplicated first tolerance as an untimed warmup, and emit the cross-run
timing/energy summary table.

Run:  python -m easysimp_tpu_torch.examples.05_3D_2x1x1_4Legs_tol_study \
          [results_dir] [--device cpu]
"""

from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models.beam_2x1x1 import build_four_legs
from easysimp_tpu_torch.models.tol_study import (
    DEFAULT_TOLERANCES,
    run_tolerance_study,
)


def main(results_dir="./results/05_4legs_tol_study", device="cuda"):
    return run_tolerance_study(
        build_four_legs,
        tolerances=DEFAULT_TOLERANCES,
        results_root=results_dir,
        task_name="05_4legs",
        max_iterations=3000,
        device=device,
    )


if __name__ == "__main__":
    run(main, "results_dir", doc=__doc__)
