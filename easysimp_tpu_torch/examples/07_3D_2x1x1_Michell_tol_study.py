"""Michell-beam batch tolerance study.

Port of examples/07_3D_2x1x1_Michell_tol_study.py
(analogue of 07_3D_2x1x1_Michell_tol_study.jl).

Run:  python -m easysimp_tpu_torch.examples.\
07_3D_2x1x1_Michell_tol_study [results_dir] [--device cpu]
"""

from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models.beam_2x1x1 import build_michell
from easysimp_tpu_torch.models.tol_study import (
    DEFAULT_TOLERANCES,
    run_tolerance_study,
)


def main(results_dir="./results/07_michell_tol_study", device="cuda"):
    return run_tolerance_study(
        build_michell, tolerances=DEFAULT_TOLERANCES,
        results_root=results_dir, task_name="07_michell",
        max_iterations=3000, device=device)


if __name__ == "__main__":
    run(main, "results_dir", doc=__doc__)
