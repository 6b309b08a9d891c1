"""MBB-beam batch tolerance study.

Port of examples/06_3D_2x1x1_MBB_tol_study.py
(analogue of 06_3D_2x1x1_MBB_tol_study.jl).

Run:  python -m easysimp_tpu_torch.examples.\
06_3D_2x1x1_MBB_tol_study [results_dir] [--device cpu]
"""

from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models.beam_2x1x1 import build_mbb
from easysimp_tpu_torch.models.tol_study import (
    DEFAULT_TOLERANCES,
    run_tolerance_study,
)


def main(results_dir="./results/06_mbb_tol_study", device="cuda"):
    return run_tolerance_study(
        build_mbb, tolerances=DEFAULT_TOLERANCES,
        results_root=results_dir, task_name="06_mbb",
        max_iterations=3000, device=device)


if __name__ == "__main__":
    run(main, "results_dir", doc=__doc__)
