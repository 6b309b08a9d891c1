"""Gripper compliant mount (port of examples/04_gripper_complex.py, the
analogue of test/Examples/04_gripper_complex.jl).

Imported hex mesh (stul14.vtu, not part of this repository: its path is
the first argument), circular fixed support, X-symmetry plane, leg +
camera point loads, 6 m/s^2 body force.
Run:  python -m easysimp_tpu_torch.examples.04_gripper_complex \
          path/to/stul14.vtu [results_dir] [--device cpu]
"""

from easysimp_tpu_torch import simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import gripper


def main(mesh_path, results_dir="./results/04_gripper", device="cuda"):
    mesh, loads, bcs, params, accel = gripper.build(mesh_path)
    params.export_path = results_dir
    params.task_name = "04_gripper"
    return simp_optimize(mesh, loads, bcs, params, accel, device=device)


if __name__ == "__main__":
    run(main, "results_dir", required=("mesh_path",), doc=__doc__)
