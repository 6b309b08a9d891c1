"""Wheel under rim torque (tet import + surface traction + body force;
port of examples/09_wheel_traction.py).

The Wheel_3d configuration: Wheel_3d_coarse.msh (not part of this
repository: its path is the first argument), hub fixed, tangential rim
traction, gravity body force.
Run:  python -m easysimp_tpu_torch.examples.09_wheel_traction \
          path/to/Wheel_3d_coarse.msh [results_dir] [--device cpu]
"""

from easysimp_tpu_torch import simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import wheel


def main(mesh_path, results_dir="./results/09_wheel", device="cuda"):
    mesh, loads, bcs, params, accel = wheel.build(mesh_path)
    params.export_path = results_dir
    params.task_name = "09_wheel"
    return simp_optimize(mesh, loads, bcs, params, accel, device=device)


if __name__ == "__main__":
    run(main, "results_dir", required=("mesh_path",), doc=__doc__)
