"""Cantilever with body force (port of examples/03_with_acceleration.py,
the analogue of test/Examples/03_with_acceleration.jl).

Polymer beam, 1 kN tip load plus a 6 m/s^2 acceleration body force.
Run:  python -m easysimp_tpu_torch.examples.03_with_acceleration \
          [results_dir] [--device cpu]
"""

from easysimp_tpu_torch import simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import cantilever


def main(results_dir="./results/03_with_acceleration", device="cuda"):
    grid, loads, bcs, params, accel = cantilever.build_acceleration()
    params.export_path = results_dir
    params.task_name = "03_with_acceleration"
    return simp_optimize(grid, loads, bcs, params, accel, device=device)


if __name__ == "__main__":
    run(main, "results_dir", doc=__doc__)
