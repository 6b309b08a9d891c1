"""Sliding-support cantilever (port of examples/02_sliding_support.py, the
analogue of test/Examples/02_sliding_support.jl).

X-sliding wall + Y-roller support, load on the far top edge.
Run:  python -m easysimp_tpu_torch.examples.02_sliding_support \
          [results_dir] [--device cpu]
"""

from easysimp_tpu_torch import simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import cantilever


def main(results_dir="./results/02_sliding_support", device="cuda"):
    grid, loads, bcs, params, accel = cantilever.build_sliding()
    params.export_path = results_dir
    params.task_name = "02_sliding_support"
    return simp_optimize(grid, loads, bcs, params, accel, device=device)


if __name__ == "__main__":
    run(main, "results_dir", doc=__doc__)
