"""Basic cantilever beam SIMP optimization.

Port of examples/01_basic_cantilever.py (the reference workload
test/Examples/01_basic_cantilever.jl, test/runtests.jl:16-106): 60x20x4 hex
cantilever, fixed wall at x=0, unit tip load on a circular node set,
vf=0.4, p=3, filter radius 2.5.

Run:  python -m easysimp_tpu_torch.examples.01_basic_cantilever \
          [results_dir] [--device cpu]
"""

from easysimp_tpu_torch import print_data, print_success, simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import cantilever
from easysimp_tpu_torch.post.vtu import (
    create_results_data,
    export_results_vtu,
)


def main(results_dir="./results/01_basic_cantilever", device="cuda"):
    grid, loads, bcs, params, accel = cantilever.build_basic(
        max_iterations=60, tolerance=0.01)
    params.export_path = results_dir
    params.task_name = "01_basic_cantilever"
    result = simp_optimize(grid, loads, bcs, params, accel, device=device)

    data = create_results_data(grid, result)
    export_results_vtu(data, f"{results_dir}/final_results")
    print_success("Exported final_results.vtu")
    print_data(f"Final energy: {result.energy}")
    print_data(f"Iterations: {result.iterations}")
    return result


if __name__ == "__main__":
    run(main, "results_dir", doc=__doc__)
