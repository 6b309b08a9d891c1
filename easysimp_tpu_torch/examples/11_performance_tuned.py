"""Single-card production tuning: the bench's 128^3 configuration.

Port of examples/11_performance_tuned.py (no reference analogue: the
reference's CHOLMOD solve has no solver knobs).  The configuration that
`python -m easysimp_tpu_torch.bench` measures at 128^3:

  * Galerkin geometric multigrid with per-level Chebyshev smoothing (1, 2);
  * a bfloat16 V-cycle interior (`mg_cycle_dtype`; CG itself stays float32
    and converges to `cg_rtol`): the cycle's matvecs run the bfloat16
    storage path of the voxel_matvec kernel;
  * subspace-recycled CG (`cg_recycle_k`): deltas of the last k solutions
    deflate the warm-start residual;
  * adaptive CG forcing (`cg_forcing="adaptive"`): the solve tolerance is
    rtol_i = 0.05 * change_{i-1}, clipped to [cg_rtol, cg_rtol_max];
  * a checkpoint every 10 iterations (`resume_from` continues from it).

The bench runs this configuration's trajectory after a 64^3 continuation
prelude; on an NVIDIA H100 80GB HBM3 with a 700.00 W power limit it read
24.416 SIMP iterations/s over fine iterations 2-60 at 128^3, 32.428 in
the late window (iterations 51-60, CG 1-2), 3.454 s for the 40-iteration
prelude (PERF.md, section 6).  This script itself, cold from a uniform
design and with checkpoints, was not timed on the card.

Run:  python -m easysimp_tpu_torch.examples.11_performance_tuned \
          [nx ny nz] [--device cpu]
"""

import os

from easysimp_tpu_torch import OptimizationParameters, simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import cantilever


def main(nx=128, ny=128, nz=128, device="cuda",
         checkpoint_path="./results/11_performance_tuned/simp_ckpt.npz"):
    nels = (int(nx), int(ny), int(nz))
    grid, loads, bcs, params, accel = cantilever.build_basic(
        nels=nels, max_iterations=50, tolerance=0.01)
    os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
    tuned = OptimizationParameters(**{
        **params.__dict__,
        "dtype": "float32",
        "cg_rtol": 1e-5,
        "cg_maxiter": 500,
        "cg_recycle_k": 8,
        "cg_forcing": "adaptive",
        "preconditioner": "multigrid",
        "mg_smooth_iters": (1, 2),
        "mg_cycle_dtype": "bfloat16",
        "checkpoint_interval": 10,
        "checkpoint_path": checkpoint_path,
    })
    return simp_optimize(grid, loads, bcs, tuned, accel, device=device)


if __name__ == "__main__":
    run(main, "nx", "ny", "nz", doc=__doc__)
