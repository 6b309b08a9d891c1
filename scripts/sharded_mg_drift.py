"""Where the float32 sharded V-cycle drifts from the one-device cycle.

    python3 scripts/sharded_mg_drift.py [--nels 128] [--mesh 4 1 1] [--device cuda]

Builds the bench cantilever's multigrid preconditioner at `nels`^3 float32
(moduli of a mild design, a masked random residual; `chip_smoke.py`'s
`mg_problem`, seed 0) on one device and over a mesh whose shards all sit on
that device, and prints, each as max|difference| / max|one-device value|:

  M(r)         one cycle, sharded against one device;
  stencil L    the level-L Galerkin stencil (gathered) against one device's;
  cho swapped  the one-device cycle with only the sharded coarsest Cholesky
               factor put in, against the one-device cycle;
  cho, cheb    the sharded cycle with the one-device coarsest factor (and
    from one   then also its Chebyshev bounds) put in, against one device.

The same in float64 is printed last, for scale.  Exits non-zero without a
CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import easysimp_tpu_torch as pt  # noqa: E402
from easysimp_tpu_torch.ops.multigrid import (  # noqa: E402
    MultigridPreconditioner,
)
from easysimp_tpu_torch.parallel.halo import HaloVoxelOperator  # noqa: E402
from easysimp_tpu_torch.parallel.sharded_multigrid import (  # noqa: E402
    ShardedMultigrid,
)
from easysimp_tpu_torch.parallel.sharding import (  # noqa: E402
    GridLayout,
    make_mesh,
)


def drift(nels, shape, dtype, device):
    kw = dict(smooth_iters=(1, 2))
    op, mask, scale, r = cs.mg_problem(pt, nels, dtype, device)
    mg = MultigridPreconditioner(op, **kw)
    state, _ = mg.setup(scale, mask)
    want = mg.make_M(state)(r)
    n = shape[0] * shape[1] * shape[2]
    L = GridLayout(make_mesh(n, shape=shape, devices=[device] * n), nels)
    smg = ShardedMultigrid(HaloVoxelOperator(op, L), **kw)
    S, M, R = (L.split(scale, "cell"), L.split(mask, "node"),
               L.split(r, "node"))
    sstate, _ = smg.setup(S, M)
    out = {"M(r)": cs.max_rel(L.gather(smg.make_M(sstate)(R)), want)}
    for lvl in range(1, mg.n_levels):
        a, b = sstate["stencils"][lvl], state["stencils"][lvl]
        a = a.gather() if not isinstance(a, torch.Tensor) else a
        out[f"stencil {lvl}"] = cs.max_rel(a, b)
    out["cho swapped"] = cs.max_rel(
        mg.make_M(dict(state, cho=sstate["cho"]))(r), want)
    one_cho = dict(sstate, cho=state["cho"])
    out["cho from one"] = cs.max_rel(L.gather(smg.make_M(one_cho)(R)), want)
    out["cho, cheb from one"] = cs.max_rel(
        L.gather(smg.make_M(dict(one_cho, cheb=state["cheb"]))(R)), want)
    return mg.n_levels, smg.n_distributed, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nels", type=int, default=128)
    parser.add_argument("--mesh", type=int, nargs=3, default=(4, 1, 1))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu for a CPU run)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip() or card.stderr.strip(), flush=True)
    nels = (args.nels,) * 3
    for dtype in (torch.float32, torch.float64):
        levels, dist, out = drift(nels, tuple(args.mesh), dtype, args.device)
        print(f"{nels} {str(dtype)[6:]} mesh {tuple(args.mesh)} on "
              f"{args.device}: {levels} levels, {dist} distributed", flush=True)
        for k, v in out.items():
            print(f"  {k:20s} {v:.3e}", flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
