"""Multi-device cantilever: domain decomposition over a device mesh.

Port of examples/10_sharded_cantilever.py (no reference analogue: the
reference is single-threaded).  The voxel grid is split over a mesh of
`shards` shards, placed on the visible cards round-robin (one card holds
them all when it is the only one), and runs the same SIMP iteration with
explicit halo exchanges (easysimp_tpu_torch/parallel/).  With
--device cpu the shards are CPU devices.

Run:  python -m easysimp_tpu_torch.examples.10_sharded_cantilever \
          [nx ny nz] [--device cpu] [--shards N]
      (default shards: the visible cards; 4 with --device cpu)
"""

import torch

from easysimp_tpu_torch import simp_optimize
from easysimp_tpu_torch.examples._cli import run
from easysimp_tpu_torch.models import cantilever
from easysimp_tpu_torch.parallel.sharding import (
    best_mesh_shape,
    make_mesh,
    round_robin_cards,
)


def main(nx=64, ny=32, nz=16, device="cuda", shards=None):
    nels = (int(nx), int(ny), int(nz))
    grid, loads, bcs, params, accel = cantilever.build_basic(
        nels=nels, max_iterations=30, tolerance=0.01)
    if torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * (shards or 4)
    else:
        devices = round_robin_cards(shards or torch.cuda.device_count())
    n_dev = len(devices)
    mesh = make_mesh(n_dev, shape=best_mesh_shape(n_dev, nels),
                     devices=devices)
    print(f"Running on {n_dev} shards ({[str(d) for d in devices]}), "
          f"mesh {mesh.shape}")
    return simp_optimize(grid, loads, bcs, params, accel, mesh=mesh,
                         device=device)


if __name__ == "__main__":
    run(main, "nx", "ny", "nz", doc=__doc__, options={"shards": int})
