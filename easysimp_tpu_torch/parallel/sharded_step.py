"""The sharded pieces of one SIMP iteration on a voxel grid.

GSPMD partitions the reference's filters, CG reductions and OC bisection
without code; the port states each:

* the cone filter (`ShardedVoxelFilter`): the convolution runs on each
  shard's cells extended by the cone's half-width and keeps the owned
  cells, so the normalisation field W, built once the same way, is exact at
  the global edges;
* PCG (ops/cg.py) runs unchanged on sharded fields: its inner products and
  deflation Gram products take the fields' global reductions, per-shard
  partials added in shard order; the residual norm is read on the host once
  per CG iteration, as on one device;
* the OC update (ops/oc.py) runs unchanged: the candidate volumes of a pass
  are per-shard partial sums added in shard order, read on the host once
  per pass, and lambda is one number for all shards;
* the metrics and `sensitivity_health` are whole-field sums and maxima.

`material_derivative` takes the jvp of a `material_model` per shard.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.filters import VoxelFilter, _cone_kernel
from ..utils.terminal import print_data
from .halo import extend, own
from .sharding import GridLayout, ShardedField

__all__ = ["ShardedVoxelFilter", "material_derivative"]


class ShardedVoxelFilter(VoxelFilter):
    """`VoxelFilter` on sharded cell fields (same formulas, same kernel)."""

    def __init__(self, grid, filter_radius_ratio, layout: GridLayout,
                 dtype=torch.float32):
        self.grid = grid
        self.dtype = dtype
        self.layout = layout
        self.device = layout.device
        self.filter_radius = float(filter_radius_ratio) \
            * grid.characteristic_element_size
        kern = _cone_kernel(grid.spacing, self.filter_radius)
        self._padding = tuple(k // 2 for k in kern.shape)
        self._kernels = {d: torch.as_tensor(kern, dtype=dtype,
                                            device=d)[None, None]
                         for d in set(layout.devices)}
        self._kernel = self._kernels[layout.device]
        self.weight_sum = self._conv(layout.full(1.0, "cell", dtype))
        print_data(
            f"FilterCache created: {grid.n_cells} cells over "
            f"{layout.n_shards} shards, r={self.filter_radius:.4f}, "
            f"kernel={kern.shape}, interior_neighbors="
            f"{np.count_nonzero(kern)}")

    def _conv(self, x):
        """The cone convolution of each shard's cells with a halo of the
        cone's half-width."""
        L = self.layout
        blocks, starts = extend(x, self._padding, self._padding)
        out = [own(F.conv3d(b[None, None], self._kernels[d],
                            padding=self._padding)[0, 0], st, L, "cell", i)
               for i, (b, st, d) in enumerate(zip(blocks, starts, L.devices))]
        return ShardedField(out, L, "cell")


def material_derivative(material_model, phys):
    """(dlam/drho, dmu/drho) of a `material_model` at `phys` by one
    elementwise jvp (per shard on a sharded field)."""
    def jvp(p):
        return torch.func.jvp(material_model, (p,), (torch.ones_like(p),))[1]
    if isinstance(phys, torch.Tensor):
        return jvp(phys)
    return phys.map(jvp)
