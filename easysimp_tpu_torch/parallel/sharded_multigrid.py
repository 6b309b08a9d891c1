"""The geometric multigrid V-cycle over a device mesh.

`ShardedMultigrid` is `MultigridPreconditioner` (ops/multigrid.py) on
sharded fields.  GSPMD partitions the reference's hierarchy; here the rule
is explicit:

* A level is distributed while every split axis keeps at least two cells
  per shard there and the level is not the coarsest.  Its operator is a
  `HaloVoxelOperator` (level 0: the `voxel_matvec` kernel once per shard;
  coarser levels: the Galerkin stencil applied on each shard's block with a
  one-node halo).
* Below that, the residual is gathered onto the mesh's first device and the
  rest of the cycle runs there as on one device: any further levels and the
  dense scaled Cholesky of the coarsest.  The correction's slices go back
  to the shards.
* Stencils are built by extend-and-crop: levels 1-3 from the fine moduli
  (a level-L coarse node reads the fine cells within 2^L of it, so the
  moduli are extended by 2^L cells), deeper levels as the RAP of the
  previous level's stencil (extended by two nodes below and one above,
  which keeps the factor-2 alignment).  Restriction needs the same two and
  one node planes, prolongation one plane above.
* Power iteration runs on sharded fields with global dots; its hash start
  vector is made globally and split, so it is the reference's.

Everything else (the V- or W-cycle, the Chebyshev smoother, the setup's
order of work, light setups, the cycle dtype) is the base class's code,
running on sharded fields through their elementwise ops; this class
overrides only the hooks that reach across shards.
"""

from __future__ import annotations

import torch

from ..ops import multigrid as mgm
from ..ops.cuda_kernels import stencil_apply_plain
from ..ops.stencil import (
    apply_stencil_padded,
    level_stencil_diag_from_scale,
    level_stencil_from_scale,
)
from .halo import HaloVoxelOperator, extend, own
from .sharding import GridLayout, ShardedField

__all__ = ["ShardedMultigrid"]


def _gathered(f):
    return f.gather() if isinstance(f, ShardedField) else f


class ShardedMultigrid(mgm.MultigridPreconditioner):
    """The V-cycle preconditioner of a `HaloVoxelOperator`; the arguments
    after it are `MultigridPreconditioner`'s.  `n_distributed` levels run
    on the shards, the rest on the mesh's first device."""

    def __init__(self, fine_op: HaloVoxelOperator, **kw):
        super().__init__(fine_op.base, **kw)
        layout = fine_op.layout
        self.layouts = [layout]
        for lvl in range(1, self.n_levels - 1):
            nels = self.ops[lvl].grid.nels
            if not all(p == 1 or (n % p == 0 and n // p >= 2)
                       for n, p in zip(nels, layout.mesh_shape)):
                break
            self.layouts.append(GridLayout(layout.mesh, nels))
        self.n_distributed = len(self.layouts)
        same = self.cycle_ops is self.ops
        for lvl, lay in enumerate(self.layouts):
            self.ops[lvl] = (fine_op if lvl == 0
                             else HaloVoxelOperator(self.ops[lvl], lay))
            if not same:
                self.cycle_ops[lvl] = HaloVoxelOperator(self.cycle_ops[lvl],
                                                        lay)

    def _distributed(self, lvl):
        return lvl < self.n_distributed

    # ----- setup hooks ----------------------------------------------------
    def _hash_vector(self, lvl):
        v = super()._hash_vector(lvl)
        return self.layouts[lvl].split(v, "node") if self._distributed(lvl) \
            else v

    def _coarsen_fields(self, scale, free_mask):
        scales, masks = [scale], [free_mask]
        for lvl in range(1, self.n_levels):
            prev = scales[-1]
            if self._distributed(lvl):
                scales.append(ShardedField(
                    [mgm.coarsen_cells(b, self.coarsen) for b in prev.blocks],
                    self.layouts[lvl], "cell"))
            else:
                scales.append(mgm.coarsen_cells(_gathered(prev),
                                                self.coarsen))
            masks.append(self._coarsen_mask(lvl, masks[-1]))
        return scales, masks

    def _coarsen_mask(self, lvl, mask):
        if self._distributed(lvl):
            # owned node blocks start on even planes: injection stays local
            return ShardedField([mgm.coarsen_mask(b) for b in mask.blocks],
                                self.layouts[lvl], "node")
        return mgm.coarsen_mask(_gathered(mask))

    def _from_fine(self, scale, lvl, kind, build):
        """build(block) on the fine moduli extended by 2^lvl cells, cropped
        to the level-`lvl` owned nodes."""
        s = 1 << lvl
        blocks, starts = extend(scale, (s, s, s), (s, s, s))
        lay = self.layouts[lvl]
        return ShardedField(
            [own(build(b), [x // s for x in st], lay, kind, i)
             for i, (b, st) in enumerate(zip(blocks, starts))], lay, kind)

    def _stencil_from_scale(self, scale, lvl, out_dtype=None, x_chunks=1):
        if not self._distributed(lvl):
            return super()._stencil_from_scale(_gathered(scale), lvl,
                                               out_dtype, x_chunks)
        return self._from_fine(scale, lvl, "coef", lambda b: (
            level_stencil_from_scale(
                b, self._Gm[lvl], lvl, out_dtype=out_dtype,
                x_chunks=min(x_chunks, (b.shape[0] >> lvl) + 1))))

    def _stencil_diag_from_scale(self, scale, lvl):
        if not self._distributed(lvl):
            return super()._stencil_diag_from_scale(_gathered(scale), lvl)
        return self._from_fine(scale, lvl, "node", lambda b: (
            level_stencil_diag_from_scale(b, self._Gm[lvl], lvl)))

    def _coarsen_stencil(self, lvl, prev):
        if not self._distributed(lvl):
            return super()._coarsen_stencil(lvl, _gathered(prev))
        blocks, starts = extend(prev, (2, 2, 2), (1, 1, 1))
        lay = self.layouts[lvl]
        return ShardedField(
            [own(mgm.coarsen_stencil(b), [x // 2 for x in st], lay, "coef", i)
             for i, (b, st) in enumerate(zip(blocks, starts))], lay, "coef")

    # ----- cycle hooks ------------------------------------------------------
    def _stencil_apply(self, stencil, mask, v, r=None):
        """A distributed level keeps the plain composition with a halo on
        each shard (the kernel takes no halo); the levels on the first
        device take the base class's kernel."""
        if isinstance(stencil, ShardedField):
            return stencil_apply_plain(stencil, mask, v, r,
                                       apply=_sharded_stencil_apply)
        return super()._stencil_apply(stencil, mask, v, r)

    def _restrict(self, lvl, f):
        """Level-`lvl` node field -> level lvl+1 (sharded, or gathered on
        the first device when lvl+1 is not distributed)."""
        if not self._distributed(lvl + 1):
            return mgm.restrict(_gathered(f))
        blocks, starts = extend(f, (2, 2, 2), (1, 1, 1))
        lay = self.layouts[lvl + 1]
        return ShardedField(
            [own(mgm.restrict(b), [x // 2 for x in st], lay, "node", i)
             for i, (b, st) in enumerate(zip(blocks, starts))], lay, "node")

    def _prolong(self, lvl, xc):
        """Level lvl+1 node field -> level `lvl` (sharded where `lvl` is
        distributed)."""
        if not self._distributed(lvl):
            return mgm.prolong(xc)
        lay = self.layouts[lvl]
        if not isinstance(xc, ShardedField):
            return lay.split(mgm.prolong(xc), "node")
        blocks, starts = extend(xc, (0, 0, 0), (1, 1, 1))
        return ShardedField(
            [own(mgm.prolong(b), [2 * x for x in st], lay, "node", i)
             for i, (b, st) in enumerate(zip(blocks, starts))], lay, "node")


def _sharded_stencil_apply(C, u):
    """apply_stencil on every shard: u's owned blocks with a one-node halo
    (zero outside the grid) against the owned stencil coefficients."""
    blocks, _ = extend(u, (1, 1, 1), (1, 1, 1), zero_fill=True)
    return ShardedField(
        [apply_stencil_padded(c, torch.movedim(b, -1, 0))
         for c, b in zip(C.blocks, blocks)], u.layout, "node")
