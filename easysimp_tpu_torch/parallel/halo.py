"""The halo exchange and the sharded voxel operator.

Counterpart of easysimp_tpu/parallel/halo.py:53-203.  The reference keeps
that module as hand-scheduled scaffolding beside GSPMD; here it is the
production path.  Every operation with a finite reach runs the unchanged
single-device function on each shard's block extended by that reach, and
keeps the owned part.  The extension is clipped to the global grid, so the
global edges keep their zero padding and their normalisation, and every
owned point gets the arithmetic it gets on one device.

`extend` is the exchange: one axis after another (x, then y, then z), each
shard's block grows by the planes its neighbours own, taken from the
neighbours' blocks as already extended along the earlier axes, so edges and
corners arrive without a 26-neighbour exchange.  A reach wider than a
neighbour's block takes planes from the shards beyond it.  Planes move by
`.to(device)` (a peer copy where the mesh spans cards) and are joined with
`torch.cat` (a device-local copy where shards share one).  `extend.copies`
and `extend.bytes` count the planes taken from other shards.

`HaloVoxelOperator` is `VoxelOperator` (ops/operator.py) over a mesh: the
matvec and the element energies launch the `voxel_matvec` and
`voxel_energies` CUDA kernels once per shard on its extended block.
"""

from __future__ import annotations

from functools import cached_property

import torch
import torch.nn.functional as F

from ..grids import VoxelGrid
from ..loads import voxel_body_force
from ..ops.cuda_kernels import voxel_energies, voxel_matvec
from ..ops.operator import VoxelOperator
from ..tracing import spanned
from .sharding import _RANGES, _SPATIAL, GridLayout, ShardedField

__all__ = ["extend", "own", "HaloVoxelOperator"]


@spanned("halo.extend")
def extend(field: ShardedField, lo, hi, zero_fill=False):
    """Each shard's block extended by lo[a] planes below and hi[a] above
    along grid axis a, clipped to the grid (zero-filled to the full width
    with `zero_fill`).  Returns (blocks, starts): the extended blocks in
    shard order and the global index of each block's first plane per axis
    (the unclipped one with `zero_fill`)."""
    layout, kind = field.layout, field.kind
    nd = field.blocks[0].dim()
    axes = [nd + a for a in _SPATIAL[kind]]
    table = (layout.cell_ranges if _RANGES[kind] == "cell"
             else layout.node_ranges)
    extent = layout.extent(kind)
    device = dict(zip(layout.coords, layout.devices))
    cur = dict(zip(layout.coords, field.blocks))
    starts = {c: [0, 0, 0] for c in layout.coords}
    pads = {c: [0] * 6 for c in layout.coords}
    for a in range(3):
        if lo[a] == 0 and hi[a] == 0:
            for c in layout.coords:
                starts[c][a] = table[a][c[a]][0]
            continue
        new = {}
        for c in layout.coords:
            o_lo, o_hi = table[a][c[a]]
            w_lo, w_hi = max(0, o_lo - lo[a]), min(extent[a], o_hi + hi[a])
            starts[c][a] = w_lo
            pads[c][2 * a] = w_lo - (o_lo - lo[a])
            pads[c][2 * a + 1] = (o_hi + hi[a]) - w_hi
            pieces = []
            for k, (k_lo, k_hi) in enumerate(table[a]):
                s, e = max(w_lo, k_lo), min(w_hi, k_hi)
                if s >= e:
                    continue
                src = cur[c[:a] + (k,) + c[a + 1:]]
                piece = src.narrow(axes[a], s - k_lo, e - s)
                if k != c[a]:
                    piece = piece.to(device[c])
                    extend.copies += 1
                    extend.bytes += piece.nbytes
                pieces.append(piece)
            new[c] = (pieces[0] if len(pieces) == 1
                      else torch.cat(pieces, dim=axes[a]))
        cur = new
    blocks = [cur[c] for c in layout.coords]
    if zero_fill:
        out = []
        for c, b in zip(layout.coords, blocks):
            p = pads[c]
            if any(p):
                # F.pad takes the last axis first; pad the spatial axes only
                width = [0, 0] * (nd - 1 - axes[2])
                for a in (2, 1, 0):
                    width += [p[2 * a], p[2 * a + 1]]
                b = F.pad(b, width)
            out.append(b)
        blocks = out
        starts = {c: [starts[c][a] - pads[c][2 * a] for a in range(3)]
                  for c in layout.coords}
    return blocks, [starts[c] for c in layout.coords]


extend.copies = 0
extend.bytes = 0


def own(block, start, layout: GridLayout, kind, i):
    """The owned part of shard i's `block` of a `kind` field whose first
    plane per axis has global index `start`."""
    for a, s, (lo, hi) in zip(_SPATIAL[kind], start, layout.ranges(kind, i)):
        block = block.narrow(block.dim() + a, lo - s, hi - lo)
    return block.contiguous()


class HaloVoxelOperator:
    """`VoxelOperator` over an ("x","y","z") mesh: the same methods on
    sharded fields (node fields owned-node blocks, cell fields owned-cell
    blocks).  `op` is the global single-device operator; its ke goes to
    every shard's device once."""

    def __init__(self, op: VoxelOperator, layout: GridLayout):
        if tuple(layout.nels) != tuple(op.grid.nels):
            raise ValueError(f"layout {layout.nels} for grid {op.grid.nels}")
        self.base = op
        self.layout = layout
        self.grid = op.grid
        self.E0, self.Emin, self.nu, self.p = op.E0, op.Emin, op.nu, op.p
        self.dtype = op.dtype
        self.device = layout.device
        self.ke = op.ke
        self._local = {}

    # ----- per-device constants and per-shard operators ---------------------
    @cached_property
    def _ke(self):
        return {d: self.ke.to(d) for d in set(self.layout.devices)}

    @cached_property
    def ke_lame_basis(self):
        return self.base.ke_lame_basis

    @cached_property
    def _ke_lame(self):
        return {d: tuple(k.to(d) for k in self.ke_lame_basis)
                for d in set(self.layout.devices)}

    def local_op(self, nels, device):
        """The single-device operator of a block of `nels` cells (the same
        ke), made once per block shape and device."""
        key = (tuple(nels), device)
        if key not in self._local:
            grid = VoxelGrid(nels=tuple(nels), origin=self.grid.origin,
                             spacing=self.grid.spacing)
            self._local[key] = VoxelOperator(
                grid, E0=self.E0, Emin=self.Emin, nu=self.nu, p=self.p,
                dtype=self.dtype, device=device)
        return self._local[key]

    # ----- the three halo patterns ----------------------------------------
    def nodes_from_nodes(self, fn, u, *cells):
        """Node field fn(u_ext, *cells_ext) on owned nodes, from u extended
        by one node plane each way and the cell fields by one cell below:
        exactly the cells around every owned node."""
        L = self.layout
        ub, us = extend(u, (1, 1, 1), (1, 1, 1))
        cbs = [extend(c, (1, 1, 1), (0, 0, 0))[0] for c in cells]
        out = []
        for i, dev in enumerate(L.devices):
            r = fn(ub[i], *(cb[i] for cb in cbs), dev)
            out.append(own(r, us[i], L, "node", i))
        return ShardedField(out, L, "node")

    def nodes_from_cells(self, fn, *cells, nodes=()):
        """Node field fn(*cells_ext, *nodes_ext, device) on owned nodes from
        cell fields extended by one cell below (and node fields by one node
        each way)."""
        L = self.layout
        cbs, cs = zip(*[extend(c, (1, 1, 1), (0, 0, 0)) for c in cells])
        nbs = [extend(n, (1, 1, 1), (1, 1, 1))[0] for n in nodes]
        out = []
        for i, dev in enumerate(L.devices):
            r = fn(*(cb[i] for cb in cbs), *(nb[i] for nb in nbs), dev)
            out.append(own(r, cs[0][i], L, "node", i))
        return ShardedField(out, L, "node")

    def cells_from_nodes(self, fn, u):
        """Cell field(s) fn(u_ext, device) on owned cells, from u extended by
        one node plane above: exactly the corners of every owned cell."""
        L = self.layout
        ub, us = extend(u, (0, 0, 0), (1, 1, 1))
        outs = []
        for i, dev in enumerate(L.devices):
            r = fn(ub[i], dev)
            r = r if isinstance(r, tuple) else (r,)
            outs.append(tuple(own(x, us[i], L, "cell", i) for x in r))
        fields = tuple(ShardedField([o[j] for o in outs], L, "cell")
                       for j in range(len(outs[0])))
        return fields if len(fields) > 1 else fields[0]

    # ----- the VoxelOperator surface -------------------------------------
    def youngs_modulus(self, rho):
        return self.base.youngs_modulus(rho)

    def apply_K(self, u, scale):
        """K(rho) u: one `voxel_matvec` launch per shard."""
        return self.nodes_from_nodes(
            lambda ub, sb, dev: voxel_matvec(ub, sb, self._ke[dev]), u, scale)

    @spanned("op.apply")
    def apply(self, u, scale, free_mask):
        return free_mask * self.apply_K(free_mask * u, scale)

    def apply_K_lame(self, u, lam_field, mu_field):
        """Two `voxel_matvec` launches per shard (ke_lam, ke_mu)."""
        def fn(ub, lb, mb, dev):
            kl, km = self._ke_lame[dev]
            return voxel_matvec(ub, lb, kl) + voxel_matvec(ub, mb, km)
        return self.nodes_from_nodes(fn, u, lam_field, mu_field)

    @spanned("op.apply")
    def apply_lame(self, u, lam_field, mu_field, free_mask):
        return free_mask * self.apply_K_lame(free_mask * u, lam_field,
                                             mu_field)

    def diagonal(self, scale, free_mask):
        return self.nodes_from_cells(
            lambda sb, mb, dev: self.local_op(sb.shape, dev).diagonal(sb, mb),
            scale, nodes=(free_mask,))

    def row_abs_sums(self, scale, free_mask):
        return self.nodes_from_cells(
            lambda sb, mb, dev: self.local_op(sb.shape, dev).row_abs_sums(
                sb, mb), scale, nodes=(free_mask,))

    def diagonal_lame(self, lam_field, mu_field, free_mask):
        def fn(lb, mb, fb, dev):
            return self.local_op(lb.shape, dev).diagonal_lame(lb, mb, fb)
        return self.nodes_from_cells(fn, lam_field, mu_field,
                                     nodes=(free_mask,))

    def body_force(self, phys, accel, base_density, element_volume):
        """`voxel_body_force` on owned nodes."""
        return self.nodes_from_cells(
            lambda pb, dev: voxel_body_force(pb, accel, base_density,
                                             element_volume), phys)

    def element_energies_unit(self, u):
        """u_e^T ke u_e per owned cell: one `voxel_energies` launch per
        shard."""
        return self.cells_from_nodes(
            lambda ub, dev: voxel_energies(ub, self._ke[dev]), u)

    def element_energies_lame(self, u):
        """Two `voxel_energies` launches per shard."""
        def fn(ub, dev):
            kl, km = self._ke_lame[dev]
            return voxel_energies(ub, kl), voxel_energies(ub, km)
        return self.cells_from_nodes(fn, u)

    def compliance_sensitivities(self, u, rho_phys):
        dE = self.p * rho_phys ** (self.p - 1.0) * (self.E0 - self.Emin)
        return -dE * self.element_energies_unit(u)

    # ----- reductions and layouts ----------------------------------------
    @staticmethod
    def pvdot(a, b):
        """Global <a, b>: each node owned by one shard, counted once."""
        return torch.dot(a, b)

    def to_local_layout(self, u_global):
        """Global (nnx, nny, nnz, 3) node field -> owned-node blocks."""
        return self.layout.split(u_global, "node")

    def from_local_layout(self, u):
        """Inverse of `to_local_layout`, on the mesh's first device."""
        return self.layout.gather(u)

