"""The element-sharded unstructured path (imported tet4/hex8 meshes).

Counterpart of the `device_mesh` branch of easysimp_tpu/opt/
optimize_unstructured.py:147-165, 192-207, where GSPMD partitions the
element batch over a 1-axis ("e",) mesh and keeps dof vectors replicated.
Here, over the element split of parallel/sharding.py `ElementLayout`:

* per shard: the element batch (ke), connectivity and dof map, densities,
  element volumes, the filter rows, and the AMG's element-indexed assembly
  inputs;
* dof and aggregate vectors are held once, on the mesh's first device, and
  copied to a shard's device where its elements read them;
* the operator apply is one partial per shard, through that shard's own
  padded incidence table (ops/operator.py `padded_groups`/`group_sum`),
  and the partials are added in shard order: a fixed order, no
  `index_add_` on the per-CG-iteration path;
* the filter gathers the design onto every shard's device before its
  row-split apply (`UnstructuredFilter.row_block`).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..ops.amg import MultilevelAMG
from ..ops.filters import UnstructuredFilter
from ..ops.operator import UnstructuredOperator
from .sharding import ElementLayout, ShardedField, _add_in_order

__all__ = ["ElementShardedOperator", "ElementShardedFilter",
           "ElementShardedAMG"]


class _Replicas:
    """A tensor held on the first device, copied to each other device of a
    layout once, at first use."""

    def __init__(self, t):
        self.t = t
        self._on = {t.device: t}

    def on(self, device):
        if device not in self._on:
            self._on[device] = self.t.to(device)
        return self._on[device]


class ElementShardedOperator(UnstructuredOperator):
    """`UnstructuredOperator` whose elements are split over an ("e",) mesh:
    element fields are element-sharded fields, dof vectors plain tensors on
    the mesh's first device."""

    def __init__(self, ke_unit, connectivity, n_nodes, E0, Emin, nu, p,
                 layout: ElementLayout, dtype=torch.float32):
        ke_unit = np.asarray(ke_unit)
        conn = np.asarray(connectivity, dtype=np.int64)
        self.layout = layout
        self.parts = [UnstructuredOperator(
            ke_unit[lo:hi], conn[lo:hi], n_nodes, E0, Emin, nu, p,
            dtype=dtype, device=dev)
            for (lo, hi), dev in zip(layout.elem_ranges, layout.devices)]
        self.E0, self.Emin, self.nu, self.p = (float(E0), float(Emin),
                                               float(nu), float(p))
        self.dtype = dtype
        self.device = layout.device
        self.n_nodes = int(n_nodes)
        self.n_dofs = 3 * self.n_nodes
        self.nn = conn.shape[1]
        self.ke = self._field([q.ke for q in self.parts])

    def _field(self, blocks):
        return ShardedField(blocks, self.layout, "elem")

    def set_lame_basis(self, ke_lam, ke_mu):
        ke_lam, ke_mu = np.asarray(ke_lam), np.asarray(ke_mu)
        for (lo, hi), q in zip(self.layout.elem_ranges, self.parts):
            q.set_lame_basis(ke_lam[lo:hi], ke_mu[lo:hi])
        self.ke_lam = self._field([q.ke_lam for q in self.parts])
        self.ke_mu = self._field([q.ke_mu for q in self.parts])

    def apply_elements(self, u, ke=None):
        """(u_e, ke_e @ u_e) as element fields; u a dof vector on the first
        device, copied to each shard's device."""
        ke = self.ke if ke is None else ke
        outs = [q.apply_elements(u.to(q.device), k)
                for q, k in zip(self.parts, ke.blocks)]
        return (self._field([o[0] for o in outs]),
                self._field([o[1] for o in outs]))

    def scatter_nodes(self, per_corner):
        """Per-shard sums through each shard's incidence table, added in
        shard order on the first device."""
        return _add_in_order([q.scatter_nodes(b) for q, b in
                              zip(self.parts, per_corner.blocks)],
                             self.device)

    def scatter_dofs(self, fe):
        return _add_in_order([q.scatter_dofs(b) for q, b in
                              zip(self.parts, fe.blocks)], self.device)


class ElementShardedFilter:
    """`UnstructuredFilter` with its rows split over an ("e",) mesh: each
    shard's `row_block` filters its own cells from the gathered design."""

    def __init__(self, filt: UnstructuredFilter, layout: ElementLayout):
        self.layout = layout
        self.filter_radius = filt.filter_radius
        self.neighbor_route = filt.neighbor_route
        self.dtype = filt.dtype
        self.device = layout.device
        self.parts = [filt.row_block(lo, hi, dev) for (lo, hi), dev
                      in zip(layout.elem_ranges, layout.devices)]

    def _rows(self, method, *fields):
        """`method` of every shard's row block, on the fields gathered in
        full onto each shard's device."""
        full = [_Replicas(self.layout.gather(f)) for f in fields]
        return ShardedField(
            [getattr(q, method)(*(g.on(q.device) for g in full))
             for q in self.parts], self.layout, "elem")

    def sensitivity_filter(self, design_rho, sens):
        return self._rows("sensitivity_filter", design_rho, sens)

    def density_filter(self, design_rho):
        return self._rows("density_filter", design_rho)

    def chain_rule(self, sens_physical):
        return self._rows("chain_rule", sens_physical)


class ElementShardedAMG(MultilevelAMG):
    """`MultilevelAMG` of an `ElementShardedOperator`: the host structures
    are the single-device ones; the element-indexed assembly inputs are
    split like the operator's elements, and the level-1 (or node-block)
    assembly is one partial per shard, added in shard order."""

    def __init__(self, op: ElementShardedOperator, ke_unit, mesh, free_mask,
                 **kw):
        # the host build reads the whole element batch once, on the host
        whole = SimpleNamespace(
            ke=torch.as_tensor(np.asarray(ke_unit), dtype=op.dtype),
            dtype=op.dtype, device=op.device)
        super().__init__(whole, mesh, free_mask, **kw)
        self.op = op
        L = op.layout
        split = L.split
        self.node_conn = split(self.node_conn)
        if self.smooth_p:
            self.elem_nodepair_idx = split(self.elem_nodepair_idx)
        else:
            self.elem_pair_idx = split(self.elem_pair_idx)
        self.ke_corner = split(self.ke_corner)
        self.ke_l1off = split(self.ke_l1off)
        chunk = self.chunk_slices[0][1] - self.chunk_slices[0][0]
        self.shard_chunks = [[(s, min(s + chunk, hi - lo))
                              for s in range(0, hi - lo, chunk)]
                             for lo, hi in L.elem_ranges]
        self._Pn = _Replicas(self.Pn)

    def _assemble_level1(self, scale):
        return _add_in_order(
            [self._level1_part(q.ke, s, self._Pn.on(q.device), c, p, ch)
             for q, s, c, p, ch in zip(
                 self.op.parts, scale.blocks, self.node_conn.blocks,
                 self.elem_pair_idx.blocks, self.shard_chunks)],
            self.device)

    def _assemble_node_blocks(self, scale, free_mask):
        acc = _add_in_order(
            [self._node_blocks_part(q.ke, s, p, ch)
             for q, s, p, ch in zip(self.op.parts, scale.blocks,
                                    self.elem_nodepair_idx.blocks,
                                    self.shard_chunks)], self.device)
        m = free_mask.reshape(self.n_nodes, 3).to(acc.dtype)
        return (acc * m[self.nodepair_rows][:, :, None]
                * m[self.nodepair_cols][:, None, :])
