"""Geometric multigrid preconditioner on the voxel hierarchy.

Port of easysimp_tpu/ops/multigrid.py.  Factor-2 coarsening of the element
grid, trilinear prolongation with its exact adjoint as restriction,
Chebyshev (or damped Jacobi) smoothing, and an exact dense Cholesky at the
coarsest level, so that the V-cycle is a fixed symmetric positive linear
operator: a CG preconditioner.

Coarse operators (galerkin=True, the default) are the variational Galerkin
P^T A P 27-point block stencils of ops/stencil.py; galerkin=False
rediscretizes every level with coarsened moduli and the element operator.

The level-0 operator of the cycle is a `VoxelOperator`, so on a CUDA device
every level-0 smoother apply and residual launches the `voxel_matvec`
kernel, in the cycle dtype's storage (bfloat16 for the bench composition).
Every stencil apply of the coarser levels, and its residual r - A x, is
one `stencil_apply` launch (ops/cuda_kernels.py).  The transfers, im2col
builds and the dense Cholesky are PyTorch ops.  M(r) makes no host
synchronisation: the Chebyshev coefficients are device scalars computed
once per setup.

On one CUDA device the cycle is one CUDA graph per hierarchy.  The
hierarchy then holds one state, pinned to the free mask of its first
setup there, which `setup` and `setup_light` on that mask refresh in place
(the values bitwise those of a fresh state); M(r) on that state copies r
into a buffer of the hierarchy's and replays the graph.  The graph is
captured once, at the first such call, after an eager cycle that answers
it; each replay adds to the counters what the captured cycle counted, so
the `launch.*` counters count the launches the device makes.  Every other
call (a CPU tensor, a sharded field, another state, such as a setup's on
another free mask, a call inside another capture) runs the same `_vcycle`
eagerly.

Not ported, because they only work around the TPU: `power_init_split` and
the per-level programs behind it, and the fused-kernel installs (a CUDA
tensor takes the kernel by itself).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..grids import VoxelGrid
from ..tracing import count, counters, span, sync
from .cg import _vdot
from .cuda_kernels import stencil_apply
from .operator import VoxelOperator
from .stencil import (
    coarsen_stencil,
    compose_level_weights,
    dense_index,
    fold_bc_into_stencil,
    level1_weights,
    level_stencil_diag_from_scale,
    level_stencil_from_scale,
    level_weight_matrix,
    stencil_diagonal,
    stencil_row_abs_sums,
    stencil_to_dense,
)

__all__ = ["MultigridPreconditioner", "prolong", "restrict", "coarsen_cells",
           "coarsen_mask"]


def _max_coarse_dofs() -> int:
    """Stop coarsening once a dense solve is this cheap.  Read from
    EASYSIMP_MAX_COARSE_DOFS, with the reference's default: at 128^3 it
    stops at a 2187-dof coarsest level."""
    return int(os.environ.get("EASYSIMP_MAX_COARSE_DOFS", "4100"))


def _copy_into(dst, src):
    """Write the tensors of `src` into those of `dst`, a structure of the
    same nesting (dicts, lists, tuples, tensors, None); a tensor that is
    already its target is left alone."""
    if isinstance(src, torch.Tensor):
        if dst is not src:
            assert dst.shape == src.shape and dst.dtype == src.dtype
            dst.copy_(src)
    elif isinstance(src, dict):
        for key, value in src.items():
            _copy_into(dst[key], value)
    elif src is not None:
        assert len(dst) == len(src)
        for d, v in zip(dst, src):
            _copy_into(d, v)


def _capture(fn):
    """A CUDA graph of what `fn` launches on the current stream; the
    capture itself runs nothing on the device."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def _coarsen_counts(nels):
    return tuple(n // 2 for n in nels)


def _can_coarsen(nels):
    return (all(n % 2 == 0 and n >= 2 for n in nels)
            and any(n > 2 for n in nels))


def _refine_axis(c, axis):
    """Trilinear refinement along one axis: (n+1) nodes -> (2n+1) nodes."""
    c = torch.movedim(c, axis, 0)
    odd = 0.5 * (c[:-1] + c[1:])
    inter = torch.stack([c[:-1], odd], dim=1).reshape((-1, *c.shape[1:]))
    out = torch.cat([inter, c[-1:]], dim=0)
    return torch.movedim(out, 0, axis)


def _restrict_axis(f, axis):
    """Exact adjoint of `_refine_axis`: (2n+1) -> (n+1)."""
    f = torch.movedim(f, axis, 0)
    even = f[0::2]
    odd = f[1::2]                      # shape (n,)
    zeros = torch.zeros_like(even[:1])
    up = torch.cat([odd, zeros], dim=0)     # odd neighbour above even i
    down = torch.cat([zeros, odd], dim=0)   # odd neighbour below even i
    out = even + 0.5 * (up + down)
    return torch.movedim(out, 0, axis)


def prolong(xc):
    """Coarse node field (ncx+1, ncy+1, ncz+1, 3) -> fine (2ncx+1, ...)."""
    for axis in range(3):
        xc = _refine_axis(xc, axis)
    return xc.contiguous()


def restrict(xf):
    """Adjoint of `prolong`."""
    for axis in range(3):
        xf = _restrict_axis(xf, axis)
    return xf.contiguous()


def coarsen_cells(scale, rule: str = "arithmetic"):
    """Coarsen an element field over 2x2x2 children: "arithmetic" mean,
    "harmonic" mean, or "mixed" (the mean of both)."""
    nx, ny, nz = scale.shape
    blocks = scale.reshape(nx // 2, 2, ny // 2, 2, nz // 2, 2)
    arith = blocks.mean(dim=(1, 3, 5))
    if rule == "arithmetic":
        return arith
    harm = 1.0 / (1.0 / blocks).mean(dim=(1, 3, 5))
    if rule == "harmonic":
        return harm
    if rule == "mixed":
        return 0.5 * (arith + harm)
    raise ValueError(f"unknown coarsening rule {rule!r}")


def coarsen_mask(mask):
    """Node-mask injection: coarse node constrained iff its fine image is.
    Contiguous, as `stencil_apply` takes it."""
    return mask[::2, ::2, ::2].contiguous()


def _assembly_gather(conn, n_dofs):
    """Deterministic dense assembly of element blocks on the rediscretized
    coarsest level: for each distinct flat index (row * n + col) of the
    (E*576) element entries, the positions of its (at most 8) entries,
    padded with the position one past the end (a zero).  Returns
    (unique flat indices, (U, max_count) positions), numpy int64."""
    dof = (3 * conn[:, :, None] + np.arange(3)).reshape(conn.shape[0], 24)
    rows = np.repeat(dof, 24, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 24)).reshape(-1)
    flat = rows * n_dofs + cols
    order = np.argsort(flat, kind="stable")
    uniq, start, counts = np.unique(flat[order], return_index=True,
                                    return_counts=True)
    pos = np.full((uniq.size, counts.max()), flat.size, dtype=np.int64)
    for k in range(counts.max()):
        has = counts > k
        pos[has, k] = order[start[has] + k]
    return uniq, pos


class MultigridPreconditioner:
    """Symmetric V-cycle preconditioner for the masked voxel operator.

    The arguments are the reference's (easysimp_tpu/ops/multigrid.py:135),
    but for `direct_stencils`: levels 1 to min(n_levels - 1, 3) always
    build directly from the fine moduli, as the reference does by default.
    The hierarchy lives on `fine_op.device`.  The state that `setup`
    returns is a dictionary of tensors: per level the moduli, masks,
    diagonals, Jacobi weights, lambda_max estimates, Chebyshev coefficients
    and Galerkin stencils, and the coarsest level's Cholesky factor.  On
    one CUDA device that dictionary is the hierarchy's own, refreshed in
    place by every setup on the free mask of its first, and M(r) on it
    replays the cycle's CUDA graph (module docstring)."""

    def __init__(self, fine_op: VoxelOperator, levels: int = 0,
                 smooth_iters=1, power_iters: int = 10,
                 refresh_iters: int = 2, cycle_dtype=None,
                 smoother: str = "chebyshev", galerkin: bool = True,
                 cycle: str = "v", coarsen: str = "arithmetic",
                 stencil_dtype=None):
        # smooth_iters: one Chebyshev degree for every level, or per-level
        # degrees (the last entry repeats for deeper levels)
        if isinstance(smooth_iters, (tuple, list)):
            self.smooth_iters = tuple(int(s) for s in smooth_iters)
        else:
            self.smooth_iters = int(smooth_iters)
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        if cycle not in ("v", "w"):
            raise ValueError(f"unknown cycle type {cycle!r}")
        if cycle == "w" and cycle_dtype is not None \
                and cycle_dtype.itemsize < 4:
            # the second coarse visit's recomputed residual cancels in
            # bfloat16: the reference's W-cycle diverges there (CG at its
            # iteration cap every SIMP iteration)
            raise ValueError("the W-cycle needs a cycle dtype of at least "
                             f"32 bits, got {cycle_dtype}")
        self.smoother = smoother
        self.cycle = cycle
        self.galerkin = bool(galerkin)
        self.coarsen = coarsen
        # power_iters > 0: lambda_max by power iteration (cold: power_iters,
        # warm from carried vectors: refresh_iters); 0: the Gershgorin bound
        self.power_iters = int(power_iters)
        self.refresh_iters = int(refresh_iters)
        self.dtype = fine_op.dtype
        self.device = fine_op.device
        # cycle_dtype: the V-cycle interior's dtype (e.g. bfloat16), CG
        # keeps the operator's.  stencil_dtype: storage dtype of the
        # Galerkin coefficients only.  None = the operator's dtype.
        self.cycle_dtype = cycle_dtype
        self.stencil_dtype = stencil_dtype

        self.ops = [fine_op]
        grid = fine_op.grid
        while _can_coarsen(grid.nels):
            nels = _coarsen_counts(grid.nels)
            spacing = tuple(2.0 * s for s in grid.spacing)
            grid = VoxelGrid(nels=nels, origin=grid.origin, spacing=spacing)
            self.ops.append(self._op(grid, self.dtype))
            if 3 * grid.n_nodes <= _max_coarse_dofs():
                break
            if levels and len(self.ops) >= levels:
                break
        self.n_levels = len(self.ops)
        # Galerkin weights: host float64 (from the operator's ke as stored),
        # composed so that levels 1..min(n_levels-1, 3) build directly from
        # the fine moduli; deeper levels use the RAP.  Their im2col matrices
        # go to the device once, in the operator dtype.
        self._Gs = {}
        if self.galerkin and self.n_levels > 1:
            G = level1_weights(fine_op.ke.double().cpu().numpy())
            self._Gs[1] = G
            for k in range(1, min(self.n_levels - 1, 3)):
                G = compose_level_weights(G, k)
                self._Gs[k + 1] = G
        self._Gm = {lvl: torch.as_tensor(level_weight_matrix(G),
                                         dtype=self.dtype, device=self.device)
                    for lvl, G in self._Gs.items()}
        if self.cycle_dtype is not None:
            self.cycle_ops = [self._op(o.grid, self.cycle_dtype)
                              for o in self.ops]
        else:
            self.cycle_ops = self.ops

        self._coarse_ndofs = 3 * self.ops[-1].grid.n_nodes
        self._index = None
        # one CUDA device: the state that setups refresh in place, the free
        # mask it is pinned to, the cycle graph, what the captured cycle
        # counted, and the buffer the graph reads r from and writes M(r) to
        self._state = None
        self._free_mask = None
        self._graph = None
        self._graph_counts = {}
        self._buffer = None

    def _coarse_index(self):
        """The coarsest level's dense assembly indices on the device, made
        once per hierarchy, at the first setup: `dense_index` for a Galerkin
        coarsest stencil, `_assembly_gather` for the rediscretized one."""
        if self._index is None:
            cg = self.ops[-1].grid
            if self.galerkin and self.n_levels > 1:
                index = dense_index(cg.nnodes_per_axis)
            else:
                index = _assembly_gather(cg.hex_connectivity,
                                         self._coarse_ndofs)
            self._index = tuple(torch.as_tensor(a, device=self.device)
                                for a in index)
        return self._index

    def _op(self, grid, dtype):
        f = self.ops[0]
        return VoxelOperator(grid, E0=f.E0, Emin=f.Emin, nu=f.nu, p=f.p,
                             dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _scaled_cholesky(self, K, mask_flat=None):
        """Cholesky factor of the diagonally scaled, shifted dense SPD
        matrix D^-1/2 K D^-1/2 + 100 eps I, and D^-1/2.  The scaling keeps
        the factorization finite at SIMP contrast; the relative shift keeps
        it finite for a semi-definite K.  No host synchronisation
        (`cholesky_ex` does not check the factorization)."""
        n = K.shape[0]
        if mask_flat is not None:
            K = mask_flat[:, None] * K * mask_flat[None, :]
            K = K + torch.diag(1.0 - mask_flat)
        dinv_sqrt = 1.0 / torch.sqrt(torch.diagonal(K))
        Ks = K * dinv_sqrt[:, None] * dinv_sqrt[None, :]
        shift = 100.0 * torch.finfo(self.dtype).eps
        Ks = Ks + shift * torch.eye(n, dtype=self.dtype, device=self.device)
        L, _ = torch.linalg.cholesky_ex(Ks)
        return L, dinv_sqrt

    def _coarsest_factor(self, scale_flat, mask_flat):
        """Dense BC-masked stiffness at the coarsest level and its factor
        (rediscretized path).  Duplicate entries are summed in a fixed
        order (deterministic on CUDA)."""
        ke = self.ops[-1].ke
        vals = (scale_flat[:, None, None] * ke[None]).reshape(-1)
        vals = torch.cat([vals, vals.new_zeros(1)])
        uniq, pos = self._coarse_index()
        n = self._coarse_ndofs
        K = vals.new_zeros(n * n)
        K[uniq] = vals[pos].sum(dim=1)
        return self._scaled_cholesky(K.reshape(n, n), mask_flat)

    @staticmethod
    def _cholesky_solve(cho, r_flat):
        L, dinv_sqrt = cho
        return dinv_sqrt * torch.cholesky_solve(
            (dinv_sqrt * r_flat)[:, None], L)[:, 0]

    def _hash_vector(self, lvl):
        """Deterministic pseudo-random start with broad spectral content:
        the reference's uint32 Knuth hash, computed in int64 and masked to
        32 bits, so the vectors are bitwise the reference's."""
        shape = (*self.ops[lvl].grid.nnodes_per_axis, 3)
        n = int(np.prod(shape))
        h = (torch.arange(n, dtype=torch.int64, device=self.device)
             * 2654435761) & 0xFFFFFFFF
        v = (h >> 8).to(self.dtype) / 2.0 ** 24 - 0.5
        return v.reshape(shape)

    def init_power_vectors(self):
        """Per-level start vectors for the carried power-iteration state."""
        return tuple(self._hash_vector(lvl) for lvl in range(self.n_levels))

    def _estimate_lambda_max(self, apply_fn, mask, diag, v, iters):
        """Power iteration on D^-1 A, warm-started from v; returns
        (lam, final normalized vector).  A plain loop of device ops with no
        host synchronisation."""
        tiny = torch.finfo(self.dtype).tiny
        v = v * mask
        lam = torch.ones((), dtype=self.dtype, device=self.device)
        for _ in range(max(iters, 0)):
            w = apply_fn(v) / diag
            ww = _vdot(w, w)
            lam = torch.sqrt(ww / torch.clamp(_vdot(v, v), min=tiny))
            v = w / torch.clamp(torch.sqrt(ww), min=tiny)
        return lam, v

    def _coarsen_fields(self, scale, free_mask):
        scales, masks = [scale], [free_mask]
        for lvl in range(1, self.n_levels):
            scales.append(coarsen_cells(scales[-1], self.coarsen))
            masks.append(self._coarsen_mask(lvl, masks[-1]))
        return scales, masks

    # The level builds below are methods so that the sharded hierarchy
    # (parallel/sharded_multigrid.py) can run them on each shard's block.
    def _coarsen_mask(self, lvl, mask):
        """The level-`lvl` mask from the level-(lvl-1) one."""
        return coarsen_mask(mask)

    def _stencil_from_scale(self, scale, lvl, out_dtype=None, x_chunks=1):
        """The level-`lvl` Galerkin stencil from the fine moduli."""
        return level_stencil_from_scale(scale, self._Gm[lvl], lvl,
                                        out_dtype=out_dtype,
                                        x_chunks=x_chunks)

    def _stencil_diag_from_scale(self, scale, lvl):
        return level_stencil_diag_from_scale(scale, self._Gm[lvl], lvl)

    def _coarsen_stencil(self, lvl, prev):
        """The level-`lvl` stencil as the RAP of the level-(lvl-1) one."""
        return coarsen_stencil(prev)

    def _build_stencils(self, scale, masks):
        """Galerkin stencil per level >= 1 (None at level 0, which applies
        the element operator), unfolded: the masks are applied at apply
        time.  Narrow-storage hierarchies (stencil_dtype) emit the storage
        dtype from the builds and keep a full-precision diagonal
        (fp_diags); the coarsest level stays full precision (it feeds the
        dense Cholesky)."""
        stencils = [None] * self.n_levels
        fp_diags = [None] * self.n_levels
        if not self.galerkin or self.n_levels < 2:
            return stencils, fp_diags
        sd = self.stencil_dtype
        for lvl in range(1, self.n_levels):
            sd_l = sd if lvl < self.n_levels - 1 else None
            if lvl in self._Gm:
                n_coarse = (scale.shape[0] >> lvl) + 1
                big = np.prod(scale.shape) >= 8 * 1024 ** 2
                chunks = 8 if (sd_l is not None and lvl == 1 and big) else 1
                stencils[lvl] = self._stencil_from_scale(
                    scale, lvl, out_dtype=sd_l,
                    x_chunks=min(chunks, n_coarse))
                if sd_l is not None:
                    fp_diags[lvl] = self._stencil_diag_from_scale(scale, lvl)
            else:
                prev = stencils[lvl - 1]
                if prev.dtype != scale.dtype:
                    prev = prev.to(scale.dtype)
                st = self._coarsen_stencil(lvl, prev)
                if sd_l is not None:
                    fp_diags[lvl] = stencil_diagonal(st)
                stencils[lvl] = st if sd_l is None else st.to(sd_l)
        return stencils, fp_diags

    def _masked_stencil_apply(self, lvl, stencil, mask, v, r=None):
        """Masked action of the level-`lvl` unfolded stencil, M C (M v), or
        the residual r - M C (M v) where r is given.  A field in another
        dtype than the stencil's is applied in the stencil's dtype and the
        result cast back."""
        with span(f"mg.stencil.{lvl}"):
            return self._stencil_apply(stencil, mask, v, r)

    # The cycle's grid operations are methods so that the sharded hierarchy
    # can run them with a halo on each shard's block.
    def _stencil_apply(self, stencil, mask, v, r=None):
        return stencil_apply(stencil, mask, v, r)

    def _restrict(self, lvl, f):
        """Level-`lvl` node field -> level lvl + 1."""
        return restrict(f)

    def _prolong(self, lvl, xc):
        """Level lvl + 1 node field -> level `lvl`."""
        return prolong(xc)

    def _level_apply(self, lvl, scales, masks, stencils):
        """The level-`lvl` operator used during setup (power iteration)."""
        if stencils[lvl] is not None:
            return lambda v: self._masked_stencil_apply(
                lvl, stencils[lvl], masks[lvl], v)
        op = self.ops[lvl]
        return lambda v: op.apply(v, scales[lvl], masks[lvl])

    def _level_diag(self, lvl, scales, masks, stencils):
        if stencils[lvl] is not None:
            return stencil_diagonal(stencils[lvl])
        return self.ops[lvl].diagonal(scales[lvl], masks[lvl])

    def power_init(self, scale, free_mask):
        """Full (cold) power estimation on all levels; returns the vectors
        for the driver to carry through the SIMP iterations."""
        scales, masks = self._coarsen_fields(scale, free_mask)
        stencils, fp_diags = self._build_stencils(scale, masks)
        vecs = []
        for lvl in range(self.n_levels):
            diag = (fp_diags[lvl] if fp_diags[lvl] is not None
                    else self._level_diag(lvl, scales, masks, stencils))
            _, v = self._estimate_lambda_max(
                self._level_apply(lvl, scales, masks, stencils), masks[lvl],
                diag, self._hash_vector(lvl), self.power_iters)
            vecs.append(v)
        return tuple(vecs)

    def _chebyshev(self, lam_max, lvl):
        """Chebyshev coefficients of level `lvl` over [lam_max/6, lam_max],
        as device scalars in lam_max's dtype: (theta, [(rho*rho_old,
        2 rho/delta) per further sweep]), the reference's scalar recurrence
        in its order of operations."""
        lam_min = lam_max * torch.full((), 1.0 / 6.0, dtype=lam_max.dtype,
                                       device=lam_max.device)
        theta = 0.5 * (lam_max + lam_min)
        delta = 0.5 * (lam_max - lam_min)
        sigma = theta / delta
        rho_old = 1.0 / sigma
        steps = []
        for _ in range(1, self._level_smooth_iters(lvl)):
            rho = 1.0 / (2.0 * sigma - rho_old)
            steps.append((rho * rho_old, 2.0 * rho / delta))
            rho_old = rho
        return theta, steps

    def _with_chebyshev(self, state, levels):
        cheb = list(state.get("cheb", [None] * self.n_levels))
        if self.smoother == "chebyshev":
            for lvl in levels:
                if lvl < self.n_levels - 1:
                    cheb[lvl] = self._chebyshev(state["lams"][lvl], lvl)
        return dict(state, cheb=cheb)

    def setup(self, scale, free_mask, power_vectors=None):
        """Per-SIMP-iteration setup: level moduli and stencils, masks,
        diagonals, smoother data, coarsest factorization.

        power_vectors: carried per-level power-iteration state, refreshed
        with `refresh_iters` iterations and a 1.1 headroom; None = cold
        start from the hash vectors with `power_iters` and 1.05.
        Returns (state, new_power_vectors)."""
        cold = power_vectors is None
        if cold:
            power_vectors = self.init_power_vectors()
        iters = self.power_iters if cold else self.refresh_iters
        headroom = 1.05 if cold else 1.1
        scales, masks = self._coarsen_fields(scale, free_mask)
        stencils, fp_diags = self._build_stencils(scale, masks)
        diags, omegas, lams, new_vecs = [], [], [], []
        for lvl in range(self.n_levels):
            diag = (fp_diags[lvl] if fp_diags[lvl] is not None
                    else self._level_diag(lvl, scales, masks, stencils))
            diags.append(diag)
            apply_fn = self._level_apply(lvl, scales, masks, stencils)
            if self.power_iters > 0:
                lam, v = self._estimate_lambda_max(
                    apply_fn, masks[lvl], diag, power_vectors[lvl], iters)
                lam = headroom * lam
                new_vecs.append(v)
            else:
                # Gershgorin: lam_max(D^-1 A) <= max_i rowabs_i / diag_i
                # (the unfolded stencil's row sums bound the masked one's)
                if stencils[lvl] is not None:
                    rowabs = stencil_row_abs_sums(stencils[lvl])
                else:
                    rowabs = self.ops[lvl].row_abs_sums(scales[lvl],
                                                        masks[lvl])
                lam = torch.max(rowabs / diag)
                new_vecs.append(power_vectors[lvl])
            lams.append(lam)
            omegas.append(4.0 / (3.0 * lam))

        if stencils[-1] is not None:
            # Galerkin coarsest: fold the BCs here and densify (natural C
            # order); narrow storage is upcast first
            coarsest = stencils[-1]
            if coarsest.dtype != scale.dtype:
                coarsest = coarsest.to(scale.dtype)
            folded = fold_bc_into_stencil(coarsest, masks[-1])
            cho = self._scaled_cholesky(
                stencil_to_dense(folded, self._coarse_index()))
            mask_flat = None
        else:
            # x-fastest flattening to match hex_connectivity numbering
            scale_flat = scales[-1].permute(2, 1, 0).reshape(-1)
            mask_flat = masks[-1].permute(2, 1, 0, 3).reshape(-1)
            cho = self._coarsest_factor(scale_flat, mask_flat)
        state = {"scales": scales, "masks": masks, "diags": diags,
                 "omegas": omegas, "lams": lams, "cho": cho,
                 "mask_flat": mask_flat, "stencils": stencils}
        if self.cycle_dtype is not None:
            lp = self.cycle_dtype
            for key in ("scales", "masks", "diags", "omegas", "lams"):
                state[key] = [t.to(lp) for t in state[key]]
            state["stencils"] = [None if s is None else s.to(lp)
                                 for s in stencils]
        if self.stencil_dtype is not None:
            sd = self.stencil_dtype
            state["stencils"] = [None if s is None else s.to(sd)
                                 for s in state["stencils"]]
        return (self._keep(self._with_chebyshev(state, range(self.n_levels)),
                           scale, free_mask),
                tuple(new_vecs))

    def _on_card(self, t):
        """Whether `t` is a plain tensor on the current CUDA device and the
        hierarchy lives there: the path of the own state and the cycle
        graph."""
        if not (isinstance(t, torch.Tensor) and t.is_cuda
                and self.device.type == "cuda"):
            return False
        index = torch.cuda.current_device()
        return t.device.index == index and self.device.index in (None, index)

    def _keep(self, state, scale, free_mask):
        """The state a setup returns: on one CUDA device the hierarchy's
        own, with `state`'s values written into it, where the setup ran on
        the free mask of the hierarchy's first setup there; elsewhere, and
        on another free mask, `state` itself (and M on it runs the eager
        cycle).  The masks come from the free mask alone and are not
        copied."""
        if not self._on_card(scale) or (self._state is not None
                                        and free_mask is not self._free_mask):
            return state
        if self._state is None:
            # the caller keeps its moduli tensor: the state takes a copy
            self._state = dict(state, scales=[
                t.clone() if t is scale else t for t in state["scales"]])
            self._free_mask = free_mask
            self._buffer = torch.empty_like(free_mask, dtype=self.dtype)
        else:
            for key, value in state.items():
                if key not in ("masks", "mask_flat"):
                    _copy_into(self._state[key], value)
        return self._state

    @property
    def supports_light_setup(self) -> bool:
        """setup_light needs a Galerkin hierarchy with deeper levels to
        reuse, and the power-iteration bound."""
        return (self.galerkin and self.n_levels >= 3
                and self.power_iters > 0)

    def setup_light(self, scale, free_mask, power_vectors, prev_state):
        """Partial setup (params.mg_full_setup_every): rebuild the fine
        level's diagonal and lambda and the level-1 Galerkin stencil, and
        reuse the deeper stencils, their smoother data and the coarsest
        Cholesky from `prev_state`.  Returns (state, new_power_vectors) with
        the same keys as `setup`."""
        if not self.supports_light_setup:
            raise ValueError("setup_light needs a Galerkin hierarchy of >= 3 "
                             "levels with power iteration")
        lp = self.cycle_dtype

        def cast(x):
            return x if lp is None else x.to(lp)

        sd_build = self.stencil_dtype
        st1 = self._stencil_from_scale(
            scale, 1, out_dtype=sd_build,
            x_chunks=8 if (sd_build is not None
                           and np.prod(scale.shape) >= 8 * 1024 ** 2) else 1)
        fp_diag1 = (self._stencil_diag_from_scale(scale, 1)
                    if sd_build is not None else None)
        mask1 = self._coarsen_mask(1, free_mask)
        headroom = 1.1
        # level 0: the element operator
        diag0 = self.ops[0].diagonal(scale, free_mask)
        lam0, v0 = self._estimate_lambda_max(
            lambda v: self.ops[0].apply(v, scale, free_mask), free_mask,
            diag0, power_vectors[0], self.refresh_iters)
        lam0 = headroom * lam0
        # level 1: the fresh Galerkin stencil
        diag1 = fp_diag1 if fp_diag1 is not None else stencil_diagonal(st1)
        lam1, v1 = self._estimate_lambda_max(
            lambda v: self._masked_stencil_apply(1, st1, mask1, v), mask1,
            diag1, power_vectors[1], self.refresh_iters)
        lam1 = headroom * lam1

        scales = list(prev_state["scales"])
        scales[0] = cast(scale)
        diags = list(prev_state["diags"])
        diags[0], diags[1] = cast(diag0), cast(diag1)
        lams = list(prev_state["lams"])
        lams[0], lams[1] = cast(lam0), cast(lam1)
        omegas = list(prev_state["omegas"])
        omegas[0] = cast(4.0 / (3.0 * lam0))
        omegas[1] = cast(4.0 / (3.0 * lam1))
        stencils = list(prev_state["stencils"])
        sd = self.stencil_dtype if self.stencil_dtype is not None else lp
        stencils[1] = st1 if sd is None else st1.to(sd)
        state = dict(prev_state, scales=scales, diags=diags, lams=lams,
                     omegas=omegas, stencils=stencils)
        new_vecs = (v0, v1) + tuple(power_vectors[2:])
        return (self._keep(self._with_chebyshev(state, (0, 1)), scale,
                           free_mask),
                new_vecs)

    # ------------------------------------------------------------------
    def _apply_level(self, lvl, state, v, r=None):
        """Cycle-time operator action at `lvl` (stencil or element-based),
        or the residual r - A v where r is given (one stencil launch)."""
        st = state["stencils"][lvl]
        if st is not None:
            return self._masked_stencil_apply(lvl, st, state["masks"][lvl],
                                              v, r)
        op = self.cycle_ops[lvl]
        out = op.apply(v, state["scales"][lvl], state["masks"][lvl])
        return out if r is None else r - out

    def _smooth(self, lvl, state, r, x, iters):
        """Damped Jacobi, or a degree-`iters` Chebyshev polynomial in D^-1 A
        over [lam_max/6, lam_max].  x=None means a zero initial iterate: the
        first residual is r itself, which saves one operator apply."""
        diag = state["diags"][lvl]
        if self.smoother == "jacobi":
            omega = state["omegas"][lvl]
            if x is None:
                x = omega * r / diag
                iters = iters - 1
            for _ in range(iters):
                x = x + omega * self._apply_level(lvl, state, x, r) / diag
            return x

        theta, steps = state["cheb"][lvl]
        res = r if x is None else self._apply_level(lvl, state, x, r)
        d = (res / diag) / theta
        x = d if x is None else x + d
        for a, b in steps:
            res = self._apply_level(lvl, state, x, r)
            d = a * d + b * (res / diag)
            x = x + d
        return x

    def _vcycle(self, lvl, state, r):
        if lvl == self.n_levels - 1:
            with span("mg.coarsest"):
                return self._coarsest_solve(state, r)
        mask = state["masks"][lvl]
        iters = self._level_smooth_iters(lvl)
        with span(f"mg.smooth.{lvl}"):
            x = self._smooth(lvl, state, r, None, iters)  # x0 = 0
        res = self._apply_level(lvl, state, x, r)
        with span(f"mg.transfer.{lvl}"):
            rc = state["masks"][lvl + 1] * self._restrict(lvl, res)
        xc = self._vcycle(lvl + 1, state, rc)
        if self.cycle == "w" and lvl + 1 < self.n_levels - 1:
            # W-cycle: a second coarse-grid visit on the updated residual
            rc2 = self._apply_level(lvl + 1, state, xc, rc)
            xc = xc + self._vcycle(lvl + 1, state, rc2)
        with span(f"mg.transfer.{lvl}"):
            x = x + mask * self._prolong(lvl, xc)
        with span(f"mg.smooth.{lvl}"):
            return self._smooth(lvl, state, r, x, iters)

    def _coarsest_solve(self, state, r):
        """The dense Cholesky solve of the coarsest level."""
        if state["stencils"][-1] is not None:
            # Galerkin coarsest: natural C-order flattening, BC folding
            # already inside the dense matrix
            r_flat = r.to(self.dtype).reshape(-1)
            x_flat = self._cholesky_solve(state["cho"], r_flat)
            out = x_flat.reshape(r.shape) * state["masks"][-1]
            return out.to(r.dtype)
        mask_flat = state["mask_flat"]
        r_flat = r.to(self.dtype).permute(2, 1, 0, 3).reshape(-1) \
            * mask_flat
        x_flat = self._cholesky_solve(state["cho"], r_flat) * mask_flat
        nnx, nny, nnz = self.ops[-1].grid.nnodes_per_axis
        out = x_flat.reshape(nnz, nny, nnx, 3).permute(2, 1, 0, 3)
        return out.to(r.dtype).contiguous()

    def _level_smooth_iters(self, lvl: int) -> int:
        if isinstance(self.smooth_iters, tuple):
            return self.smooth_iters[min(lvl, len(self.smooth_iters) - 1)]
        return self.smooth_iters

    def _cycle(self, state, r, out=None):
        """One cycle on r, run in the cycle dtype: M(r) in r's dtype, or
        written into `out`."""
        lp = self.cycle_dtype
        x = self._vcycle(0, state, r if lp is None else r.to(lp))
        if out is not None:
            return out.copy_(x)
        return x if lp is None else x.to(r.dtype)

    def make_M(self, state):
        """M(r): one cycle on a prebuilt state, in the cycle dtype, as a
        tensor of its own.

        On the hierarchy's own state (one CUDA device), r a tensor of the
        operator's dtype on that device replays the cycle's CUDA graph (the
        first such call captures it); every other call runs the cycle
        eagerly.  M on the own state also offers `M.into_buffer(r)`, M(r)
        without the copy out of the graph's buffer `M.buffer`: it returns
        that buffer where it replays, which then holds M(r) until the next
        call on the hierarchy (r may be the buffer; `cg_solve` uses it).
        Counters: `mg.graph.capture`, `mg.graph.replay`, `mg.graph.eager`,
        one per call."""
        own = state is not None and state is self._state

        def into_buffer(r):
            with span("mg.vcycle"):
                if (own and self._on_card(r)
                        and r.dtype == self.dtype
                        and r.shape == self._buffer.shape
                        and not torch.cuda.is_current_stream_capturing()):
                    return self._replay(r)
                count("mg.graph.eager")
                return self._cycle(state, r)

        def M(r):
            z = into_buffer(r)
            return z.clone() if own and z is self._buffer else z

        if own:
            M.buffer, M.into_buffer = self._buffer, into_buffer
        return M

    def _replay(self, r):
        """M(r) through the cycle's graph, captured at the first call: the
        buffer, or the first call's eager answer.  The capture launches
        nothing, so what it counted comes off the counters and goes back on
        at every replay."""
        buf = self._buffer
        if self._graph is None:
            out = self._cycle(self._state, r)   # warm-up, and the answer
            with sync("mg_capture"):
                before = counters()
                self._graph = _capture(
                    lambda: self._cycle(self._state, buf, out=buf))
                self._graph_counts = {
                    k: n - before.get(k, 0) for k, n in counters().items()
                    if n != before.get(k, 0)}
            for k, n in self._graph_counts.items():
                count(k, -n)
            count("mg.graph.capture")
            return out
        if r is not buf:
            buf.copy_(r)
        self._graph.replay()
        for k, n in self._graph_counts.items():
            count(k, n)
        count("mg.graph.replay")
        return buf

    def preconditioner_factory(self):
        """Cold factory (scale, mask) -> M(r), with a full power estimation
        per call: for one-off solves and tests."""

        def factory(scale, free_mask):
            state, _ = self.setup(scale, free_mask)
            return self.make_M(state)

        return factory

    def stateful_factory(self):
        """(scale, mask, power_vectors) -> (M(r), new_power_vectors); the
        caller threads the power vectors through the SIMP iterations."""

        def factory(scale, free_mask, power_vectors):
            state, new_vecs = self.setup(scale, free_mask, power_vectors)
            return self.make_M(state), new_vecs

        return factory
