"""Multilevel aggregation AMG for the unstructured (imported-mesh) path.

Port of easysimp_tpu/ops/amg.py.  Replaces plain (block-)Jacobi CG as the
unstructured preconditioner: the place where the reference's CHOLMOD direct
solve (src/Optimization/Optimization.jl:317) beat the matrix-free rebuild on
CG iteration counts at SIMP contrast (E_max/E_min ~ 1e9).

The split mirrors the voxel multigrid (ops/multigrid.py):

  * HOST, once per problem (numpy/scipy, the reference's code unchanged, so
    the structures are equal to its): recursively aggregate the node graph
    (greedy root-node clustering), build the smoothed-aggregation-style
    tentative prolongators from the rigid-body near-nullspace (level 0:
    per-node (3, 6) blocks, BC-masked, SVD-orthonormalized per aggregate;
    deeper levels: per-aggregate SVD of the coarse near-nullspace carried
    down the hierarchy, Vanek/Mandel/Brezina-style), and precompute the
    block-pair index structure of every Galerkin level.
  * DEVICE, once per SIMP iteration (densities change): assemble the
    level-1 block-sparse operator A_1[pair] = sum_e E(rho_e) P_a^T ke_e
    P_b with batched einsums + one index_add_ (chunked over elements so
    the transient stays bounded on multi-million-element meshes), Galerkin
    the deeper levels through the precomputed pair maps, invert the
    l1-regularized 6x6/3x3 smoother blocks per level, and Cholesky-factor
    the (dense, small) coarsest level.
  * DEVICE, per CG iteration: symmetric multilevel V-cycle with
    Chebyshev l1-block-Jacobi smoothing on the FIXED interval [1/6, 1]
    (lam_max(B^-1 A) <= 1 exactly by the l1 construction: no spectral
    estimation; SPD by construction, safe inside CG).

Every sum that runs once or more per CG iteration (the level matvecs, the
restrictions and the prolongation adds) goes through a host-built padded
incidence table and a row reduction (`operator.group_sum`), not through a
scatter-add: CUDA's float atomics would change the sum order from launch to
launch, and two V-cycles on the same input are bitwise equal this way.  The
setup-time assemblies keep `index_add_`.  The cycle reads nothing back to
the host (no `.item()`, no branch on a tensor).

All matrix products run with TF32 off (config.py), the counterpart of the
reference's `jax.default_matmul_precision("highest")`: reduced-precision
multiplies lose the SPD-ness of the Galerkin assembly chain at elasticity
conditioning.

`smooth_prolongator=True` upgrades the tentative transfers to smoothed
aggregation (Vanek/Mandel/Brezina): P_s = (I - omega B^-1 A) P_t with
the l1 blocks as B and omega = 4/3 / lam_max(B^-1 A) power-estimated
per level.  Because A carries the densities, P_s is rebuilt ON DEVICE
each SIMP iteration: the fine operator is assembled once per iteration
in node-node block-sparse form and the Galerkin triple products run
over host-precomputed flat term indices (see _sa_structure), in chunks.
"""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import config  # noqa: F401  (pins TF32 off)
from ..tracing import spanned, sync
from .operator import group_sum, padded_groups

__all__ = ["greedy_aggregate", "rigid_body_prolongator", "MultilevelAMG"]


def _node_adjacency(connectivity, n_nodes):
    """Symmetric node-node adjacency (CSR) from element connectivity."""
    conn = np.asarray(connectivity)
    nn = conn.shape[1]
    rows, cols = [], []
    for a in range(nn):
        for b in range(nn):
            if a != b:
                rows.append(conn[:, a])
                cols.append(conn[:, b])
    data = np.ones(len(rows) * conn.shape[0], dtype=np.int8)
    A = sp.coo_matrix(
        (data, (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_nodes, n_nodes)).tocsr()
    A.sum_duplicates()
    return A


def _greedy_csr(indptr, indices, n, max_agg=0):
    """Greedy root-node aggregation on a CSR graph (see greedy_aggregate).
    max_agg > 0 caps the aggregate size (absorb at most max_agg - 1
    neighbors per seed; attach passes respect the cap best-effort)."""
    agg = np.full(n, -1, dtype=np.int64)
    count = []
    n_agg = 0
    for v in range(n):
        if agg[v] != -1:
            continue
        nbrs = indices[indptr[v]:indptr[v + 1]]
        if np.all(agg[nbrs] == -1):
            if max_agg > 0 and nbrs.size > max_agg - 1:
                nbrs = nbrs[:max_agg - 1]
            agg[v] = n_agg
            agg[nbrs] = n_agg
            count.append(1 + nbrs.size)
            n_agg += 1
    for v in range(n):
        if agg[v] != -1:
            continue
        nbrs = indices[indptr[v]:indptr[v + 1]]
        owners = agg[nbrs]
        owners = owners[owners >= 0]
        if owners.size:
            counts = np.bincount(owners)
            if max_agg > 0:
                open_ = [o for o in np.argsort(counts)[::-1] if counts[o]
                         and count[o] < max_agg]
                if open_:
                    a = int(open_[0])
                    agg[v] = a
                    count[a] += 1
                    continue
            agg[v] = counts.argmax()
            count[agg[v]] += 1
        else:
            agg[v] = n_agg
            count.append(1)
            n_agg += 1
    return agg.astype(np.int32), n_agg


def greedy_aggregate(connectivity, n_nodes, max_agg=0):
    """Root-node aggregation of the mesh node graph.

    Pass 1 seeds aggregates at nodes whose whole neighborhood is free and
    absorbs the neighborhood; pass 2 attaches remaining nodes to the
    aggregate most common among their neighbors; pass 3 makes singleton
    aggregates of anything isolated.  Returns (agg_index (n_nodes,) int32,
    n_aggregates).
    """
    A = _node_adjacency(connectivity, n_nodes)
    return _greedy_csr(A.indptr, A.indices, n_nodes, max_agg=max_agg)


def rigid_body_prolongator(coords, agg, n_agg, free_mask,
                           return_coarse=False):
    """Per-node (3, 6) prolongator blocks spanning the BC-masked rigid body
    modes of each aggregate.

    Columns are the aggregate's 6 RBMs (3 translations + 3 rotations about
    its centroid), rows masked by the Dirichlet mask BEFORE the per-
    aggregate SVD orthonormalization, so constrained dofs drop out of the
    coarse basis instead of wasting columns.  Rank-deficient aggregates
    (few free dofs) get zero columns; the coarse assembly regularizes the
    matching diagonal entries.

    return_coarse=True additionally returns the coarse near-nullspace
    B1 (n_agg, 6, 6) with B0|agg = Q @ B1[agg] (the S V^T factor of each
    per-aggregate SVD) — the seed for recursive aggregation.
    """
    coords = np.asarray(coords, dtype=np.float64)
    n_nodes = coords.shape[0]
    mask = np.asarray(free_mask, dtype=np.float64).reshape(n_nodes, 3)
    P = np.zeros((n_nodes, 3, 6))
    Bc = np.zeros((n_agg, 6, 6))
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(n_agg + 1))
    for a in range(n_agg):
        nodes = order[bounds[a]:bounds[a + 1]]
        if nodes.size == 0:
            continue
        x = coords[nodes] - coords[nodes].mean(axis=0)
        m = nodes.size
        B = np.zeros((m, 3, 6))
        B[:, :, :3] = np.eye(3)
        # rotations: r = omega x (x - centroid)
        B[:, 0, 4], B[:, 0, 5] = x[:, 2], -x[:, 1]
        B[:, 1, 3], B[:, 1, 5] = -x[:, 2], x[:, 0]
        B[:, 2, 3], B[:, 2, 4] = x[:, 1], -x[:, 0]
        B *= mask[nodes][:, :, None]
        U, s, Vt = np.linalg.svd(B.reshape(3 * m, 6), full_matrices=False)
        r = int((s > max(1e-10, 1e-8 * (s[0] if s.size else 0.0))).sum())
        P[nodes, :, :r] = U[:, :r].reshape(m, 3, r)
        Bc[a, :r, :] = s[:r, None] * Vt[:r]
    # SVD leaves O(eps) residue in masked rows — re-mask so constrained
    # dofs are EXACTLY outside the coarse space.
    P *= mask[:, :, None]
    if return_coarse:
        return P, Bc
    return P


def _tentative_from_basis(B, agg, n_agg):
    """Tentative prolongator for a coarse level from its near-nullspace.

    B: (n, k, 6) per-node basis rows (k dofs per node).  Per aggregate the
    stacked member rows (m*k, 6) are SVD-orthonormalized: P holds the Q
    factor as per-node (k, 6) blocks (zero columns beyond the rank), and
    the next-level basis is the S V^T factor, so B|agg = Q @ B_next[agg].
    """
    B = np.asarray(B, dtype=np.float64)
    n, k, _ = B.shape
    P = np.zeros((n, k, 6))
    Bc = np.zeros((n_agg, 6, 6))
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(n_agg + 1))
    for a in range(n_agg):
        nodes = order[bounds[a]:bounds[a + 1]]
        if nodes.size == 0:
            continue
        m = nodes.size
        M = B[nodes].reshape(m * k, 6)
        U, s, Vt = np.linalg.svd(M, full_matrices=False)
        r = int((s > max(1e-10, 1e-8 * (s[0] if s.size else 0.0))).sum())
        P[nodes, :, :r] = U[:, :r].reshape(m, k, r)
        Bc[a, :r, :] = s[:r, None] * Vt[:r]
    return P, Bc


def _unique_pairs(rows, cols, n):
    """Sorted unique (row, col) pair list + inverse index for scatter-adds."""
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    upairs, inv = np.unique(key, return_inverse=True)
    return ((upairs // n).astype(np.int32), (upairs % n).astype(np.int32),
            inv.astype(np.int32))


def _sa_structure(p_rows, p_cols, agg, n_agg, n_fine):
    """Index structure for one smoothed-prolongator transfer (host, once).

    Given a level's operator pair pattern (p_rows, p_cols) and its
    aggregation map, the smoothed prolongator P_s = (I - w B^-1 A) P_t
    lives on the (fine row, aggregate) pattern

        {(r, agg[c]) for pairs} U {(v, agg[v]) for fine rows v}

    and the next-level Galerkin operator A' = P_s^T A P_s on the pattern
    {(a, b) : a in aggs(row m), b in aggs(row n), (m, n) a pair}.  Returns

      na_rows, na_cols       the P_s pattern (sorted row-major)
      pair2na                pair id -> na id of (p_rows, agg[p_cols])
                             (scatter target for Y = A P_t)
      inject                 fine row v -> na id of (v, agg[v])
                             (scatter target for the P_t term of P_s)
      t_pid, t_left, t_right, t_out
                             flat term arrays of the triple product
                             A'[t_out] += P_s[t_left]^T A[t_pid] P_s[t_right]
      q_rows, q_cols         the A' pattern
    """
    p_rows = np.asarray(p_rows)
    p_cols = np.asarray(p_cols)
    agg = np.asarray(agg, dtype=np.int64)
    key = p_rows.astype(np.int64) * n_agg + agg[p_cols]
    keyv = np.arange(n_fine, dtype=np.int64) * n_agg + agg[:n_fine]
    ukeys, inv = np.unique(np.concatenate([key, keyv]), return_inverse=True)
    na_rows = (ukeys // n_agg).astype(np.int32)
    na_cols = (ukeys % n_agg).astype(np.int32)
    pair2na = inv[:key.size].astype(np.int32)
    inject = inv[key.size:].astype(np.int32)
    # CSR of the (sorted) na entries by fine row
    start = np.searchsorted(na_rows, np.arange(n_fine + 1)).astype(np.int64)
    deg = start[1:] - start[:-1]
    dL, dR = deg[p_rows], deg[p_cols]
    tcount = dL * dR
    total = int(tcount.sum())
    # The triple-product term list is the K^2 DATA footprint of smoothed
    # aggregation (the program size stays constant, the index arrays do
    # not): several int64 host arrays + 4 int32 device arrays of length
    # `total`, which on a fine imported mesh reaches hundreds of terms per
    # node.  Guard before materializing anything so an oversized mesh
    # fails with a budget message instead of a host/HBM OOM mid-sort.
    budget = int(os.environ.get("EASYSIMP_SA_TERM_BUDGET", 300_000_000))
    if total > budget:
        raise ValueError(
            f"smoothed-prolongator term list needs {total:,} triple-product "
            f"entries (> budget {budget:,}; ~{total * 40 / 1e9:.1f} GB host "
            f"during construction). Use amg_smooth_prolongator=False for "
            f"this mesh, or raise EASYSIMP_SA_TERM_BUDGET if the host can "
            f"take it.")
    t_pid = np.repeat(np.arange(p_rows.size, dtype=np.int64), tcount)
    offs = np.concatenate([[0], np.cumsum(tcount)[:-1]])
    k = np.arange(total, dtype=np.int64) - offs[t_pid]
    t_left = start[p_rows][t_pid] + k // dR[t_pid]
    t_right = start[p_cols][t_pid] + k % dR[t_pid]
    okey = na_cols[t_left].astype(np.int64) * n_agg + na_cols[t_right]
    uo, t_out = np.unique(okey, return_inverse=True)
    q_rows = (uo // n_agg).astype(np.int32)
    q_cols = (uo % n_agg).astype(np.int32)
    terms = (t_pid.astype(np.int32), t_left.astype(np.int32),
             t_right.astype(np.int32), t_out.astype(np.int32))
    return na_rows, na_cols, pair2na, inject, terms, q_rows, q_cols


class MultilevelAMG:
    """Recursive RBM-aggregation preconditioner for UnstructuredOperator.

    Host-side constants are built in __init__; `setup(scale, free_mask,
    Binv, A)` runs once per SIMP iteration (returns the per-level operator
    blocks, smoother data, and the coarsest Cholesky factor), `apply(...)`
    is the per-CG-iteration V-cycle.

    max_coarse_dofs bounds the dense coarsest factorization; the hierarchy
    recurses until the coarse dimension fits (or coarsening stalls).
    `build_seconds` holds the host time of the constructor by part.
    """

    # transient budget for the chunked level-1 assembly (bytes)
    _CHUNK_BYTES = 96 * 1024 * 1024

    # chunk length for the smoothed-prolongator triple product
    _SA_TERM_CHUNK = 1 << 18

    def __init__(self, op, mesh, free_mask, power_iters=8,
                 max_coarse_dofs=6000, max_levels=10, smooth_iters=(3, 3),
                 max_agg_nodes=0, smooth_prolongator=False):
        # smooth_iters default: (1,1)/(2,2)/(3,3)/(2,4) measured CG
        # 158/118/99/118 at equal wall on the 24^3 connected two-phase
        # study of the reference package (scripts/amg_scaling_study.py)
        self.op = op
        self.dtype = op.dtype
        self.device = op.device
        self.power_iters = int(power_iters)   # retained for API compat
        if isinstance(smooth_iters, int):
            smooth_iters = (smooth_iters, smooth_iters)
        # Chebyshev degrees: [0] at the fine level, [1] on coarse levels
        self.smooth_iters = tuple(int(s) for s in smooth_iters)
        conn = np.asarray(mesh.connectivity)
        n_nodes = mesh.n_nodes
        E, nn = conn.shape
        self.nn = nn
        self.build_seconds = {}
        t_start = time.perf_counter()

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        def val(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                   device=self.device)

        # ---- level 0 -> 1: RBM tentative prolongator --------------------
        t0 = time.perf_counter()
        agg0, n1 = greedy_aggregate(conn, n_nodes, max_agg=max_agg_nodes)
        self.build_seconds["aggregation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        Pn, B = rigid_body_prolongator(mesh.node_coords, agg0, n1,
                                       np.asarray(free_mask),
                                       return_coarse=True)
        self.build_seconds["prolongator"] = time.perf_counter() - t0
        self.Pn = val(Pn)                                 # (n, 3, 6)
        self.agg_idx = idx(agg0)                          # (n,)
        self.agg_members = idx(padded_groups(agg0, n1))   # (n1, max size)
        self.n_nodes = n_nodes
        self.node_conn = idx(conn)

        self.smooth_p = bool(smooth_prolongator)
        self._sa_na = []        # per-transfer (na_rows, na_cols)
        self._sa_na_tables = []  # per-transfer (by row, by column) tables
        self._sa_pair2na = []   # per-transfer pair id -> na id
        self._sa_inject = []    # per-transfer fine row -> na id of (v, agg[v])
        self._sa_terms = []     # per-transfer padded (C, chunk) term arrays
        self._power_starts = {}
        if self.smooth_p:
            # node-node pair pattern (self-pairs forced so the P_t
            # injection slot (v, agg[v]) always exists)
            rn = np.broadcast_to(conn[:, :, None], (E, nn, nn)).ravel()
            cn = np.broadcast_to(conn[:, None, :], (E, nn, nn)).ravel()
            arange_n = np.arange(n_nodes)
            n_rows, n_cols, inv_nn = _unique_pairs(
                np.concatenate([rn, arange_n]),
                np.concatenate([cn, arange_n]), n_nodes)
            self.elem_nodepair_idx = idx(
                inv_nn[:E * nn * nn].reshape(E, nn, nn))
            self.nodepair_rows = idx(n_rows)
            self.nodepair_cols = idx(n_cols)
            self.elem_pair_idx = None
            p_rows, p_cols = self._push_sa_level(n_rows, n_cols, agg0, n1,
                                                 n_nodes)
            # aggregation GRAPH for the deeper levels: the tentative
            # (distance-1) aggregate adjacency, NOT the smoothed operator
            # pattern: greedy aggregation on the dist-3 smoothed pattern
            # absorbs whole neighborhoods and over-coarsens
            ea = agg0[conn]
            t_rows, t_cols, _ = _unique_pairs(
                np.broadcast_to(ea[:, :, None], (E, nn, nn)).ravel(),
                np.broadcast_to(ea[:, None, :], (E, nn, nn)).ravel(), n1)
        else:
            # level-1 block-pair structure from the element connectivity
            ea = agg0[conn]                               # (E, nn)
            rows = np.broadcast_to(ea[:, :, None], (E, nn, nn)).ravel()
            cols = np.broadcast_to(ea[:, None, :], (E, nn, nn)).ravel()
            p_rows, p_cols, inv = _unique_pairs(rows, cols, n1)
            self.elem_pair_idx = idx(inv.reshape(E, nn, nn))

        # chunk slices so the (c, nn, nn, 6, 6) assembly transient stays
        # bounded on multi-million-element meshes
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_elem = (nn * 3 * nn * 6 + nn * nn * 36) * itemsize
        chunk = max(1, self._CHUNK_BYTES // per_elem)
        self.chunk_slices = [(s, min(s + chunk, E))
                             for s in range(0, E, chunk)]

        # l1 block-Jacobi smoother constants (Baker-Falgout-Kolev-Yang):
        # signed 3x3 corner blocks of ke and the per-dof OFF-block |ke| row
        # sums.  B_I = A_II + diag(sum_{j not in I} |A_ij|) majorizes A
        # (2|a|xy <= |a|(x^2+y^2) entrywise), so lam_max(B^-1 A) <= 1
        # EXACTLY: the Chebyshev interval needs no spectral estimation.
        ke_r = op.ke.cpu().numpy().reshape(E, nn, 3, nn, 3)
        corner = np.stack([ke_r[:, a, :, a, :] for a in range(nn)], axis=1)
        absrow = np.abs(ke_r).sum(axis=(3, 4))
        within = np.abs(corner).sum(axis=3)
        self.ke_corner = val(corner)
        self.ke_l1off = val(absrow - within)

        # ---- deeper levels: recurse on the aggregate graph --------------
        self.sizes = [n1]                  # nodes per coarse level
        pair_rows, pair_cols = [p_rows], [p_cols]
        self.P_coarse = []                 # per-level (n_l, 6, 6) blocks
        self.agg_coarse = []               # per-level aggregation maps
        self.agg_coarse_members = []       # aggregate -> member tables
        self.pair_maps = []                # pair index l -> l+1
        self.diag_idx = []                 # positions of (i, i) pairs
        np_rows, np_cols = p_rows, p_cols
        while 6 * self.sizes[-1] > max_coarse_dofs and \
                len(self.sizes) < max_levels:
            n_l = self.sizes[-1]
            g_rows, g_cols = (t_rows, t_cols) if self.smooth_p \
                else (np_rows, np_cols)
            off = g_rows != g_cols
            A = sp.coo_matrix(
                (np.ones(off.sum(), dtype=np.int8),
                 (g_rows[off], g_cols[off])), shape=(n_l, n_l)).tocsr()
            A.sum_duplicates()
            t0 = time.perf_counter()
            agg_l, n_next = _greedy_csr(A.indptr, A.indices, n_l,
                                        max_agg=max_agg_nodes)
            self.build_seconds["aggregation"] += time.perf_counter() - t0
            if n_next >= n_l:              # coarsening stalled
                break
            t0 = time.perf_counter()
            P_l, B = _tentative_from_basis(B, agg_l, n_next)
            self.build_seconds["prolongator"] += time.perf_counter() - t0
            if self.smooth_p:
                q_rows, q_cols = self._push_sa_level(np_rows, np_cols,
                                                     agg_l, n_next, n_l)
                t_rows, t_cols, _ = _unique_pairs(
                    agg_l[t_rows], agg_l[t_cols], n_next)
            else:
                rows_next = agg_l[np_rows]
                cols_next = agg_l[np_cols]
                q_rows, q_cols, pair_map = _unique_pairs(
                    rows_next, cols_next, n_next)
                self.pair_maps.append(idx(pair_map))
            self.P_coarse.append(val(P_l))
            self.agg_coarse.append(idx(agg_l))
            self.agg_coarse_members.append(
                idx(padded_groups(agg_l, n_next)))
            self.sizes.append(n_next)
            pair_rows.append(q_rows)
            pair_cols.append(q_cols)
            np_rows, np_cols = q_rows, q_cols
        self.pair_rows = [idx(r) for r in pair_rows]
        self.pair_cols = [idx(c) for c in pair_cols]
        # row -> the pairs of that row (the level matvec's fixed-order sum)
        self.row_pairs = [idx(padded_groups(r, n))
                          for r, n in zip(pair_rows, self.sizes)]
        for l, (r, c) in enumerate(zip(pair_rows, pair_cols)):
            d = np.nonzero(r == c)[0]
            # nodes without a self-pair (isolated in the graph) map to
            # slot 0 and get identity blocks in _level_l1_binv
            pos = np.zeros(self.sizes[l], dtype=np.int64)
            has = np.zeros(self.sizes[l], dtype=bool)
            pos[r[d]] = d
            has[r[d]] = True
            self.diag_idx.append((idx(pos), val(has)))
        self.n_coarse_levels = len(self.sizes)
        self.nc = 6 * self.sizes[-1]       # coarsest (dense) dimension
        total = time.perf_counter() - t_start
        self.build_seconds["structure"] = total - sum(
            self.build_seconds.values())

    def _push_sa_level(self, p_rows, p_cols, agg, n_agg, n_fine):
        """Build + store the smoothed-transfer index structure for one
        level (host, once); returns the next level's operator pattern."""
        (na_r, na_c, pair2na, inject, terms,
         q_rows, q_cols) = _sa_structure(p_rows, p_cols, agg, n_agg, n_fine)

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        self._sa_na.append((idx(na_r), idx(na_c)))
        self._sa_na_tables.append((idx(padded_groups(na_r, n_fine)),
                                   idx(padded_groups(na_c, n_agg))))
        self._sa_pair2na.append(idx(pair2na))
        self._sa_inject.append(idx(inject))
        # pad the term arrays to a chunk multiple; padded entries add into
        # a dummy row n_out that _sa_galerkin drops
        t_pid, t_left, t_right, t_out = terms
        total = t_pid.size
        chunk = max(1, min(total, self._SA_TERM_CHUNK))
        n_chunks = -(-total // chunk)
        pad = n_chunks * chunk - total

        def _padded(a, fill):
            return idx(np.concatenate(
                [a, np.full(pad, fill, dtype=a.dtype)]).reshape(
                    n_chunks, chunk))

        self._sa_terms.append((_padded(t_pid, 0), _padded(t_left, 0),
                               _padded(t_right, 0),
                               _padded(t_out, q_rows.size)))
        return q_rows, q_cols

    # ----- level-0 transfer operators (device) -----------------------------
    def restrict(self, r):
        """P^T r: (3n,) -> level-1 (n1 * 6,)."""
        rn = r.reshape(self.n_nodes, 3)
        contrib = torch.einsum("nik,ni->nk", self.Pn, rn)   # (n, 6)
        return group_sum(contrib, self.agg_members).reshape(-1)

    def prolong(self, zc):
        """P zc: level-1 (n1 * 6,) -> (3n,)."""
        za = zc.reshape(self.sizes[0], 6)[self.agg_idx]     # (n, 6)
        return torch.einsum("nik,nk->ni", self.Pn, za).reshape(-1)

    # ----- per-SIMP-iteration setup (device) -------------------------------
    def _assemble_level1(self, scale):
        """A_1 block-sparse: (n_pairs1, 6, 6) = sum_e E_e P_a^T ke_e P_b,
        chunked over elements."""
        return self._level1_part(self.op.ke, scale, self.Pn, self.node_conn,
                                 self.elem_pair_idx, self.chunk_slices)

    def _level1_part(self, ke, scale, Pn, node_conn, pair_idx, chunks):
        """`_assemble_level1` over the elements of the given element-indexed
        inputs (all of them, or one shard's), on their device."""
        nn = self.nn
        acc = torch.zeros((self.pair_rows[0].shape[0], 6, 6),
                          dtype=self.dtype, device=ke.device)
        for s, e in chunks:
            c = e - s
            pe = Pn[node_conn[s:e]]                       # (c, nn, 3, 6)
            w = scale[s:e].to(self.dtype)
            keb = (ke[s:e] * w[:, None, None]).reshape(c, nn, 3, nn, 3)
            half = torch.einsum("eacbd,ebdj->eacbj", keb, pe)
            g = torch.einsum("eaci,eacbj->eabij", pe, half)
            acc.index_add_(0, pair_idx[s:e].reshape(-1),
                           g.reshape(-1, 6, 6))
        return acc

    def _galerkin_next(self, l, blocks):
        """A_{l+1} blocks from A_l blocks through the tentative P_l."""
        P = self.P_coarse[l]
        rows, cols = self.pair_rows[l], self.pair_cols[l]
        half = torch.bmm(blocks, P[cols])                 # "pkl,plj->pkj"
        g = torch.bmm(P[rows].transpose(1, 2), half)      # "pki,pkj->pij"
        out = torch.zeros((self.pair_rows[l + 1].shape[0], 6, 6),
                          dtype=blocks.dtype, device=blocks.device)
        return out.index_add_(0, self.pair_maps[l], g)

    # ----- smoothed-aggregation setup pieces (device) ----------------------
    #
    # The tentative (unsmoothed) transfers give piecewise-RBM coarse
    # spaces whose energy error grows with aggregate diameter, the
    # classic size-degrading convergence of plain aggregation AMG.  One
    # damped-Jacobi smoothing step
    #
    #     P_s = (I - (4/3) B^-1 A) P_t
    #
    # (Vanek/Mandel/Brezina) restores near-optimal approximation.  B is
    # the l1 smoother block diagonal already built per level; its exact
    # bound lam_max(B^-1 A) <= 1 is ~2.5x LOOSE for elasticity (sign
    # cancellations in the off-block row sums), which leaves omega = 4/3
    # under-damped, so omega = 4/3 / lam uses a POWER-ITERATION estimate
    # of lam_max(B^-1 A) per level (_sa_lambda below; safe because any
    # P_s yields an SPSD A', estimate error only degrades transfer
    # quality gracefully).  Because A changes with the densities, P_s is
    # rebuilt on device each SIMP iteration: the fine operator is
    # assembled once in node-node block-sparse form, Y = A P_t rides a
    # precomputed pair -> (row, agg) map, and the Galerkin product
    # P_s^T A P_s runs over precomputed flat term indices (_sa_structure).

    def _assemble_node_blocks(self, scale, free_mask):
        """Masked fine operator in node-node block-sparse form:
        (n_nodepairs, 3, 3), chunk-assembled from the element ke."""
        acc = self._node_blocks_part(self.op.ke, scale,
                                     self.elem_nodepair_idx,
                                     self.chunk_slices)
        m = free_mask.reshape(self.n_nodes, 3).to(acc.dtype)
        return (acc * m[self.nodepair_rows][:, :, None]
                * m[self.nodepair_cols][:, None, :])

    def _node_blocks_part(self, ke, scale, nodepair_idx, chunks):
        """The unmasked node-node blocks over the elements of the given
        element-indexed inputs, on their device."""
        sc = scale.to(self.dtype)
        nn = self.nn
        acc = torch.zeros((self.nodepair_rows.shape[0], 3, 3),
                          dtype=self.dtype, device=ke.device)
        for s, e in chunks:
            c = e - s
            keb = (ke[s:e] * sc[s:e, None, None]).reshape(c, nn, 3, nn, 3)
            g = keb.permute(0, 1, 3, 2, 4)                # (c, nn, nn, 3, 3)
            acc.index_add_(0, nodepair_idx[s:e].reshape(-1),
                           g.reshape(-1, 3, 3))
        return acc

    # Power iterations for the prolongator damping omega = 4/3 / lam.
    # Unlike the Chebyshev interval (where an under-read DIVERGES), the
    # damping only shapes P_s: A' = P_s^T A P_s is SPSD for ANY P_s, so
    # estimate error degrades transfer quality gracefully.
    _SA_POWER_ITERS = 10

    def _power_start(self, n_fine, k):
        """The integer-Knuth-hash start vector of `_sa_lambda`, built once
        on the host in uint32 (the reference's bits) and kept on the
        device."""
        key = (n_fine, k)
        if key not in self._power_starts:
            h = (np.arange(n_fine * k, dtype=np.uint32)
                 * np.uint32(2654435761))
            v = (h >> np.uint32(8)).astype(np.float64) / 2.0**24 - 0.5
            self._power_starts[key] = torch.as_tensor(
                v.reshape(n_fine, k), dtype=self.dtype, device=self.device)
        return self._power_starts[key]

    def _sa_lambda(self, Aapply, Bapply, n_fine, k):
        """Power-iteration estimate of lam_max(B^-1 A) at one level."""
        v = self._power_start(n_fine, k)
        tiny = torch.finfo(self.dtype).tiny
        lam = torch.ones((), dtype=self.dtype, device=self.device)
        for _ in range(self._SA_POWER_ITERS):
            w = Bapply(Aapply(v))
            ww = (w * w).sum()
            lam = torch.sqrt(ww / torch.clamp((v * v).sum(), min=tiny))
            v = w / torch.clamp(torch.sqrt(ww), min=tiny)
        return torch.clamp(lam, 0.05, 1.0)

    def _node_matvec(self, Anode, v):
        """Masked fine matvec through the node-node blocks; v (n, 3)."""
        contrib = torch.bmm(Anode, v[self.nodepair_cols].unsqueeze(-1))
        return torch.zeros_like(v).index_add_(0, self.nodepair_rows,
                                              contrib.squeeze(-1))

    def _smooth_transfer(self, l, blocks, cols, Binv, Pt, omega):
        """P_s = P_t - omega B^-1 (A P_t) on the precomputed na pattern.
        blocks: (n_pairs, k, k) A blocks, cols their column ids, Binv the
        l1 block inverses (n_fine, k, k), Pt (n_fine, k, 6)."""
        na_r, _ = self._sa_na[l]
        y = torch.bmm(blocks, Pt[cols])                   # "pab,pbj->paj"
        Y = torch.zeros((na_r.shape[0], *Pt.shape[1:]), dtype=Pt.dtype,
                        device=Pt.device)
        Y.index_add_(0, self._sa_pair2na[l], y)
        Z = torch.zeros_like(Y)
        Z[self._sa_inject[l]] = Pt
        return Z - omega * torch.bmm(Binv[na_r], Y)

    def _sa_galerkin(self, l, Amid, Ps):
        """A_next = P_s^T A P_s over the flat term index, one padded chunk
        of terms at a time."""
        n_out = int(self.pair_rows[l].shape[0])
        acc = torch.zeros((n_out + 1, 6, 6), dtype=Amid.dtype,
                          device=Amid.device)
        pid, lft, rgt, out = self._sa_terms[l]
        for c in range(pid.shape[0]):
            half = torch.bmm(Amid[pid[c]], Ps[rgt[c]])    # "tkl,tlj->tkj"
            g = torch.bmm(Ps[lft[c]].transpose(1, 2), half)
            acc.index_add_(0, out[c], g)
        return acc[:-1]

    def _matvec_level(self, l, blocks, v):
        """Block-sparse A_l v; v (n_l, 6)."""
        contrib = torch.bmm(blocks, v[self.pair_cols[l]].unsqueeze(-1))
        return group_sum(contrib.squeeze(-1), self.row_pairs[l])

    # Chebyshev smoothing intervals.
    #
    # An UPPER bound on lam_max(B^-1 A) is mandatory: Chebyshev (and
    # damped Jacobi) AMPLIFY the spectrum above their interval, and a
    # power-iteration Rayleigh quotient is a LOWER bound: at SIMP
    # contrast the top eigenvalues cluster, a few power steps under-read
    # lam_max and the smoother diverges on the missed band (CG stalls at
    # maxiter).  The l1 regularization of the smoother itself makes
    # lam_max <= 1 EXACT, with no spectral estimation anywhere.

    def _fine_l1_binv(self, scale, free_mask):
        """Inverse l1-regularized 3x3 nodal blocks of the fine operator;
        BC rows/cols masked to identity."""
        sc = scale.to(self.dtype)
        B = self.op.scatter_nodes(sc[:, None, None, None] * self.ke_corner)
        off = self.op.scatter_nodes(sc[:, None, None] * self.ke_l1off)
        eye = torch.eye(3, dtype=self.dtype, device=self.device)[None]
        B = B + off[:, :, None] * eye
        m = free_mask.reshape(self.n_nodes, 3).to(self.dtype)
        B = B * m[:, :, None] * m[:, None, :]
        B = B + (1.0 - m)[:, :, None] * eye
        with sync("amg_l1_inv"):        # linalg.inv reads its status back
            return torch.linalg.inv(B)

    def _level_l1_binv(self, l, blocks):
        """Inverse l1-regularized 6x6 diagonal blocks of A_l."""
        pos, has = self.diag_idx[l]
        D = blocks[pos] * has[:, None, None].to(blocks.dtype)
        absrow = group_sum(blocks.abs().sum(dim=-1), self.row_pairs[l])
        off = absrow - D.abs().sum(dim=-1)
        eye = torch.eye(6, dtype=blocks.dtype, device=blocks.device)[None]
        B = D + off[:, :, None] * eye
        d = torch.diagonal(B, dim1=1, dim2=2)
        fix = (d <= 1e-30).to(B.dtype)
        B = B + fix[:, :, None] * eye
        with sync("amg_l1_inv"):
            return torch.linalg.inv(B)

    def _coarsest_factor(self, blocks):
        """Dense coarsest assembly + DIAGONALLY-SCALED regularized Cholesky.

        Symmetric diagonal scaling before factorizing, exactly like the
        voxel path's scaled Cholesky (ops/multigrid.py): SIMP contrast
        lives almost entirely in the diagonal, and the raw float32
        factorization is fragile where the unit-diagonal scaled one stays
        finite.  Zero rows (rank-deficient aggregate padding in the RBM
        basis) get identity pivots; their residuals are exactly zero, so
        the identity never enters the correction.  Returns (L, dinv_sqrt)
        with A ~= D^1/2 (L L^T) D^1/2.  `cholesky_ex` does not read its
        status back, so the setup has no host sync."""
        nL = self.sizes[-1]
        rows, cols = self.pair_rows[-1], self.pair_cols[-1]
        Ac = torch.zeros((nL, nL, 6, 6), dtype=blocks.dtype,
                         device=blocks.device)
        Ac[rows, cols] = blocks                  # the pairs are unique
        Ac = Ac.permute(0, 2, 1, 3).reshape(self.nc, self.nc)
        d = torch.diagonal(Ac)
        live = d > 1e-30
        dinv_sqrt = torch.where(
            live, 1.0 / torch.sqrt(torch.clamp(d, min=1e-30)),
            torch.ones_like(d))
        As = Ac * dinv_sqrt[:, None] * dinv_sqrt[None, :]
        fix = 1.0 - live.to(Ac.dtype)
        shift = 100.0 * torch.finfo(Ac.dtype).eps
        As = As + torch.diag(fix + shift)
        L, _ = torch.linalg.cholesky_ex(As)
        return L, dinv_sqrt

    @spanned("amg.setup")
    def setup(self, scale, free_mask, Binv=None, A=None):
        """Once per SIMP iteration.  Returns the opaque state dict for
        `apply`: per-level operator blocks + l1-regularized block-Jacobi
        smoother inverses (lam_max(B^-1 A) <= 1 by construction) and the
        coarsest Cholesky factor.  `Binv`/`A` are accepted for API
        stability; smoothing uses the l1 blocks, not the plain
        block-Jacobi inverse.  With smooth_prolongator the per-level
        smoothed transfers P_s (density-dependent) join the state."""
        Binv0 = self._fine_l1_binv(scale, free_mask)
        if self.smooth_p:
            Anode = self._assemble_node_blocks(scale, free_mask)
            lam0 = self._sa_lambda(
                lambda v: self._node_matvec(Anode, v),
                lambda v: torch.bmm(Binv0, v.unsqueeze(-1)).squeeze(-1),
                self.n_nodes, 3)
            Ps0 = self._smooth_transfer(0, Anode, self.nodepair_cols,
                                        Binv0, self.Pn, (4.0 / 3.0) / lam0)
            blocks = [self._sa_galerkin(0, Anode, Ps0)]
            Ps_list = [Ps0]
            Binvs = []
            for l in range(self.n_coarse_levels - 1):
                Bl = self._level_l1_binv(l, blocks[l])
                Binvs.append(Bl)
                lam = self._sa_lambda(
                    lambda v: self._matvec_level(l, blocks[l], v),
                    lambda v: torch.bmm(Bl, v.unsqueeze(-1)).squeeze(-1),
                    self.sizes[l], 6)
                Psl = self._smooth_transfer(l + 1, blocks[l],
                                            self.pair_cols[l], Bl,
                                            self.P_coarse[l],
                                            (4.0 / 3.0) / lam)
                Ps_list.append(Psl)
                blocks.append(self._sa_galerkin(l + 1, blocks[l], Psl))
            L = self._coarsest_factor(blocks[-1])
            return {"blocks": tuple(blocks[:-1]), "Binvs": tuple(Binvs),
                    "L": L, "Binv0": Binv0, "Ps": tuple(Ps_list)}
        blocks = [self._assemble_level1(scale)]
        for l in range(self.n_coarse_levels - 1):
            blocks.append(self._galerkin_next(l, blocks[-1]))
        Binvs = [self._level_l1_binv(l, blocks[l])
                 for l in range(self.n_coarse_levels - 1)]
        L = self._coarsest_factor(blocks[-1])
        return {"blocks": tuple(blocks[:-1]), "Binvs": tuple(Binvs),
                "L": L, "Binv0": Binv0}

    @staticmethod
    def _chebyshev(Bapply, Aapply, r, x, iters):
        """Degree-`iters` Chebyshev polynomial in (B^-1 A) over the FIXED
        interval [1/6, 1]: the same three-term recurrence and interval
        ratio as the voxel multigrid's smoother; the l1 smoother blocks make
        lam_max <= 1 exact (see above).  x=None means the initial iterate
        is exactly zero (pre-smooth), saving one operator apply."""
        lam_max = 1.0
        lam_min = lam_max / 6.0
        theta = 0.5 * (lam_max + lam_min)
        delta = 0.5 * (lam_max - lam_min)
        sigma = theta / delta
        res = r if x is None else r - Aapply(x)
        d = Bapply(res) / theta
        x = d if x is None else x + d
        rho_old = 1.0 / sigma
        for _ in range(1, iters):
            rho = 1.0 / (2.0 * sigma - rho_old)
            res = r - Aapply(x)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * Bapply(res)
            x = x + d
            rho_old = rho
        return x

    # ----- per-CG-iteration V-cycle (device) -------------------------------
    def _cycle(self, l, state, r):
        """Symmetric V-cycle on coarse level l; r (n_l, 6)."""
        if l == self.n_coarse_levels - 1:
            L, dinv_sqrt = state["L"]
            rf = (r.reshape(-1) * dinv_sqrt).unsqueeze(-1)
            zc = dinv_sqrt * torch.cholesky_solve(rf, L).squeeze(-1)
            return zc.reshape(r.shape)
        blocks = state["blocks"][l]
        Binv = state["Binvs"][l]

        def Bapply(v):
            return torch.bmm(Binv, v.unsqueeze(-1)).squeeze(-1)

        def Aapply(v):
            return self._matvec_level(l, blocks, v)

        deg = self.smooth_iters[1]
        z = self._chebyshev(Bapply, Aapply, r, None, deg)
        res = r - Aapply(z)
        if self.smooth_p:
            Ps = state["Ps"][l + 1]
            na_r, na_c = self._sa_na[l + 1]
            by_row, by_col = self._sa_na_tables[l + 1]
            rc = group_sum(torch.einsum("pki,pk->pi", Ps, res[na_r]),
                           by_col)
            zc = self._cycle(l + 1, state, rc)
            z = z + group_sum(torch.einsum("pki,pi->pk", Ps, zc[na_c]),
                              by_row)
        else:
            P = self.P_coarse[l]
            rc = group_sum(torch.einsum("nki,nk->ni", P, res),
                           self.agg_coarse_members[l])
            zc = self._cycle(l + 1, state, rc)
            z = z + torch.einsum("nki,ni->nk", P, zc[self.agg_coarse[l]])
        return self._chebyshev(Bapply, Aapply, r, z, deg)

    @spanned("amg.vcycle")
    def apply(self, r, A, Binv, state, free_mask):
        """Symmetric multilevel cycle: Chebyshev l1-block-Jacobi
        pre-smooth, recursive coarse correction, matching post-smooth.
        `Binv` is accepted for API stability; smoothing uses the l1
        blocks in `state`."""
        B0 = state["Binv0"]

        def Bapply(v):
            return torch.bmm(B0, v.reshape(self.n_nodes, 3, 1)).reshape(-1)

        deg = self.smooth_iters[0]
        z = self._chebyshev(Bapply, A, r, None, deg)
        res = (r - A(z)) * free_mask
        if self.smooth_p:
            Ps = state["Ps"][0]
            na_r, na_c = self._sa_na[0]
            by_row, by_col = self._sa_na_tables[0]
            rn = res.reshape(self.n_nodes, 3)
            rc = group_sum(torch.einsum("pki,pk->pi", Ps, rn[na_r]), by_col)
            zc = self._cycle(0, state, rc)
            corr = group_sum(torch.einsum("pki,pi->pk", Ps, zc[na_c]),
                             by_row)
            z = z + corr.reshape(-1) * free_mask
        else:
            rc = self.restrict(res)
            zc = self._cycle(0, state, rc.reshape(self.sizes[0], 6))
            z = z + self.prolong(zc.reshape(-1)) * free_mask
        return self._chebyshev(Bapply, A, r, z, deg)
