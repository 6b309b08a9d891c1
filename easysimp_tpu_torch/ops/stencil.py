"""27-point block node stencils and Galerkin (RAP) coarsening.

Port of easysimp_tpu/ops/stencil.py.  The assembled voxel stiffness K
couples each node to its 27 neighbours (itself included) through 3x3
blocks; as a tensor it is a field of coefficients C_o(n) in R^{3x3}, one
per offset o in {-1,0,1}^3:

    (K u)(n) = sum_o C_o(n) @ u(n + o),
    C_o(n)   = sum_{a, a+o in corners} E(n - a) * KE[a, a+o]

with KE[a, b] the 3x3 block of the unit-modulus element stiffness for local
corners a, b (ops/elements.py HEX_CORNERS order).

Storage layout, as in the reference: C is (3, 3, 3, 3, 3, nnx, nny, nnz) =
[ox+1, oy+1, oz+1, i, j, x, y, z], 243 scalar coefficient fields with the
spatial dims minor.

The multigrid coarse operators come from here: levels 1-3 straight from
the fine element modulus field, each as one stride-2^k im2col and one
`torch.matmul` against host-composed weights (`level_stencil_from_scale`),
deeper levels by the axis-separable RAP (`coarsen_stencil_axis`).  The
weights are numpy float64, computed on the host.  The float32 matmuls run
in full float32: `config.py` pins TF32 off, as the reference pins
`precision=HIGHEST`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .elements import HEX_CORNERS

__all__ = [
    "ke_corner_blocks",
    "assemble_node_stencil",
    "fold_bc_into_stencil",
    "apply_stencil",
    "apply_stencil_padded",
    "stencil_diagonal",
    "stencil_row_abs_sums",
    "coarsen_stencil_axis",
    "coarsen_stencil",
    "level1_weights",
    "compose_level_weights",
    "level_weight_matrix",
    "level_stencil_from_scale",
    "level1_stencil_from_scale",
    "level_stencil_diag_from_scale",
    "dense_index",
    "stencil_to_dense",
]

_CORNER_INDEX = {c: i for i, c in enumerate(HEX_CORNERS)}
_OFF = (-1, 0, 1)
_OFFS3 = [(x, y, z) for x in _OFF for y in _OFF for z in _OFF]


def _p1(d: int) -> float:
    """1-D trilinear prolongation weight at node distance d (in fine nodes):
    fine node 2N+d receives weight p1(d) from coarse node N."""
    return 1.0 if d == 0 else 0.5


# --------------------------------------------------------------------------
# Host weights (numpy float64)
# --------------------------------------------------------------------------

def ke_corner_blocks(ke) -> np.ndarray:
    """(8, 8, 3, 3) corner-pair blocks of the 24x24 element stiffness."""
    ke = np.asarray(ke, dtype=np.float64)
    return ke.reshape(8, 3, 8, 3).transpose(0, 2, 1, 3)


def _valid_corner_pairs(o):
    """Corner offsets a with both a and a+o in {0,1}^3 (per-axis)."""
    out = []
    for a in HEX_CORNERS:
        b = (a[0] + o[0], a[1] + o[1], a[2] + o[2])
        if b in _CORNER_INDEX:
            out.append((a, b))
    return out


def level1_weights(ke) -> np.ndarray:
    """Weights G of the fused fine-scale -> level-1 Galerkin stencil map

        C1_O(N) = sum_{s in {-2..1}^3} G[O, s] * E_fine(2N + s),

    the assembly map composed with the three-axis RAP, collected by the
    element shift s = d - a.  Returns (3, 3, 3, 4, 4, 4, 3, 3):
    [O+1][s+2][i, j]."""
    KE = ke_corner_blocks(ke)
    G = np.zeros((3, 3, 3, 4, 4, 4, 3, 3), dtype=np.float64)
    for d in _OFFS3:
        pd = _p1(d[0]) * _p1(d[1]) * _p1(d[2])
        for o in _OFFS3:
            for a, b in _valid_corner_pairs(o):
                blk = KE[_CORNER_INDEX[a], _CORNER_INDEX[b]]
                s = (d[0] - a[0], d[1] - a[1], d[2] - a[2])
                for O in _OFFS3:
                    t = (d[0] + o[0] - 2 * O[0],
                         d[1] + o[1] - 2 * O[1],
                         d[2] + o[2] - 2 * O[2])
                    if max(abs(t[0]), abs(t[1]), abs(t[2])) > 1:
                        continue
                    w = pd * _p1(t[0]) * _p1(t[1]) * _p1(t[2])
                    G[O[0] + 1, O[1] + 1, O[2] + 1,
                      s[0] + 2, s[1] + 2, s[2] + 2] += w * blk
    return G


def compose_level_weights(G, k):
    """Level-k Galerkin weights -> level-(k+1) weights, by pushing the
    three 1-D RAPs through the linear map C_k = G_k * E_fine:

        G_{k+1}[O', s'] += p(d) p(d+o-2O') G_k[o, s' - 2^k d]

    per axis; the kernel size doubles per level (4, 8, 16, ...)."""
    half = 1 << k
    for axis in range(3):
        Kk = G.shape[3 + axis]
        shp = list(G.shape)
        shp[3 + axis] = 2 * Kk
        out = np.zeros(shp, G.dtype)
        for O in _OFF:
            for d in _OFF:
                for o in _OFF:
                    t = d + o - 2 * O
                    if abs(t) > 1:
                        continue
                    w = _p1(d) * _p1(t)
                    oi = [slice(None)] * 8
                    oi[axis] = O + 1
                    oi[3 + axis] = slice(half * (d + 1), half * (d + 1) + Kk)
                    gi = [slice(None)] * 8
                    gi[axis] = o + 1
                    out[tuple(oi)] += w * G[tuple(gi)]
        G = out
    return G


def level_weight_matrix(G) -> np.ndarray:
    """The (243, K^3) matrix of level weights G (3,3,3,K,K,K,3,3) as the
    im2col matmul takes it: rows (O-major, i, j), columns (sx, sy, sz)."""
    K = G.shape[3]
    return G.transpose(0, 1, 2, 6, 7, 3, 4, 5).reshape(27 * 9, K ** 3)


def _weight_matrix(G, dtype, device):
    """G as a weight matrix on `device` in `dtype`: numpy level weights
    (3,3,3,K,K,K,3,3), or a matrix from `level_weight_matrix` already made
    into a tensor (the multigrid hierarchy keeps those on the device)."""
    if isinstance(G, torch.Tensor):
        return G.to(device=device, dtype=dtype)
    return torch.as_tensor(level_weight_matrix(G), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Stencil tensors
# --------------------------------------------------------------------------

def assemble_node_stencil(scale, ke):
    """Element modulus field (nx, ny, nz) -> node stencil
    (3, 3, 3, 3, 3, nnx, nny, nnz).  Offsets pointing outside the grid get
    exactly-zero coefficients (the zero-padded scale kills them).

    The multigrid path does not call it (its level-0 operator is the element
    matvec): it is the tests' assembly reference for the stencil functions."""
    if isinstance(ke, torch.Tensor):
        ke = ke.double().cpu().numpy()
    KE = ke_corner_blocks(ke)
    nx, ny, nz = scale.shape
    sp = F.pad(scale, (1, 1, 1, 1, 1, 1))
    rows = []
    for o in _OFFS3:
        acc = None
        for a, b in _valid_corner_pairs(o):
            blk = torch.tensor(KE[_CORNER_INDEX[a], _CORNER_INDEX[b]],
                               dtype=scale.dtype, device=scale.device)
            sl = sp[1 - a[0]: 2 - a[0] + nx,
                    1 - a[1]: 2 - a[1] + ny,
                    1 - a[2]: 2 - a[2] + nz]
            term = blk[:, :, None, None, None] * sl[None, None]
            acc = term if acc is None else acc + term
        rows.append(acc)
    C = torch.stack(rows)
    return C.reshape(3, 3, 3, *C.shape[1:])


def _shifted(fp):
    """The 27 shifted views of a once-padded leading-batched field
    fp = pad(f) (B, nnx+2, nny+2, nnz+2) as one strided view (no copy),
    (3, 3, 3, B, nnx, nny, nnz) = [ox+1, oy+1, oz+1, b, n] of f_b(n + o)."""
    V = fp.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1)  # [b, n, o]
    return V.permute(4, 5, 6, 0, 1, 2, 3)


def fold_bc_into_stencil(C, free_mask):
    """Fold homogeneous Dirichlet masking into the stencil:

        C_o(n)[i, j] *= m(n)[i] * m(n+o)[j];   C_0(n)[i, i] += 1 - m(n)[i]

    so `apply_stencil(C, u)` is the masked SPD operator M K M + (I - M)."""
    m = torch.movedim(free_mask, -1, 0)                 # (3, nnx, nny, nnz)
    shifted = _shifted(F.pad(m, (1, 1, 1, 1, 1, 1)))    # [o..., j, n]
    C = C * m[None, None, None, :, None] * shifted[:, :, :, None]
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    C[1, 1, 1] += eye[:, :, None, None, None] * (1.0 - m)[:, None]  # C is new
    return C


def apply_stencil(C, u):
    """(K u)(n) = sum_o C_o(n) @ u(n + o); u is (nnx, nny, nnz, 3).

    The reference writes 243 separate multiply-adds, which XLA fuses into
    one pass; eager PyTorch would launch each.  Here the 27 shifted views of
    the padded field are one strided view of it (`unfold` along the three
    axes, no copy), multiplied against the coefficient tensor in one product
    and summed over the offset and column axes: a handful of launches and
    Python ops per apply.  The product is a transient of the size of C."""
    return apply_stencil_padded(
        C, F.pad(torch.movedim(u, -1, 0), (1, 1, 1, 1, 1, 1)))


def apply_stencil_padded(C, up):
    """`apply_stencil` on a field already given with its one-node border:
    up is (3, nnx+2, nny+2, nnz+2), component first, zero where the border
    lies outside the grid.  A shard passes its block with the halo received
    from its neighbours (parallel/halo.py)."""
    V = _shifted(up)[:, :, :, None]                     # [o..., 1, j, n]
    out = (C * V).sum(dim=(0, 1, 2, 4))                 # [i, n]
    return torch.movedim(out, 0, -1).contiguous()


def stencil_diagonal(C):
    """diag of the operator as a node field (nnx, nny, nnz, 3)."""
    return torch.stack([C[1, 1, 1, i, i] for i in range(3)], dim=-1)


def stencil_row_abs_sums(C):
    """sum_j |K_ij| per row as a node field (Gershgorin data)."""
    return torch.movedim(C.abs().sum(dim=(0, 1, 2, 4)), 0, -1)


def coarsen_stencil_axis(C, axis: int):
    """1-D Galerkin coarsening along one spatial axis.  The trilinear P
    factors per axis, so RAP factors into three 1-D RAPs; along one axis
    with fine offsets o, coarse offsets O and fine positions 2N + d:

        C'[O](N) = sum_{d, o : |d + o - 2O| <= 1} p1(d) p1(d+o-2O) C[o](2N+d)

    The fine node count along `axis` must be odd."""
    sdim = 5 + axis
    nf = C.shape[sdim]
    if nf % 2 != 1:
        raise ValueError(f"fine node count {nf} along axis {axis} must be odd")
    nc = (nf - 1) // 2 + 1
    Cm = torch.movedim(C, sdim, 0)
    zero = Cm.new_zeros((1, *Cm.shape[1:]))
    Cm = torch.cat([zero, Cm, zero])
    odim = 1 + axis        # the `axis` offset dim, shifted by the movedim
    targets = []
    for O in _OFF:
        acc = None
        for d in _OFF:
            for o in _OFF:
                t = d + o - 2 * O
                if abs(t) > 1:
                    continue
                w = _p1(d) * _p1(t)
                piece = Cm.select(odim, o + 1)[d + 1: d + 2 * nc: 2]
                term = w * piece
                acc = term if acc is None else acc + term
        # spatial axis back home; one offset dim was dropped above
        targets.append(torch.movedim(acc, 0, sdim - 1))
    return torch.stack(targets, dim=axis)


def coarsen_stencil(C):
    """Full factor-2 Galerkin coarsening: RAP along all three axes."""
    for axis in range(3):
        C = coarsen_stencil_axis(C, axis)
    return C


def _im2col(scale, level):
    """(K^3, n_coarse_nodes) stride-2^level windows of size K = 2^(level+1)
    of the zero-padded fine scale, built by per-axis grouped reshape and a
    two-shift concatenation (not K^3 slices); returns it with the coarse
    node counts."""
    stride = 1 << level
    K = 2 * stride
    nx, ny, nz = scale.shape
    if any(n % stride for n in (nx, ny, nz)):
        raise ValueError(f"fine element counts {tuple(scale.shape)} must "
                         f"divide the level-{level} stride {stride}")
    ncn = (nx // stride + 1, ny // stride + 1, nz // stride + 1)
    sp = F.pad(scale, (stride,) * 6)   # (nx + 2*stride, ...) = stride*(ncn+1)
    X = sp.reshape(ncn[0] + 1, stride, ncn[1] + 1, stride, ncn[2] + 1, stride)
    X = torch.cat([X[:-1], X[1:]], dim=1)                 # (ncnx, K, ...)
    X = torch.cat([X[:, :, :-1], X[:, :, 1:]], dim=3)
    X = torch.cat([X[:, :, :, :, :-1], X[:, :, :, :, 1:]], dim=5)
    S = X.permute(1, 3, 5, 0, 2, 4).reshape(K ** 3, *ncn)
    return S, ncn


def level_stencil_from_scale(scale, G, level, out_dtype=None, x_chunks=1):
    """Fine element moduli (nx, ny, nz) -> level-`level` Galerkin stencil
    (3, 3, 3, 3, 3, ncx+1, ncy+1, ncz+1): one stride-2^level im2col and one
    (243, K^3) @ (K^3, n_coarse_nodes) matmul, which lands directly in the
    coefficient-major storage layout.

    G: level weights (`level1_weights` composed level-1 times) or their
    matrix as a tensor.  out_dtype / x_chunks bound the transient of
    narrow-storage hierarchies: the matmul runs at the scale dtype and each
    of x_chunks x-slabs is cast to out_dtype as it is produced.  Defaults
    give the single full-precision matmul."""
    S, ncn = _im2col(scale, level)
    Gm = _weight_matrix(G, scale.dtype, scale.device)
    if x_chunks <= 1:
        out = Gm @ S.reshape(S.shape[0], -1)             # (243, n_nodes)
        if out_dtype is not None:
            out = out.to(out_dtype)
        return out.reshape(3, 3, 3, 3, 3, *ncn)
    slab = -(-ncn[0] // x_chunks)
    outs = []
    for s in range(0, ncn[0], slab):
        o = Gm @ S[:, s:s + slab].reshape(S.shape[0], -1)
        outs.append(o if out_dtype is None else o.to(out_dtype))
    return torch.cat(outs, dim=1).reshape(3, 3, 3, 3, 3, *ncn)


def level1_stencil_from_scale(scale, G):
    """The level-1 Galerkin stencil (G = `level1_weights(ke)`): the
    reference's name for `level_stencil_from_scale(scale, G, 1)`."""
    return level_stencil_from_scale(scale, G, 1)


_DIAG_ROWS = [((1 * 3 + 1) * 3 + 1) * 9 + i * 3 + i for i in range(3)]


def level_stencil_diag_from_scale(scale, G, level):
    """Full-precision operator diagonal of the level-`level` Galerkin
    stencil as a node field (ncnx, ncny, ncnz, 3), from the three diagonal
    rows of the same im2col matmul, without the full coefficient tensor.
    Used by narrow-storage hierarchies, whose smoother data keeps full
    precision."""
    S, ncn = _im2col(scale, level)
    Gm = _weight_matrix(G, scale.dtype, scale.device)[_DIAG_ROWS]
    out = Gm @ S.reshape(S.shape[0], -1)                 # (3, N)
    return torch.movedim(out.reshape(3, *ncn), 0, -1)


def dense_index(shape3):
    """Index pair (src, dst) for `stencil_to_dense` on a (nnx, nny, nnz)
    node grid, as numpy int64: entry k of the dense (3n, 3n) matrix, flat
    index dst[k] = (3*row + i)*3n + 3*col + j, is the stencil coefficient at
    flat index src[k] of C (offset, i, j, row node).  Every dst occurs once.
    Nodes flatten in C order (iz fastest), dof = 3*node + component."""
    nnx, nny, nnz = shape3
    n = nnx * nny * nnz
    ids = np.arange(n).reshape(nnx, nny, nnz)
    src, dst = [], []
    for oi, (ox, oy, oz) in enumerate(_OFFS3):
        rx = slice(max(0, -ox), nnx - max(0, ox))
        ry = slice(max(0, -oy), nny - max(0, oy))
        rz = slice(max(0, -oz), nnz - max(0, oz))
        cx = slice(max(0, ox), nnx - max(0, -ox))
        cy = slice(max(0, oy), nny - max(0, -oy))
        cz = slice(max(0, oz), nnz - max(0, -oz))
        rows = ids[rx, ry, rz].reshape(-1)
        cols = ids[cx, cy, cz].reshape(-1)
        for i in range(3):
            for j in range(3):
                dst.append((3 * rows + i) * (3 * n) + (3 * cols + j))
                src.append(((oi * 3 + i) * 3 + j) * n + rows)
    return np.concatenate(src), np.concatenate(dst)


def stencil_to_dense(C, index=None):
    """Stencil -> dense (3n, 3n) matrix (for the multigrid coarsest-level
    Cholesky, a few thousand dofs): one gather from C and one
    non-accumulating scatter, which is deterministic on CUDA because every
    destination occurs once.  index: `dense_index(C.shape[5:])` as tensors
    on C's device, computed here when not given."""
    shape3 = tuple(C.shape[5:8])
    n = shape3[0] * shape3[1] * shape3[2]
    if index is None:
        index = tuple(torch.as_tensor(a, device=C.device)
                      for a in dense_index(shape3))
    src, dst = index
    K = C.new_zeros(9 * n * n)
    K[dst] = C.reshape(-1)[src]
    return K.reshape(3 * n, 3 * n)
