"""Matrix-free preconditioned conjugate gradients, with subspace recycling.

Port of easysimp_tpu/ops/cg.py.  The loop runs in Python and checks the
residual norm on the host once per iteration; the stopping rule and the
order of updates are the reference's, so the iteration count is too.

The fields may be tensors or sharded fields (parallel/sharding.py): the
inner products go through `_vdot` and the deflation's Gram products through
`_gram`, which take a sharded field's own global reductions (per-shard
partials added in shard order); every other operation is elementwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["CGResult", "cg_solve", "recycle_init", "recycle_push",
           "recycle_deflate"]


def recycle_init(k, u, dtype=None):
    """(k, *u.shape) ring buffer seeded with the current warm start in
    slot 0, zeros elsewhere (rank deficiency is handled by the ridge in
    `cg_solve`).  dtype: optional narrow storage dtype for the ring."""
    dtype = dtype or u.dtype
    zero = torch.zeros_like(u, dtype=dtype)
    return torch.stack([u.to(dtype)] + [zero] * (k - 1))


def recycle_push(H, u_new):
    """Shift the ring: newest solution first, oldest dropped."""
    return torch.cat([u_new.to(H.dtype)[None], H[:-1]])


def recycle_deflate(free_mask, recycle):
    """Deflation basis: deltas of recent solutions against the newest one
    (the warm start), masked, in the mask's dtype."""
    if recycle is None:
        return None
    dt = free_mask.dtype
    return (recycle[1:].to(dt) - recycle[:1].to(dt)) * free_mask


class CGResult(NamedTuple):
    u: torch.Tensor            # solution
    iterations: int
    residual_norm: float
    u_dot_r: torch.Tensor      # <u, r> at exit: 0.5 u^T K u = 0.5 (u.f - u.r)


def _vdot(a, b):
    """<a, b> over the whole field (a sharded field's global dot)."""
    if isinstance(a, torch.Tensor):
        return torch.dot(a.reshape(-1), b.reshape(-1))
    return a.vdot(b)


def _gram(W, V):
    """(m, n) matrix of <W_i, V_j> for stacked fields W (m, ...) and
    V (n, ...); a sharded field adds its per-shard products in shard
    order."""
    m, n = W.shape[0], V.shape[0]
    if isinstance(W, torch.Tensor):
        return W.reshape(m, -1) @ V.reshape(n, -1).T
    return W.gram(V)


def cg_solve(A: Callable, b, x0=None, M: Callable | None = None,
             rtol: float = 1e-10, atol: float = 0.0, maxiter: int = 10000,
             deflate=None) -> CGResult:
    """Solve A x = b with preconditioned CG.

    Args:
      A: SPD linear operator on tensors shaped like b (BC masking included).
      b: right-hand side (masked).
      x0: warm start (masked); zeros if None.
      M: preconditioner applying M^{-1} r; identity if None.
      rtol/atol: stop when ||r|| <= max(rtol*||b||, atol).
      maxiter: iteration cap.
      deflate: optional (m, *b.shape) recycling basis.  The warm-start
        residual is Galerkin-projected over span(deflate) first:
        (W^T A W) y = W^T r0, x0 += W y, r0 -= (A W) y, with a relative
        ridge for rank-deficient W, and kept only if it shrank ||r0||.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r

    bnorm = torch.sqrt(_vdot(b, b))
    tol = torch.clamp(rtol * bnorm, min=atol)

    r0 = b - A(x0)
    if deflate is not None and deflate.shape[0] > 0:
        m = deflate.shape[0]
        AW = torch.stack([A(deflate[i]) for i in range(m)])
        G = _gram(deflate, AW)
        g = _gram(deflate, r0[None])[:, 0]
        eps = 10.0 * torch.finfo(G.dtype).eps \
            * torch.diagonal(G).abs().max() + 1e-30
        eye = torch.eye(m, dtype=G.dtype, device=G.device)
        y = torch.linalg.solve(G + eps * eye, g)
        x0_p = x0 + torch.tensordot(y, deflate, dims=1)
        r0_p = r0 - torch.tensordot(y, AW, dims=1)
        better = _vdot(r0_p, r0_p) < _vdot(r0, r0)
        x0 = torch.where(better, x0_p, x0)
        r0 = torch.where(better, r0_p, r0)

    x, r = x0, r0
    z = M(r)
    p = z
    rz = _vdot(r, z)
    zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
    k = 0
    while k < maxiter and bool(torch.sqrt(_vdot(r, r)) > tol):
        Ap = A(p)
        pAp = _vdot(p, Ap)
        alpha = torch.where(pAp > 0, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _vdot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(u=x, iterations=k,
                    residual_norm=float(torch.sqrt(_vdot(r, r))),
                    u_dot_r=_vdot(x, r))
