"""Optimality Criteria update with Lagrange-multiplier bisection.

Port of easysimp_tpu/ops/oc.py.  Sigmund's OC formula with move limits and
damping, bisecting lambda in [1e-9, 1e9] until the volume constraint is met
to ABSOLUTE tolerance 1e-6 (OptimalityCriteria.jl:69-146), with the
reference package's two restructurings, which keep the reference's exact
bisection trajectory:

1. The density filter is linear, so a candidate's physical volume is
   dot(candidate, H^T V): the caller passes `volume_weights = H^T V` and no
   filter runs inside the loop.
2. Each pass evaluates the volume error at all 15 dyadic midpoints the next
   four halving steps could visit (one batched pass over the element
   fields), then replays those four steps on host scalars.  The midpoints
   are built by the same nested 0.5*(lo+hi) averaging in the working dtype,
   so the lambda sequence and the bisection count are the reference's.

The loop also stops when the interval collapses to machine precision, after
which lambda_mid cannot change.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tracing import host_read, span, spanned, sync

__all__ = ["oc_update", "sensitivity_health", "host_median_abs"]

X_MIN = 1e-3          # density lower bound (OptimalityCriteria.jl:86)
LAMBDA_LO = 1e-9      # bisection bounds (OptimalityCriteria.jl:89-90)
LAMBDA_HI = 1e9
VOLUME_TOL = 1e-6     # ABSOLUTE volume tolerance (OptimalityCriteria.jl:91)
MAX_BISECTION = 200   # (OptimalityCriteria.jl:92)

_STEPS_PER_PASS = 4   # reference halving steps emulated per pass

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _dyadic_midpoints(lo, hi, depth):
    """All lmid values the next `depth` halving steps can visit, by the same
    nested 0.5*(lo+hi) averaging the reference performs (bit-exact in lo's
    numpy dtype).  Index m-1 holds the midpoint of the dyadic sub-interval
    [a, b] with m = (a+b)/2 on the 2**depth grid."""
    n = 2 ** depth
    half_ = type(lo)(0.5)
    vals = [None] * (n + 1)
    vals[0], vals[n] = lo, hi
    span = n
    while span > 1:
        half = span // 2
        for a in range(0, n, span):
            vals[a + half] = half_ * (vals[a] + vals[a + span])
        span = half
    return np.array(vals[1:n], dtype=type(lo))


def _field_sums(x, dims):
    """Sums over the field axes `dims` (a sharded field adds its per-shard
    partial sums in shard order)."""
    if isinstance(x, torch.Tensor):
        return x.sum(dim=dims)
    return x.field_sums(dims)


@spanned("oc")
def oc_update(densities, sensitivities, volume_sensitivities,
              target_volume_fraction, total_volume, volume_weights,
              move_limit=0.2, damping=0.5):
    """One OC design update.

    Args:
      densities: current DESIGN densities (any shape).
      sensitivities: filtered objective sensitivities (same shape).
      volume_sensitivities: dV/drho in design space.
      target_volume_fraction, total_volume: the volume constraint.
      volume_weights: per-element weights w such that a candidate's PHYSICAL
        volume is dot(candidate, w) (H^T element_volumes for a linear
        filter H; total_volume * volume_sensitivities in simp_optimize).
      move_limit, damping: OC parameters.

    Returns:
      (new_design_densities, lambda_mid, bisection_iterations, volume_error)
      with the last three as Python numbers.
    """
    dtype = densities.dtype
    nd = _NP_DTYPE[dtype]
    target_volume = nd(target_volume_fraction) * nd(total_volume)
    eps = np.finfo(nd).eps
    tol = nd(VOLUME_TOL)

    # Per-element invariants hoisted out of the bisection:
    #   ratio(lam) = [rho * (|s|/v)^d] * lam^-d, clipped to
    #   [max(xmin, rho-m), min(1, rho+m)].
    q = densities * (sensitivities.abs() / volume_sensitivities) ** damping
    lo_e = torch.clamp(densities - move_limit, min=X_MIN)
    hi_e = torch.clamp(densities + move_limit, max=1.0)
    w = volume_weights
    if tuple(getattr(w, "shape", ())) != tuple(densities.shape):
        w = torch.broadcast_to(torch.as_tensor(w, dtype=dtype,
                                               device=densities.device),
                               densities.shape)
    bcast = (-1,) + (1,) * densities.dim()
    field_dims = tuple(range(1, densities.dim() + 1))

    def candidate(lam):
        return torch.clamp(q * lam ** (-damping), lo_e, hi_e)

    def volume_errors(lams):
        with sync("oc_lambdas"):        # a copy from pageable host memory
            lt = torch.as_tensor(lams, device=densities.device).view(bcast)
        cand = torch.clamp(q[None] * lt ** (-damping), lo_e[None],
                           hi_e[None])
        vol = _field_sums(cand * w[None], field_dims)
        return host_read("oc_pass", vol).numpy() - target_volume

    lo, hi = nd(LAMBDA_LO), nd(LAMBDA_HI)
    lam, verr = nd(0.0), nd(np.inf)
    it, done = 0, False
    while it == 0 or (it < MAX_BISECTION and not done
                      and (hi - lo) > eps * hi):
        lams = _dyadic_midpoints(lo, hi, _STEPS_PER_PASS)
        with span("oc.pass"):
            verrs = volume_errors(lams)
        # Replay the reference halving steps: integer bracket [a, b] on the
        # 2**depth grid, midpoint index m maps to lams[m-1] / verrs[m-1].
        a, b = 0, 2 ** _STEPS_PER_PASS
        for _ in range(_STEPS_PER_PASS):
            m = (a + b) // 2
            lam_m, verr_m = lams[m - 1], nd(verrs[m - 1])
            active = not done and it < MAX_BISECTION
            newly_done = active and abs(verr_m) < tol
            if active:
                lam, verr = lam_m, verr_m
                it += 1
            done = done or newly_done
            if active and not newly_done:
                # Too much material -> raise lambda; too little -> lower it.
                if verr_m > 0:
                    a = m
                else:
                    b = m
        ends = [lo, *lams, hi]
        lo, hi = ends[a], ends[b]
    with sync("oc_lambda"):
        lam_t = torch.as_tensor(lam, device=densities.device)
    return candidate(lam_t), float(lam), it, float(verr)


def sensitivity_health(sensitivities):
    """Device-side reductions for the reference's health check
    (OptimalityCriteria.jl:19-40): (frac_negative, mean_abs, max_abs)."""
    abs_s = sensitivities.abs()
    return ((sensitivities < 0).to(sensitivities.dtype).mean(),
            abs_s.mean(), abs_s.max())


# Cap on elements transferred to the host for the median subsample.
_MEDIAN_SUBSAMPLE = 65536


def host_median_abs(sensitivities) -> float:
    """Median of |s| from a strided subsample, computed on the host."""
    flat = sensitivities.reshape(-1)
    stride = max(1, flat.shape[0] // _MEDIAN_SUBSAMPLE)
    sub = np.abs(flat[::stride].detach().cpu().numpy())
    return float(np.median(sub))
