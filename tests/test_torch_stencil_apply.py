"""The masked stencil apply `stencil_apply` (ops/cuda_kernels.py), the
multigrid's M C (M x) and r - M C (M x).

On the CPU the wrapper is its plain version, which must be the former
composition of `MultigridPreconditioner._masked_stencil_apply` bit for bit
(copied here as `_former`), and which must be the masked operator that the
stencil's dense matrix states.  The kernel runs only on the card: the test
marked `cuda` holds it against its plain version there and skips here.
This file imports no JAX, so it can run on the card.
"""

import numpy as np
import pytest
import torch

from easysimp_tpu_torch import tracing
from easysimp_tpu_torch.ops import cuda_kernels as ck
from easysimp_tpu_torch.ops import stencil as ts

# node grids: odd, an axis of 2 nodes, an axis of 1 node
SHAPES = [(3, 5, 7), (2, 9, 4), (5, 2, 3), (4, 1, 3)]
# (stencil dtype, field dtype): one dtype, and the mg_stencil_dtype cases
DTYPES = [(torch.float64, torch.float64), (torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float64), (torch.bfloat16, torch.float64)]


def _former(C, mask, v, r=None):
    """The masked apply as `_masked_stencil_apply` wrote it before the
    kernel, and the cycle's residual `r - _apply_level(...)` around it."""
    if C.dtype != v.dtype:
        mv = (mask * v).to(C.dtype)
        y = mask * ts.apply_stencil(C, mv).to(v.dtype)
    else:
        y = mask * ts.apply_stencil(C, mask * v)
    return y if r is None else r - y


def _inputs(nodes, stencil_dtype, field_dtype, seed=0, device="cpu"):
    """(C, mask, x, r): a random stencil and fields from `seed` (numpy),
    the mask with fixed dofs on the boundary (the x=0 plane, one sliding
    edge) and a few inside."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((3, 3, 3, 3, 3, *nodes))
    mask = (rng.uniform(size=(*nodes, 3)) > 0.1).astype(np.float64)
    mask[0] = 0.0
    mask[-1, 0, :, 1] = 0.0
    x = rng.standard_normal((*nodes, 3))
    r = rng.standard_normal((*nodes, 3))
    f = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa
    return (f(C, stencil_dtype), f(mask, field_dtype), f(x, field_dtype),
            f(r, field_dtype))


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("dtypes", DTYPES,
                         ids=lambda d: f"{str(d[0])[6:]}-{str(d[1])[6:]}")
@pytest.mark.parametrize("nodes", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stencil_apply_on_cpu_is_the_former_composition(nodes, dtypes,
                                                        residual):
    """On CPU tensors the wrapper is the former composition bitwise, in
    the field's dtype and shape; no launch is counted."""
    C, mask, x, r = _inputs(nodes, *dtypes)
    r = r if residual else None
    before = tracing.counters()
    out = ck.stencil_apply(C, mask, x, r)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out, _former(C, mask, x, r))
    assert torch.equal(out, ck.stencil_apply_plain(C, mask, x, r))
    assert tracing.counters() == before


@pytest.mark.parametrize("nodes", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stencil_apply_is_the_masked_operator(nodes):
    """float64: out = m * (K (m x)) and r - out, with K the dense matrix of
    the stencil (`stencil_to_dense`; no coupling leaves the grid)."""
    C, mask, x, r = _inputs(nodes, torch.float64, torch.float64, seed=1)
    K = ts.stencil_to_dense(C)
    m = mask.reshape(-1)
    want = (m * (K @ (m * x.reshape(-1)))).reshape(x.shape)
    tol = 1e-12 * float(want.abs().max())
    assert float((ck.stencil_apply(C, mask, x) - want).abs().max()) <= tol
    assert float((ck.stencil_apply(C, mask, x, r) - (r - want)).abs().max()) \
        <= tol


@pytest.mark.parametrize("case, error", [
    ("C_shape", ValueError), ("C_nodes", ValueError), ("x_shape", ValueError),
    ("mask_shape", ValueError), ("mask_dtype", TypeError),
    ("r_dtype", TypeError), ("C_storage", TypeError),
    ("x_storage", TypeError), ("C_strided", ValueError),
    ("x_strided", ValueError), ("mask_strided", ValueError),
    ("r_strided", ValueError), ("device", ValueError),
    ("mixed_devices", ValueError)])
def test_stencil_apply_rejects_bad_arguments(case, error):
    """A wrong shape, dtype, layout or device raises before any work."""
    C, mask, x, r = _inputs((3, 5, 7), torch.float32, torch.float32)
    args = {"C": C, "mask": mask, "x": x, "r": r}
    swapped = lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)  # noqa
    big = _inputs((4, 5, 7), torch.float32, torch.float32)
    args.update({
        "C_shape": {"C": C.reshape(27, 9, 3, 5, 7)},
        "C_nodes": {"C": big[0]},
        "x_shape": {"x": x[..., :2].contiguous()},
        "mask_shape": {"mask": big[1]},
        "mask_dtype": {"mask": mask.double()},
        "r_dtype": {"r": r.bfloat16()},
        "C_storage": {"C": C.half()},
        "x_storage": {k: args[k].half() for k in ("mask", "x", "r")},
        "C_strided": {"C": swapped(C)},
        "x_strided": {"x": swapped(x)},
        "mask_strided": {"mask": swapped(mask)},
        "r_strided": {"r": swapped(r)},
        "device": {k: v.to("meta") for k, v in args.items()},
        "mixed_devices": {"mask": mask.to("meta")},
    }[case])
    with pytest.raises(error):
        ck.stencil_apply(**args)


@pytest.mark.cuda
def test_stencil_apply_kernel_matches_plain_on_the_card():
    """The kernel against its plain version on the card, plain and residual
    forms, every dtype pair: float64 1e-12, float32 1e-5, bfloat16 2e-2 of
    max|out| (by the stencil's dtype); two launches bitwise equal; one
    launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    tol = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2e-2}
    for nodes in SHAPES + [(17, 9, 33)]:
        for sd, fd in DTYPES:
            C, mask, x, r = _inputs(nodes, sd, fd, device="cuda")
            for rr in (None, r):
                n0 = ck.launches("stencil_apply", sd)
                got = ck.stencil_apply(C, mask, x, rr)
                again = ck.stencil_apply(C, mask, x, rr)
                assert ck.launches("stencil_apply", sd) == n0 + 2
                want = ck.stencil_apply_plain(C, mask, x, rr)
                err = float((got.double() - want.double()).abs().max())
                assert err <= tol[sd] * float(want.double().abs().max()), \
                    (nodes, sd, fd, rr is None, err)
                assert torch.equal(got, again)
