"""Numeric configuration: the dtype policy and the TF32 pins.

Every entry point takes a `dtype`.  `"auto"` resolves to float64 on the CPU
(parity runs against the direct-solver reference hold compliance to rtol
1e-6) and float32 on a CUDA device (production runs).  Tests and the chip
smoke pass `dtype` explicitly.

TF32 is off.  The JAX reference pins `precision=HIGHEST` on the filter
convolution (easysimp_tpu/ops/filters.py:136) and on the element matmul
(easysimp_tpu/ops/operator.py:123).  cuDNN runs a float32 `conv3d` in TF32 by
default, which keeps about three decimal digits and breaks the filter's
exact-parity semantics; the float32 matmul default is already full precision,
and is pinned here so that nothing else can switch it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_dtype", "DTYPES"]

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_dtype(dtype, device) -> torch.dtype:
    """Map a dtype name (or torch dtype) to a torch dtype.

    "auto" is float64 on the CPU and float32 on a CUDA device."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "auto":
        return torch.float32 if torch.device(device).type == "cuda" \
            else torch.float64
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; expected 'auto' or one "
                         f"of {sorted(DTYPES)}")
    return DTYPES[dtype]
