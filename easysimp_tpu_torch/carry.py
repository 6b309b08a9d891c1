"""Moving the reference package's inputs into the port.

The system has no trained weights: its state is the design, the
displacement field and the parameters.  These helpers carry that state from
`easysimp_tpu` (or from numpy) into the port without importing jax, so the
tests can feed one state to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import resolve_dtype
from .params import OptimizationParameters

__all__ = ["params_from_reference", "fields_from_numpy"]


def params_from_reference(obj) -> OptimizationParameters:
    """Copy an `easysimp_tpu.OptimizationParameters` field by field, by
    attribute (the reference object is never imported, only read)."""
    kw = {}
    for f in dataclasses.fields(OptimizationParameters):
        if not hasattr(obj, f.name):
            raise AttributeError(f"reference parameters lack field {f.name!r}")
        value = getattr(obj, f.name)
        kw[f.name] = list(value) if isinstance(value, list) else value
    return OptimizationParameters(**kw)


def fields_from_numpy(design, u, *, dtype, device="cuda"):
    """(design (nx, ny, nz), u (nx+1, ny+1, nz+1, 3)) numpy arrays in the JAX
    layouts -> tensors of `dtype` on `device`."""
    design = np.asarray(design)
    u = np.asarray(u)
    if design.ndim != 3:
        raise ValueError(f"design must be (nx, ny, nz), got {design.shape}")
    if u.shape != (*(n + 1 for n in design.shape), 3):
        raise ValueError(f"u must be (nx+1, ny+1, nz+1, 3) for design "
                         f"{design.shape}, got {u.shape}")
    dt = resolve_dtype(dtype, device)
    return (torch.as_tensor(design, dtype=dt, device=device),
            torch.as_tensor(u, dtype=dt, device=device))
