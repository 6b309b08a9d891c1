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

__all__ = ["params_from_reference", "mesh_from_reference",
           "fields_from_numpy", "power_vectors_from_numpy"]


def params_from_reference(obj, material_model=None) -> OptimizationParameters:
    """Copy an `easysimp_tpu.OptimizationParameters` field by field, by
    attribute (the reference object is never imported, only read).

    A reference `material_model` is a closure on jax arrays and cannot be
    translated: give the same law as a closure on tensors in
    `material_model`, which takes its place; without one a reference object
    that has a material model is refused."""
    kw = {}
    for f in dataclasses.fields(OptimizationParameters):
        if not hasattr(obj, f.name):
            raise AttributeError(f"reference parameters lack field {f.name!r}")
        value = getattr(obj, f.name)
        kw[f.name] = list(value) if isinstance(value, list) else value
    if kw["material_model"] is not None and material_model is None:
        raise ValueError(
            "the reference parameters carry a material_model, a closure on "
            "jax arrays that cannot be translated; pass the same law on "
            "torch tensors as material_model=")
    kw["material_model"] = material_model
    return OptimizationParameters(**kw)


def mesh_from_reference(obj):
    """The port's `UnstructuredMesh` from an `easysimp_tpu` mesh, read by
    attribute (`node_coords`, `connectivity`, `cell_type`, `cellsets`); the
    reference class is never imported.  The arrays are copied."""
    from .mesh import UnstructuredMesh

    return UnstructuredMesh(
        node_coords=np.array(obj.node_coords, dtype=np.float64),
        connectivity=np.array(obj.connectivity, dtype=np.int64),
        cell_type=str(obj.cell_type),
        cellsets={k: np.array(v) for k, v in dict(obj.cellsets).items()})


def fields_from_numpy(design, u, *, dtype, device="cuda"):
    """Numpy arrays in the JAX layouts -> tensors of `dtype` on `device`:
    the voxel fields (design (nx, ny, nz), u (nx+1, ny+1, nz+1, 3)) or the
    flat fields of the unstructured path (design (n_cells,), u
    (3*n_nodes,))."""
    design = np.asarray(design)
    u = np.asarray(u)
    if design.ndim == 1:
        if u.ndim != 1 or u.shape[0] % 3:
            raise ValueError(f"a flat design goes with a flat u of "
                             f"3*n_nodes entries, got {u.shape}")
    elif design.ndim != 3:
        raise ValueError(f"design must be (nx, ny, nz) or (n_cells,), got "
                         f"{design.shape}")
    elif u.shape != (*(n + 1 for n in design.shape), 3):
        raise ValueError(f"u must be (nx+1, ny+1, nz+1, 3) for design "
                         f"{design.shape}, got {u.shape}")
    dt = resolve_dtype(dtype, device)
    return (torch.as_tensor(design, dtype=dt, device=device),
            torch.as_tensor(u, dtype=dt, device=device))


def power_vectors_from_numpy(vecs, *, dtype, device="cuda"):
    """The multigrid's carried power vectors, one (nnx_l, nny_l, nnz_l, 3)
    numpy array per level (as the JAX package's `power_init` returns them),
    -> a tuple of tensors of `dtype` on `device`."""
    dt = resolve_dtype(dtype, device)
    out = []
    for lvl, v in enumerate(vecs):
        v = np.array(v)        # a copy: JAX's arrays are read-only
        if v.ndim != 4 or v.shape[-1] != 3:
            raise ValueError(f"power vector {lvl} must be (nnx, nny, nnz, 3), "
                             f"got {v.shape}")
        out.append(torch.as_tensor(v, dtype=dt, device=device))
    return tuple(out)
