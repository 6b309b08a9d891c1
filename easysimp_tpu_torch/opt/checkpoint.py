"""Optimization checkpoint/resume.

The port's own copy of easysimp_tpu/opt/checkpoint.py, numpy only, writing
and reading the SAME `.npz` format (version 1): a checkpoint written by
either package resumes in the other.  The full optimizer state — DESIGN-space
densities, warm-start displacement field, iteration counter, histories, the
tolerance-checkpoint flags, the multigrid's power vectors and the recycle
ring — round-trips through a single file, so long runs survive preemption.
EasySIMP.jl can only export intermediate VTUs
(src/Optimization/Optimization.jl:448-477).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.terminal import print_info, print_success

__all__ = ["save_checkpoint", "load_checkpoint", "restore_triggered"]

_FORMAT_VERSION = 1


def save_checkpoint(path, *, design, u, iteration, energy_history,
                    volume_history, change_history, cg_history,
                    checkpoint_triggered, converged=False, pvecs=(),
                    recycle=None) -> str:
    """Write optimizer state; arrays (numpy, on the host) are stored in
    float64.

    pvecs: the multigrid lambda_max power-iteration state (per-level node
    fields) — persisted so a resumed run reproduces the uninterrupted
    trajectory exactly (the warm smoother estimates differ from a cold
    re-initialization at the CG-tolerance level).

    recycle: the subspace-recycling solution ring buffer (cg_recycle_k) —
    persisted for the same reason: a zeroed buffer on resume would change
    warm starts (still within cg_rtol, but no longer bit-reproducing)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    pvec_arrays = {f"pvec_{i}": np.asarray(v, dtype=np.float64)
                   for i, v in enumerate(pvecs)}
    if recycle is not None:
        pvec_arrays["recycle"] = np.asarray(recycle, dtype=np.float64)
    # Atomic update: write a sibling temp file and os.replace() it over the
    # target, so a preemption mid-write (the exact scenario checkpointing
    # exists for) can never truncate the only saved state.  The temp name
    # keeps the .npz suffix (np.savez would append one otherwise).
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        format_version=_FORMAT_VERSION,
        design=np.asarray(design, dtype=np.float64),
        u=np.asarray(u, dtype=np.float64),
        iteration=int(iteration),
        energy_history=np.asarray(energy_history, dtype=np.float64),
        volume_history=np.asarray(volume_history, dtype=np.float64),
        change_history=np.asarray(change_history, dtype=np.float64),
        cg_history=np.asarray(cg_history, dtype=np.int64),
        checkpoint_triggered=np.asarray(checkpoint_triggered, dtype=bool),
        converged=bool(converged),
        **pvec_arrays,
    )
    os.replace(tmp, path)
    print_success(f"Checkpoint saved: {path} (iteration {iteration})")
    return path


def load_checkpoint(path) -> dict:
    """Load optimizer state saved by `save_checkpoint`."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        state = {
            "design": z["design"],
            "u": z["u"],
            "iteration": int(z["iteration"]),
            "energy_history": z["energy_history"].tolist(),
            "volume_history": z["volume_history"].tolist(),
            "change_history": z["change_history"].tolist(),
            "cg_history": [int(v) for v in z["cg_history"]],
            "checkpoint_triggered": z["checkpoint_triggered"].tolist(),
            "converged": bool(z["converged"]),
        }
        pvecs = []
        for i in range(len(z.files)):
            key = f"pvec_{i}"
            if key not in z.files:
                break
            pvecs.append(z[key])
        state["pvecs"] = pvecs
        state["recycle"] = z["recycle"] if "recycle" in z.files else None
    print_info(f"Checkpoint loaded: {path} (iteration {state['iteration']})")
    return state


def restore_triggered(saved, tolerance_checkpoints) -> list[bool]:
    """Validate + restore the tolerance-checkpoint flags on resume.

    The flags are positional (flag[i] belongs to tolerance_checkpoints[i]);
    resuming with a different checkpoint list would silently map flags to the
    wrong thresholds, so a length mismatch is an error.
    """
    saved = list(saved)
    if not saved:
        return [False] * len(tolerance_checkpoints)
    if len(saved) != len(tolerance_checkpoints):
        raise ValueError(
            f"checkpoint was saved with {len(saved)} tolerance checkpoints "
            f"but params.tolerance_checkpoints has "
            f"{len(tolerance_checkpoints)}; the flags are positional — "
            f"resume with the same tolerance_checkpoints list"
        )
    return [bool(v) for v in saved]
