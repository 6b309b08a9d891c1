"""The bench's trajectory on the port: SIMP iterations per second on the
128^3 voxel cantilever.

    python -m easysimp_tpu_torch.bench [--device cuda|cpu]

Twin of the measurement parts of `bench.py` (the JAX package's harness,
which stays the reference).  It prints ONE JSON line to stdout and every
diagnostic to stderr:

  {"metric": "simp_iterations_per_sec_{nx}x{ny}x{nz}", "value": ...,
   "unit": "iters/sec", "avg_its", "avg_iters_timed",
   "avg_its_incl_prelude", "early_its", "early_cg", "late_its", "late_cg",
   "late_start_iter", "compile_s", "continuation", "prelude_iters",
   "prelude_s", "config", "hardware", "device"}

The trajectory is `bench.py`'s: a continuation prelude of
BENCH_PRELUDE_ITERS (40) iterations of the same cantilever at half
resolution, the design prolonged by 2x repetition and the displacements
trilinearly onto the fine grid, the prelude's last CG tolerance carried
over; then the first fine iteration (untimed; its seconds are `compile_s`,
which here is the first fine step: no compiler runs, but the first setup
on the fine grid and the first kernel launches on its shapes fall in it),
an early window of BENCH_ITERS (10) iterations, timed advance chunks of at
most 8 up to BENCH_LATE_START (50) and a late window of BENCH_ITERS.
`value` is the full-trajectory average over every timed fine iteration.
On a CUDA device each timed iteration is bracketed by
`torch.cuda.synchronize()`.  A non-finite energy exits with code 3.

Differences from `bench.py`'s line: no `vs_baseline` (its 5 it/s is a
target set for a TPU), no `provisional` and no `attempts` (the port runs
the measurement once, in this process, with no retry); added `hardware`
(the card's `nvidia-smi` name and power limit, or "cpu") and `device`.

The iteration is the port's `VoxelStep` (`setup(design, pvecs,
prev_state)` and `step(...)`), driven by the host schedule that
`simp_optimize` runs (opt/schedule.py `Stepper`, here `_Stepper`): a
preconditioner setup every BENCH_SETUP_EVERY iterations, in full every
BENCH_FULL_SETUP_EVERY and light in between, the CG watchdog, an 8-slot
recycle ring and the adaptive CG tolerance clip(0.05 change, cg_rtol,
cg_rtol_max).

Other modes (opt-in, as in `bench.py`):
  BENCH_UNSTRUCTURED=N|gripper  it/s of the unstructured iteration on a
      `tet_mesh_from_grid` of N^3 (6 tets per voxel), or on the gripper
      mesh `stul14.vtu` from the directory EASYSIMP_REFERENCE_DATA;
  BENCH_SHARDED=N  one SIMP step over an N-shard mesh (BENCH_NELS, default
      64,64,64): the port's own counts of halo copies
      (`parallel/halo.py` `extend.copies`) and global reductions
      (`ShardedField.reductions`) in that step.  These are the port's
      counts of its explicit exchanges and joins, not XLA's HLO counts of
      collectives.  The shards sit on the visible cards round-robin, or on
      the CPU with --device cpu;
  BENCH_PHASES=1  after the JSON line, the ms of the iteration's parts at
      the final design (CUDA events around CUDA-graph replays where a part
      has no host synchronisation, around eager calls where it has; wall
      time on the CPU).

Knobs, with `bench.py`'s defaults: BENCH_NELS (128,128,128), BENCH_DTYPE
(float32), BENCH_ITERS (10), BENCH_MG_DTYPE (bfloat16), BENCH_MG_SMOOTH
((1, 2)), BENCH_STENCIL_DTYPE (""), BENCH_RECYCLE_K (8),
BENCH_RECYCLE_DTYPE (""), BENCH_FORCING (adaptive), BENCH_RTOL_MAX (1e-3;
also the unstructured mode's loosest tolerance), BENCH_CONTINUATION (1),
BENCH_PRELUDE_ITERS (40), BENCH_REFRESH_ITERS (2), BENCH_GALERKIN (1),
BENCH_MG_CYCLE (v), BENCH_SETUP_EVERY (1), BENCH_FULL_SETUP_EVERY (4),
BENCH_LATE_START (50; 30 unstructured), BENCH_SKIP_LATE (0),
BENCH_HEADLINE (avg | late | early), BENCH_PHASES (0), BENCH_UNSTRUCTURED,
BENCH_SA (0), BENCH_AMG_COARSE (6000), BENCH_SHARDED.

Not carried over from `bench.py`, because they work around faults of the
TPU and its remote compiler: the parent/child retry loop, the fallback to
the unfused matvec, the SIGTERM bank, the mid-run `.npz` sidecars, the
compile cache, the split programs and the `block_until_ready` drains.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from easysimp_tpu_torch.opt.schedule import Stepper, forcing_rtol

__all__ = ["run_measurement", "run_unstructured", "run_sharded_evidence",
           "phase_breakdown", "Measurement"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _nels(default):
    return tuple(int(v) for v in
                 os.environ.get("BENCH_NELS", default).split(","))


def _sync(device):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def hardware(device) -> str:
    """The card's `nvidia-smi` name and power limit, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return (f"{torch.cuda.get_device_name(index)}, power limit not "
                f"read (nvidia-smi failed)")


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    return device


# --------------------------------------------------------------------------
# The voxel cantilever and its iteration
# --------------------------------------------------------------------------

def _cantilever(nels):
    """(grid, loads, bcs) of the bench cantilever (bench.py:536-542)."""
    import easysimp_tpu_torch as pt

    nx, ny, nz = nels
    grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(float(n) for n in nels))
    bc = pt.apply_fixed_boundary(
        grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    load = pt.PointLoad(
        pt.select_nodes_by_box(grid, [nx, 0, 0], [nx, 0, nz]),
        [0.0, -1.0, 0.0])
    return grid, [load], [bc]


def _build_problem(nels, dtype, device="cuda"):
    """(grid, VoxelStep, params) of the bench cantilever at grid size
    `nels` on `device`: one problem family parameterised by resolution, so
    the continuation prelude and the measured grid are the same physics
    (bench.py:523-562; solver knobs from the BENCH_* environment)."""
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.opt.optimize import build_voxel_step

    grid, loads, bcs = _cantilever(nels)
    params = pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype=dtype, cg_rtol=1e-5, cg_maxiter=500,
        preconditioner="multigrid",
        mg_cycle_dtype=os.environ.get("BENCH_MG_DTYPE", "bfloat16"),
        mg_stencil_dtype=os.environ.get("BENCH_STENCIL_DTYPE", ""),
        mg_refresh_iters=int(os.environ.get("BENCH_REFRESH_ITERS", "2")),
        mg_galerkin=os.environ.get("BENCH_GALERKIN", "1") == "1",
        mg_cycle=os.environ.get("BENCH_MG_CYCLE", "v"),
        cg_rtol_max=float(os.environ.get("BENCH_RTOL_MAX", "1e-3")),
        mg_smooth_iters=ast.literal_eval(
            os.environ.get("BENCH_MG_SMOOTH", "(1, 2)")))
    vs = build_voxel_step(grid, loads, bcs, params, device=device)
    return grid, vs, params


class _Stepper(Stepper):
    """The port's voxel host schedule (opt/schedule.py, as `simp_optimize`
    steps it; bench.py:564-759) with the CLI's knobs: a full setup every
    BENCH_FULL_SETUP_EVERY (4) iterations, the recycle ring stored in
    BENCH_RECYCLE_DTYPE (the step's dtype)."""

    def __init__(self, vs, params, *, recycle_k, adaptive, setup_every):
        super().__init__(
            vs, params, recycle_k=recycle_k, adaptive=adaptive,
            setup_every=setup_every,
            full_every=int(os.environ.get("BENCH_FULL_SETUP_EVERY", "4")),
            recycle_dtype=os.environ.get("BENCH_RECYCLE_DTYPE", ""))


def _continuation_init(nels, dtype, device, *, recycle_k, adaptive,
                       setup_every, n_iters):
    """Coarse-to-fine continuation (bench.py:762-817): the same cantilever
    at half resolution for `n_iters` iterations, then the design prolonged
    by 2x repetition (exactly volume-preserving) and the displacements by
    the multigrid's trilinear `prolong`.  Returns (design_f, u_f, rtol_f,
    prelude seconds, last energy)."""
    from easysimp_tpu_torch.ops.multigrid import prolong
    from easysimp_tpu_torch.opt.continuation import prolong_design

    t0 = time.perf_counter()
    cnels = tuple(n // 2 for n in nels)
    _, vs_c, params_c = _build_problem(cnels, dtype, device)
    st = _Stepper(vs_c, params_c, recycle_k=recycle_k, adaptive=adaptive,
                  setup_every=setup_every)
    st.cold_power()
    energy = cg = None
    for _ in range(n_iters):
        energy, cg = st.one_step()
    _sync(device)
    log(f"continuation prelude {cnels}: {n_iters} iters in "
        f"{time.perf_counter() - t0:.1f}s; energy {float(energy):.6e} "
        f"cg {int(cg)}")
    design_f, u_f = prolong_design(st.design), prolong(st.u)
    rtol_f = st.rtol_now
    _sync(device)
    # the stepper and the step's closures form reference cycles: free the
    # coarse stage's ring and hierarchy before the fine one allocates
    del st, vs_c
    gc.collect()
    return design_f, u_f, rtol_f, time.perf_counter() - t0, float(energy)


@dataclass
class Measurement:
    """What `run_measurement` returns: the JSON line's payload, the energy
    and CG count of every fine iteration (iteration 1 first), the volume
    fraction of the final design and the stepper at the end of the run."""

    payload: dict
    energies: list = field(default_factory=list)
    cgs: list = field(default_factory=list)
    volume_fraction: float = math.nan
    stepper: object = None


def run_measurement(device="cuda") -> Measurement:
    """The 128^3 continuation trajectory on `device` ("cuda" by default, or
    "cpu"), timed; returns its JSON line's payload with the trajectory."""
    device = _check_device(device)
    nels = _nels("128,128,128")
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    n_timed = int(os.environ.get("BENCH_ITERS", "10"))
    nx, ny, nz = nels
    recycle_k = int(os.environ.get("BENCH_RECYCLE_K", "8"))
    forcing = os.environ.get("BENCH_FORCING", "adaptive")
    adaptive = forcing == "adaptive"
    setup_every = int(os.environ.get("BENCH_SETUP_EVERY", "1"))
    continuation = (os.environ.get("BENCH_CONTINUATION", "1") == "1"
                    and all(n % 2 == 0 for n in nels) and min(nels) >= 32)
    prelude_iters = int(os.environ.get("BENCH_PRELUDE_ITERS", "40"))
    late_start = int(os.environ.get("BENCH_LATE_START", "50"))
    skip_late = os.environ.get("BENCH_SKIP_LATE", "0") == "1"
    log(f"device {device} ({hardware(device)}), torch {torch.__version__}")

    t0 = time.perf_counter()
    grid, vs, params = _build_problem(nels, dtype, device)
    log(f"grid {nels} = {grid.n_cells} cells, {grid.n_dofs} dofs, dtype "
        f"{dtype}, recycle_k={recycle_k}, forcing={forcing}, "
        f"setup_every={setup_every}, continuation={continuation}")
    st = _Stepper(vs, params, recycle_k=recycle_k, adaptive=adaptive,
                  setup_every=setup_every)
    prelude_s = 0.0
    if continuation:
        design_f, u_f, rtol_f, prelude_s, _ = _continuation_init(
            nels, dtype, device, recycle_k=recycle_k, adaptive=adaptive,
            setup_every=setup_every, n_iters=prelude_iters)
        st.design, st.u = design_f, u_f
        if adaptive:
            st.rtol_now = rtol_f
        st.reset_recycle()
    else:
        prelude_iters = 0
    st.cold_power()
    if recycle_k > 1:
        log(f"subspace recycling enabled: k={recycle_k}")
    if adaptive:
        log(f"adaptive CG forcing: rtol in [{params.cg_rtol:g}, "
            f"{params.cg_rtol_max:g}], coeff {params.cg_forcing_coeff:g}")

    energies, cgs = [], []     # every fine iteration's, on the device/host

    def step():
        energy, cg = st.one_step()
        energies.append(energy)
        cgs.append(cg)
        return energy, cg

    _sync(device)
    t_fine = time.perf_counter()
    energy, cg = step()
    _sync(device)
    compile_s = time.perf_counter() - t_fine
    log(f"first fine step: {compile_s:.2f}s ({time.perf_counter() - t0:.1f}s "
        f"incl. build and prelude); energy {float(energy):.6e} cg {cg}")
    if not math.isfinite(float(energy)):
        # a NaN solve turns every later iteration into a no-op
        log("FIRST STEP PRODUCED NON-FINITE ENERGY")
        sys.exit(3)
    done = 1
    early_t, late_t, adv_t, adv_n = [], [], [], []

    def timed_step(samples):
        nonlocal done
        _sync(device)
        t1 = time.perf_counter()
        out = step()
        _sync(device)
        samples.append(time.perf_counter() - t1)
        done += 1
        return out

    while done < 2 + n_timed and len(early_t) < n_timed:
        energy, cg = timed_step(early_t)
    if early_t:
        log(f"EARLY: {len(early_t)} samples -> "
            f"{len(early_t) / sum(early_t):.2f} it/s; cg {cg}; "
            f"energy {float(energy):.6e}")
    if not skip_late:
        # advance to the late window in timed chunks of <= 8 iterations
        while done < late_start:
            chunk = min(8, late_start - done)
            _sync(device)
            t1 = time.perf_counter()
            for _ in range(chunk):
                energy, cg = step()
            _sync(device)
            adv_t.append(time.perf_counter() - t1)
            adv_n.append(chunk)
            done += chunk
        while len(late_t) < n_timed:
            energy, cg = timed_step(late_t)
        log(f"LATE (from iter {late_start + 1}): {len(late_t)} samples -> "
            f"{len(late_t) / sum(late_t):.2f} it/s; cg {cg}; "
            f"energy {float(energy):.6e}")
    energies = [float(e) for e in energies]
    if not all(math.isfinite(e) for e in energies):
        log("TRAJECTORY NON-FINITE")
        sys.exit(3)

    total_n = len(early_t) + len(late_t) + int(sum(adv_n))
    total_s = sum(early_t) + sum(late_t) + sum(adv_t)
    if total_n == 0:
        log("no timed samples collected")
        sys.exit(4)
    avg_its = total_n / total_s
    early_its = len(early_t) / sum(early_t) if early_t else None
    late_its = len(late_t) / sum(late_t) if late_t else None
    headline = {"avg": avg_its, "late": late_its, "early": early_its}.get(
        os.environ.get("BENCH_HEADLINE", "avg")) or avg_its
    payload = {
        "metric": f"simp_iterations_per_sec_{nx}x{ny}x{nz}",
        "value": round(headline, 3),
        "unit": "iters/sec",
        "avg_its": round(avg_its, 3), "avg_iters_timed": total_n,
        "avg_its_incl_prelude": round(
            total_n / (total_s + prelude_s) if prelude_s else avg_its, 3),
        "early_its": None if early_its is None else round(early_its, 3),
        "early_cg": cgs[len(early_t)] if early_t else None,
        "late_its": None if late_its is None else round(late_its, 3),
        "late_cg": cgs[-1], "late_start_iter": late_start,
        "compile_s": round(compile_s, 3),
        "continuation": bool(prelude_s),
        "prelude_iters": prelude_iters if prelude_s else 0,
        "prelude_s": round(prelude_s, 3),
        "config": {"mg_dtype": params.mg_cycle_dtype,
                   "smooth": params.mg_smooth_iters,
                   "cycle": params.mg_cycle, "recycle_k": recycle_k,
                   "forcing": forcing, "setup_every": setup_every,
                   "full_setup_every": st.full_every,
                   "rtol_max": params.cg_rtol_max},
        "hardware": hardware(device),
        "device": str(device),
    }
    volume_fraction = (float(st.design.sum()) * vs.elem_vol
                       / vs.total_volume)
    return Measurement(payload, energies, cgs, volume_fraction, st)


# --------------------------------------------------------------------------
# Phase breakdown
# --------------------------------------------------------------------------

def _time_ms(fn, device, graph, reps=10):
    """Median ms of one fn() call after two warm-up calls.  On a CUDA
    device: CUDA events around replays of a CUDA graph of the call
    (`graph`, for calls with no host synchronisation, so the host's cost is
    not counted) or around eager calls; on the CPU, wall time."""
    for _ in range(2):
        fn()
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    torch.cuda.synchronize(device)
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
        run()
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def phase_breakdown(st) -> list:
    """ms of the voxel iteration's parts at the stepper's current design
    and state (bench.py:115-154), logged to stderr; returns (name, ms,
    how) rows."""
    from easysimp_tpu_torch.bcs import build_free_mask
    from easysimp_tpu_torch.ops.oc import oc_update

    vs, params = st.vs, st.params
    device, op, filt = vs.device, vs.op, vs.filt
    design, u, state = st.design, st.u, st.state
    grid, _, bcs = _cantilever(vs.grid.nels)
    free_mask = vs.place(build_free_mask(grid, bcs), "node")
    scale = op.youngs_modulus(design)
    sens = op.compliance_sensitivities(u, design)
    fsens = filt.sensitivity_filter(design, sens)
    graph, eager = "CUDA-graph replays", "CUDA events, eager"
    if device.type != "cuda":
        graph = eager = "wall"
    rows = [
        ("matvec (K@u)", lambda: op.apply(u, scale, free_mask), graph),
        ("element energies", lambda: op.element_energies_unit(u), graph),
        ("sensitivity filter",
         lambda: filt.sensitivity_filter(design, sens), graph),
        ("OC bisection", lambda: oc_update(
            design, fsens, vs.vol_sens, params.volume_fraction,
            vs.total_volume, vs.vol_sens * vs.total_volume,
            params.move_limit, params.damping), eager),
        ("setup (full)", lambda: vs.setup(design, st.pvecs), eager),
    ]
    if st.light_ok:
        rows.append(("setup (light)",
                     lambda: vs.setup(design, st.pvecs, state), eager))
    rows.append(("step (CG, sensitivities, OC)",
                 lambda: vs.step(design, u, state, recycle=st.rhist,
                                 rtol=st.rtol_now), eager))
    out = [(name, _time_ms(fn, device, how == "CUDA-graph replays"), how)
           for name, fn, how in rows]
    log("--- phase breakdown (ms) ---")
    for name, ms, how in out:
        log(f"  {name:>30s}: {ms:9.3f}  ({how})")
    return out


# --------------------------------------------------------------------------
# Unstructured mode
# --------------------------------------------------------------------------

@dataclass
class UnstructuredRun:
    """What `run_unstructured` returns: the JSON line's payload, every
    iteration's energy and CG count, and what `unstructured_phase_breakdown`
    needs (the step, its free mask, the final design)."""

    payload: dict
    energies: list
    cgs: list
    step: object
    free_mask: torch.Tensor
    design: object


def _tet_cantilever(n):
    import easysimp_tpu_torch as pt

    grid = pt.generate_grid((n, n, n), (0.0, 0.0, 0.0), (float(n),) * 3)
    mesh = pt.tet_mesh_from_grid(grid)
    bcs = [pt.apply_fixed_boundary(
        mesh, pt.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))]
    loads = [pt.PointLoad(
        pt.select_nodes_by_box(mesh, [n, 0, 0], [n, 0, n], 1e-6),
        [0.0, -1.0, 0.0])]
    return mesh, loads, bcs


def run_unstructured(spec, device="cuda") -> UnstructuredRun:
    """it/s of the unstructured SIMP iteration (bench.py:220-427): spec
    "gripper" (the mesh stul14.vtu in EASYSIMP_REFERENCE_DATA) or N, a
    cantilever of N^3 voxels split into 6 tets each.  `simp_optimize`'s
    host schedule: recycle ring, adaptive CG tolerance from the host's
    `change`."""
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.bcs import build_free_mask
    from easysimp_tpu_torch.ops.cg import recycle_init, recycle_push
    from easysimp_tpu_torch.opt.optimize_unstructured import (
        build_unstructured_step,
    )
    device = _check_device(device)
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    n_timed = int(os.environ.get("BENCH_ITERS", "10"))
    late_start = int(os.environ.get("BENCH_LATE_START", "30"))
    recycle_k = int(os.environ.get("BENCH_RECYCLE_K", "8"))
    forcing = os.environ.get("BENCH_FORCING", "adaptive")
    smooth_p = os.environ.get("BENCH_SA", "0") == "1"
    accel = None
    solver_kw = dict(
        dtype=dtype, cg_rtol=1e-5,
        cg_rtol_max=float(os.environ.get("BENCH_RTOL_MAX", "1e-3")),
        cg_maxiter=2000, cg_recycle_k=recycle_k, cg_forcing=forcing,
        amg_smooth_prolongator=smooth_p,
        amg_max_coarse_dofs=int(os.environ.get("BENCH_AMG_COARSE", "6000")))
    if spec == "gripper":
        from easysimp_tpu_torch.models.gripper import build

        data = os.environ.get("EASYSIMP_REFERENCE_DATA", "")
        path = os.path.join(data, "stul14.vtu")
        if not data or not os.path.exists(path):
            raise SystemExit("BENCH_UNSTRUCTURED=gripper needs the mesh "
                             "stul14.vtu in the directory named by "
                             "EASYSIMP_REFERENCE_DATA")
        mesh, loads, bcs, params, accel = build(path, **solver_kw)
        name = "gripper"
    else:
        n = int(spec)
        mesh, loads, bcs = _tet_cantilever(n)
        params = pt.OptimizationParameters(
            E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
            filter_radius=1.5, **solver_kw)
        name = f"tet{n}"
    log(f"device {device} ({hardware(device)})")
    log(f"unstructured '{name}': {mesh.n_cells} {mesh.cell_type} cells, "
        f"{mesh.n_nodes} nodes, {mesh.n_dofs} dofs, dtype {dtype}, "
        f"recycle_k={recycle_k}, forcing={forcing}, smoothed_P={smooth_p}")

    t0 = time.perf_counter()
    us = build_unstructured_step(mesh, loads, bcs, params, accel,
                                 device=device)
    log(f"build (host element matrices, neighbour search, AMG "
        f"aggregation): {time.perf_counter() - t0:.1f}s")
    adaptive = forcing == "adaptive"
    design, u = us.design0, us.u0
    rhist = recycle_init(recycle_k, u) if recycle_k > 1 else None
    rtol_now = forcing_rtol(params, None) if adaptive else None
    energies, cgs = [], []

    def one_step():
        nonlocal design, u, rhist, rtol_now
        out = us.step(design, u, recycle=rhist, rtol=rtol_now)
        design, u, energy, change = out[0], out[1], out[3], out[5]
        if rhist is not None:
            rhist = recycle_push(rhist, u)
        if adaptive:
            rtol_now = forcing_rtol(params, float(change))
        energies.append(float(energy))
        cgs.append(int(out[9]))

    _sync(device)
    t1 = time.perf_counter()
    one_step()
    _sync(device)
    compile_s = time.perf_counter() - t1
    log(f"first step: {compile_s:.2f}s; energy {energies[-1]:.6e} "
        f"cg {cgs[-1]}")
    if not math.isfinite(energies[-1]):
        log("FIRST STEP PRODUCED NON-FINITE ENERGY")
        sys.exit(3)

    def window(n):
        _sync(device)
        t = time.perf_counter()
        for _ in range(n):
            one_step()
        _sync(device)
        return n / (time.perf_counter() - t)

    done = 1
    early_its = window(n_timed)
    done += n_timed
    early_cg = cgs[-1]
    log(f"EARLY: {early_its:.2f} it/s; cg {early_cg}; "
        f"energy {energies[-1]:.6e}")
    adv_its = None
    if done < late_start:
        adv_its = window(late_start - done)
        done = late_start
    late_its = window(n_timed)
    done += n_timed
    log(f"LATE (from iter {late_start + 1}): {late_its:.2f} it/s; "
        f"cg {cgs[-1]}; energy {energies[-1]:.6e}")
    if not all(math.isfinite(e) for e in energies):
        log("TRAJECTORY NON-FINITE")
        sys.exit(3)
    total_timed = done - 1
    spans = [n_timed / early_its, n_timed / late_its]
    if adv_its is not None:
        spans.append((late_start - 1 - n_timed) / adv_its)
    avg_its = total_timed / sum(spans)
    payload = {
        "metric": f"simp_iterations_per_sec_unstructured_{name}",
        "value": round(avg_its, 3),
        "unit": "iters/sec",
        "avg_its": round(avg_its, 3), "avg_iters_timed": total_timed,
        "early_its": round(early_its, 3), "early_cg": early_cg,
        "late_its": round(late_its, 3), "late_cg": cgs[-1],
        "late_start_iter": late_start, "compile_s": round(compile_s, 3),
        "cells": mesh.n_cells, "dofs": mesh.n_dofs,
        "config": {"recycle_k": recycle_k, "forcing": forcing,
                   "smoothed_prolongator": smooth_p, "dtype": dtype},
        "hardware": hardware(device),
        "device": str(device),
    }
    free_mask = torch.as_tensor(build_free_mask(mesh, bcs), dtype=us.dtype,
                                device=device)
    return UnstructuredRun(payload, energies, cgs, us, free_mask, design)


def unstructured_phase_breakdown(us, free_mask, design) -> list:
    """AMG setup, V-cycle and matvec ms at `design` (bench.py:430-476)."""
    op, amg, device = us.op, us.amg, us.device
    phys = us.filt.density_filter(design) if us.use_density_filter \
        else design
    scale = op.youngs_modulus(phys)

    def A(v):
        return op.apply(v, scale, free_mask)

    state = amg.setup(scale, free_mask)
    r = torch.ones(us.mesh.n_dofs, dtype=us.dtype, device=device) * free_mask
    graph, eager = "CUDA-graph replays", "CUDA events, eager"
    if device.type != "cuda":
        graph = eager = "wall"
    rows = [
        ("AMG setup (per SIMP iter)",
         lambda: amg.setup(scale, free_mask), eager),
        ("V-cycle apply (per CG iter)",
         lambda: amg.apply(r, A, state, free_mask), graph),
        ("matvec K@u (per CG iter)", lambda: A(r), graph),
    ]
    out = [(name, _time_ms(fn, device, how == "CUDA-graph replays"), how)
           for name, fn, how in rows]
    log("--- unstructured phase breakdown (ms) ---")
    for name, ms, how in out:
        log(f"  {name:>28s}: {ms:9.3f}  ({how})")
    return out


# --------------------------------------------------------------------------
# Sharded mode
# --------------------------------------------------------------------------

def sharded_problem(nels, dtype, device="cuda", mesh=None):
    """(VoxelStep, params) of the sharded mode's cantilever (bench.py:
    175-190), over `mesh` or on one device."""
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.opt.optimize import build_voxel_step

    grid, loads, bcs = _cantilever(nels)
    params = pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype=dtype, cg_rtol=1e-5, cg_maxiter=100,
        preconditioner="multigrid")
    return build_voxel_step(grid, loads, bcs, params, device=device,
                            mesh=mesh), params


def first_step(vs, pvecs=None):
    """One SIMP step from the initial design: a full preconditioner setup
    on the power vectors `pvecs` (default: the cold estimation, as
    `simp_optimize` starts) and the iteration.  The reference's evidence
    step sets up from the start vectors with two refresh iterations
    instead; on this cantilever its CG then reaches the cap of 100 in both
    packages (8^3, 16^3 on the CPU), where the cold estimation takes 9-10
    iterations."""
    if pvecs is None:
        pvecs = vs.power_init(vs.design0)
    state, _ = vs.setup(vs.design0, pvecs)
    return vs.step(vs.design0, vs.u0, state)


def run_sharded_evidence(n_devices, device="cuda") -> dict:
    """One SIMP step (setup and iteration, after the cold power estimation)
    over an n-shard ("x","y","z") mesh of the BENCH_NELS cantilever
    (bench.py:157-217), counting the port's halo copies and global
    reductions in it.  The shards take the visible cards
    round-robin, or n CPU shards on the CPU.  These are the port's own
    counts of the exchanges and joins it issues, not XLA's HLO counts of
    collectives.  BENCH_DTYPE (float32) sets the dtype."""
    from easysimp_tpu_torch.parallel import halo
    from easysimp_tpu_torch.parallel.sharding import (
        ShardedField,
        best_mesh_shape,
        make_mesh,
        round_robin_cards,
    )
    device = _check_device(device)
    nels = _nels("64,64,64")
    nx, ny, nz = nels
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    devices = (round_robin_cards(n_devices) if device.type == "cuda"
               else [device] * n_devices)
    shape = best_mesh_shape(n_devices, nels)
    mesh = make_mesh(n_devices, shape=shape, devices=devices)
    log(f"device {device} ({hardware(device)}); shards on "
        f"{[str(d) for d in devices]}")
    vs, _ = sharded_problem(nels, dtype, device.type, mesh)
    pvecs = vs.power_init(vs.design0)   # once per run, not per step
    _sync(device)
    halo.extend.copies = halo.extend.bytes = 0
    ShardedField.reductions = 0
    t0 = time.perf_counter()
    out = first_step(vs, pvecs)
    energy = float(out.energy)
    _sync(device)
    seconds = time.perf_counter() - t0
    copies, nbytes = halo.extend.copies, halo.extend.bytes
    reductions = ShardedField.reductions
    log(f"sharded step OK: mesh={shape} grid={nels} energy={energy:.6e} "
        f"cg={out.cg_iters} exec {seconds:.2f}s")
    log(f"in that step: {copies} halo copies ({nbytes / 1e6:.3f} MB) and "
        f"{reductions} global reductions (CG dots, volume and OC sums)")
    payload = {
        "metric": f"sharded_step_collectives_{n_devices}dev_{nx}x{ny}x{nz}",
        "value": copies + reductions,
        "unit": "collectives/step",
        "halo_copies": copies, "halo_bytes": nbytes,
        "reductions": reductions, "mesh": list(shape),
        "energy": energy, "cg_iters": out.cg_iters,
        "step_s": round(seconds, 3),
        "hardware": hardware(device),
        "device": str(device),
    }
    if not math.isfinite(energy):
        log("SHARDED STEP PRODUCED NON-FINITE ENERGY")
        sys.exit(3)
    return payload


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    stdout = sys.stdout
    phases = os.environ.get("BENCH_PHASES", "0") == "1"
    # the library's progress lines go to stderr: stdout carries only the
    # JSON line
    with contextlib.redirect_stdout(sys.stderr):
        if os.environ.get("BENCH_SHARDED", ""):
            payload = run_sharded_evidence(int(os.environ["BENCH_SHARDED"]),
                                           args.device)
            print(json.dumps(payload), file=stdout, flush=True)
        elif os.environ.get("BENCH_UNSTRUCTURED", ""):
            run = run_unstructured(os.environ["BENCH_UNSTRUCTURED"],
                                   args.device)
            print(json.dumps(run.payload), file=stdout, flush=True)
            if phases:
                unstructured_phase_breakdown(run.step, run.free_mask,
                                             run.design)
        else:
            run = run_measurement(args.device)
            print(json.dumps(run.payload), file=stdout, flush=True)
            if phases:
                phase_breakdown(run.stepper)
    return 0


if __name__ == "__main__":
    sys.exit(main())
