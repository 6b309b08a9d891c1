"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --trace 3  # main path only, iteration 3 profiled
                                     # (chrome trace into --trace-dir)

Phases, each of which asserts and prints a line:
  1. card:    the `nvidia-smi` name and power limit;
  2. build:   the voxel kernels, from easysimp_tpu_torch/csrc, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
              37x19x11, 128^3 and the thin ragged grids 1x2x3 and 33x1x65,
              in float64, float32 and bfloat16; two launches on the same
              input must give bitwise-equal output; at 128^3 float32 the
              kernel, the plain version and (matvec) the simple fp32 kernel
              it replaced are timed in this run (CUDA events around
              replays of a CUDA graph of 10 calls, so no host time is
              counted; median of 2 x 30 replays, interleaved);
  4. library: the matvec's yardstick, one cuSPARSE SpMV (`torch.mv` on K(rho)
              assembled as a CSR matrix with int32 indices, the 27-point
              node stencil) at 128^3 float32, checked against the kernel;
  5. main:    `easysimp_tpu_torch.simp_optimize(device="cuda")` on the
              128^3 bench cantilever (float32, Jacobi PCG, adaptive forcing,
              8-slot recycle ring), 3 SIMP iterations; both kernels' launch
              counters must be > 0 for that run;
  6. e2e:     3 SIMP iterations of a small problem on the card through the
              kernels, against the same run with the operator's plain
              versions on the card: float64 (also against the CPU, rtol
              1e-9) and float32 (rtol 5e-4).
Then a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`bound_ms` in the kernels line is the least time the card could take for
the kernel's work at 128^3 float32: the larger of its bytes (each input read
once, the output written once) at 3.35 TB/s and its operations at the peak
rates, the element products as the kernel issues them (3xTF32: three TF32
products of 2 x 576 flops per element, 495 TFLOP/s) plus its fp32 scale,
sums or dot on the CUDA cores (67 TFLOP/s).

Exits non-zero, printing no result, when no CUDA device is available or the
package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

KERNEL_SOURCE = "easysimp_tpu_torch/csrc/voxel_kernels.cu"
REPLACES = {
    "voxel_matvec": "easysimp_tpu/ops/pallas_kernels.py:183",
    "voxel_energies": "easysimp_tpu/ops/pallas_kernels.py:345",
}
TIMING_RUNS = 30
GRAPH_CALLS = 10
SHAPES = [(37, 19, 11), (128, 128, 128), (1, 2, 3), (33, 1, 65)]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published peaks at 700 W
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cantilever(pt, nels):
    """The bench.py problem (bench.py:536-542) at grid size `nels`."""
    nx, ny, nz = nels
    grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(float(n) for n in nels))
    bc = pt.apply_fixed_boundary(
        grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    load = pt.PointLoad(pt.select_nodes_by_box(grid, [nx, 0, 0], [nx, 0, nz]),
                        [0.0, -1.0, 0.0])
    return grid, [load], [bc]


def cuda_times(fn, runs=TIMING_RUNS, graph=True):
    """Device times of one fn() call in ms, after warm-up.

    With `graph`, GRAPH_CALLS calls are captured in one CUDA graph and each
    replay is timed with CUDA events, so the host's cost of a call (Python,
    checks, the launch itself) is not counted.  Without, events bracket
    GRAPH_CALLS calls issued back to back: for calls much longer than their
    host cost (the cuSPARSE yardstick) that is the same device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(GRAPH_CALLS)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / GRAPH_CALLS)
    return times


def interleaved_ms(fns, graph=True):
    """Median ms of each fn, timed in the order a, b, ..., ..., b, a."""
    samples = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        samples[i] += cuda_times(fns[i], graph=graph)
    return [float(np.median(s)) for s in samples]


def bound(nbytes, tensor_flops, cuda_flops):
    """(bound_ms, bound_by) by the rule in the module docstring."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tensor_flops / TF32_FLOPS + cuda_flops / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_kernels(pt, ck):
    """Phase 3.  Returns {kernel: dict} at 128^3 float32, the main path's
    shape and dtype."""
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    tol = {  # (matvec, energies) tolerances
        torch.float64: ("rtol/atol", 1e-12, 1e-11),
        torch.float32: ("of max|out|", 1e-5, 1e-5),
        torch.bfloat16: ("of max|out|", 5e-2, 5e-2),
    }
    report = {}
    for nels in SHAPES:
        grid = pt.generate_grid(nels, (0.0, 0.0, 0.0), (1.6, 1.1, 0.9))
        gen = torch.Generator(device="cuda").manual_seed(0)
        u64 = torch.randn((*grid.nnodes_per_axis, 3), generator=gen,
                          dtype=torch.float64, device="cuda")
        rho = 0.05 + 0.95 * torch.rand(grid.nels, generator=gen,
                                       dtype=torch.float64, device="cuda")
        for dtype, (kind, tol_mv, tol_en) in tol.items():
            op = VoxelOperator(grid, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                               dtype=dtype, device="cuda")
            u = u64.to(dtype)
            scale = op.youngs_modulus(rho).to(dtype)
            for name, fn, plain, t in [
                ("voxel_matvec", lambda: ck.voxel_matvec(u, scale, op.ke),
                 lambda: ck.voxel_matvec_plain(u, scale, op.ke), tol_mv),
                ("voxel_energies", lambda: ck.voxel_energies(u, op.ke),
                 lambda: ck.voxel_energies_plain(u, op.ke), tol_en),
            ]:
                got = fn()
                again = fn()
                torch.cuda.synchronize()
                want = plain()
                assert got.dtype == want.dtype == dtype
                assert got.shape == want.shape
                same = torch.equal(got, again)
                got64, want64 = got.double(), want.double()
                err = float((got64 - want64).abs().max())
                ref = float(want64.abs().max())
                if kind == "rtol/atol":
                    ok = bool(torch.all((got64 - want64).abs()
                                        <= t + t * want64.abs()))
                else:
                    ok = err <= t * ref
                ok = ok and bool(torch.isfinite(got64).all())
                phase("kernels", f"{name} {nels} {str(dtype)[6:]}: "
                      f"max_abs_err {err:.3e} (max|out| {ref:.3e}, "
                      f"tol {t:g} {kind}), two launches bitwise equal: "
                      f"{same} {'ok' if ok and same else 'FAIL'}")
                assert ok, f"{name} disagrees with its plain version"
                assert same, f"{name} is not deterministic"
            if nels == (128, 128, 128) and dtype == torch.float32:
                report.update(time_kernels(ck, op, u, scale))
    return report


def time_kernels(ck, op, u, scale):
    """Kernel, plain and yardstick times at 128^3 float32, with bounds."""
    nels, nn = scale.numel(), u.numel() // 3
    mv = ck.voxel_matvec(u, scale, op.ke)
    simple = ck.voxel_matvec_simple_f32(u, scale, op.ke)
    plain = ck.voxel_matvec_plain(u, scale, op.ke)
    ref = float(plain.abs().max())
    err = float((mv - plain).abs().max())
    err_simple = float((simple - plain).abs().max())
    assert err_simple <= 1e-5 * ref, err_simple
    ms, simple_ms = interleaved_ms([
        lambda: ck.voxel_matvec(u, scale, op.ke),
        lambda: ck.voxel_matvec_simple_f32(u, scale, op.ke)])
    plain_ms, = interleaved_ms([
        lambda: ck.voxel_matvec_plain(u, scale, op.ke)])
    mv_bound = bound(2 * u.nbytes + scale.nbytes + op.ke.nbytes,
                     3 * 2 * 576 * nels, 24 * nels + 21 * nn)
    en = ck.voxel_energies(u, op.ke)
    en_err = float((en - ck.voxel_energies_plain(u, op.ke)).abs().max())
    en_ms, en_plain_ms = interleaved_ms([
        lambda: ck.voxel_energies(u, op.ke),
        lambda: ck.voxel_energies_plain(u, op.ke)])
    en_bound = bound(u.nbytes + en.nbytes + op.ke.nbytes,
                     3 * 2 * 576 * nels, 48 * nels)
    for name, k_ms, p_ms, (b_ms, b_by), extra in [
        ("voxel_matvec", ms, plain_ms, mv_bound,
         f", simple fp32 kernel {simple_ms:.4f} ms"),
        ("voxel_energies", en_ms, en_plain_ms, en_bound, ""),
    ]:
        phase("kernels", f"{name} 128^3 float32: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms{extra}; bound {b_ms:.4f} ms "
              f"({b_by}), {100 * b_ms / k_ms:.1f}% of bound")
    return {
        "voxel_matvec": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             simple_ms=simple_ms, bound_ms=mv_bound[0],
                             bound_by=mv_bound[1]),
        "voxel_energies": dict(max_abs_err=en_err, ms=en_ms,
                               plain_ms=en_plain_ms, bound_ms=en_bound[0],
                               bound_by=en_bound[1], library_ms=None),
    }


def assemble_csr(ke, scale):
    """K(scale) as a CSR matrix with int32 indices: per node row, the
    27-point node stencil of 3x3 blocks, entries outside the grid dropped.
    Block (n, d) = sum over corners c of E(element n - off(c)) ke[c, b],
    b the corner at off(c) + d."""
    from easysimp_tpu_torch.ops.elements import HEX_CORNERS

    dev, dt = scale.device, scale.dtype
    nx, ny, nz = scale.shape
    nnx, nny, nnz = nx + 1, ny + 1, nz + 1
    n = nnx * nny * nnz
    ec = torch.zeros((8, nnx, nny, nnz), dtype=dt, device=dev)
    for c, (dx, dy, dz) in enumerate(HEX_CORNERS):
        ec[c, dx:dx + nx, dy:dy + ny, dz:dz + nz] = scale
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    blocks = torch.zeros((8, 27, 3, 3), dtype=dt, device=dev)
    for c, oc in enumerate(HEX_CORNERS):
        for d, od in enumerate(offsets):
            ob = tuple(a + b for a, b in zip(oc, od))
            if ob in HEX_CORNERS:
                b = HEX_CORNERS.index(ob)
                blocks[c, d] = ke[3 * c:3 * c + 3, 3 * b:3 * b + 3]
    vals = (ec.reshape(8, n).T @ blocks.reshape(8, 243)).reshape(n, 27, 3, 3)
    del ec
    vals = vals.permute(0, 2, 1, 3).reshape(3 * n, 81)
    X = torch.arange(nnx, device=dev).view(-1, 1, 1)
    Y = torch.arange(nny, device=dev).view(1, -1, 1)
    Z = torch.arange(nnz, device=dev).view(1, 1, -1)
    valid = torch.stack([((X + dx >= 0) & (X + dx < nnx) & (Y + dy >= 0)
                          & (Y + dy < nny) & (Z + dz >= 0) & (Z + dz < nnz))
                         .reshape(n) for dx, dy, dz in offsets], dim=1)
    shift = torch.tensor([dx * nny * nnz + dy * nnz + dz
                          for dx, dy, dz in offsets], dtype=torch.int32,
                         device=dev)
    node = torch.arange(n, dtype=torch.int32, device=dev)
    cols = (3 * (node[:, None, None, None] + shift[None, None, :, None])
            + torch.arange(3, dtype=torch.int32, device=dev))
    cols = cols.expand(n, 3, 27, 3).reshape(3 * n, 81)
    mask = valid[:, None, :, None].expand(n, 3, 27, 3).reshape(3 * n, 81)
    crow = torch.zeros(3 * n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(mask.sum(dim=1), 0).to(torch.int32)
    col, val = cols[mask], vals[mask]
    del vals, cols, mask, valid
    return torch.sparse_csr_tensor(crow, col, val, (3 * n, 3 * n),
                                   check_invariants=False)


def library_matvec(pt, ck):
    """Phase 4: the cuSPARSE yardstick for voxel_matvec at 128^3 float32."""
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    grid = pt.generate_grid((128, 128, 128), (0.0, 0.0, 0.0),
                            (1.6, 1.1, 0.9))
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((*grid.nnodes_per_axis, 3), generator=gen,
                    dtype=torch.float64, device="cuda").float()
    rho = 0.05 + 0.95 * torch.rand(grid.nels, generator=gen,
                                   dtype=torch.float64, device="cuda")
    op = VoxelOperator(grid, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                       dtype=torch.float32, device="cuda")
    scale = op.youngs_modulus(rho).float()
    t0 = time.perf_counter()
    K = assemble_csr(op.ke, scale)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = u.reshape(-1)
    got = torch.mv(K, x)
    want = ck.voxel_matvec(u, scale, op.ke).reshape(-1)
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    assert err <= 1e-5 * ref, (err, ref)
    lib_ms, = interleaved_ms([lambda: torch.mv(K, x)], graph=False)
    gbytes = (K.values().nbytes + K.col_indices().nbytes
              + K.crow_indices().nbytes) / 1e9
    phase("library", f"cuSPARSE SpMV (torch.mv, CSR int32) 128^3 float32: "
          f"{K.values().numel()} nonzeros, {gbytes:.2f} GB, assembled in "
          f"{build_s:.1f} s; {lib_ms:.4f} ms; against the kernel "
          f"max_abs_err {err:.3e} (max|out| {ref:.3e}, tol 1e-5 of max) ok")
    del K, got
    torch.cuda.empty_cache()
    return lib_ms


def main_path_params(pt):
    return pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype="float32", max_iterations=3,
        tolerance=1e-9, preconditioner="jacobi", cg_rtol=1e-5,
        cg_rtol_max=1e-3, cg_forcing="adaptive", cg_recycle_k=8,
        cg_maxiter=20000)


def run_main_path(pt, ck):
    """Phase 5: the port's entry point at full size on the card."""
    nels = (128, 128, 128)
    grid, loads, bcs = cantilever(pt, nels)
    params = main_path_params(pt)
    ck.voxel_matvec.launches = 0
    ck.voxel_energies.launches = 0
    t0 = time.perf_counter()
    res = pt.simp_optimize(grid, loads, bcs, params)  # device="cuda"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"voxel_matvec": ck.voxel_matvec.launches,
                "voxel_energies": ck.voxel_energies.launches}
    vol_fracs = [v / grid.total_volume for v in res.volume_history]
    phase("main", f"128^3 float32 Jacobi: {res.iterations} iterations, "
          f"seconds/iteration {res.iteration_seconds}, "
          f"CG {res.cg_iterations_history}, energy {res.energy_history}, "
          f"volume fraction {vol_fracs}, total {wall:.2f} s "
          f"(final analysis included), launches {launches}")
    assert res.iterations == 3
    assert all(math.isfinite(e) for e in res.energy_history)
    assert math.isfinite(res.energy)
    assert all(abs(v - 0.3) <= 1e-4 for v in vol_fracs), vol_fracs
    assert all(c < params.cg_maxiter for c in res.cg_iterations_history)
    assert res.densities.shape == (grid.n_cells,)
    assert np.all(np.isfinite(res.densities))
    assert np.all(np.isfinite(res.displacements))
    assert all(n > 0 for n in launches.values()), launches
    return launches


@contextlib.contextmanager
def operator_on_plain_versions():
    """Route the operator's matvec and energies through the kernels' plain
    versions, also for CUDA tensors (a comparison harness only)."""
    from easysimp_tpu_torch.ops import cuda_kernels as ck
    from easysimp_tpu_torch.ops import operator

    saved = operator.voxel_matvec, operator.voxel_energies
    operator.voxel_matvec = ck.voxel_matvec_plain
    operator.voxel_energies = ck.voxel_energies_plain
    try:
        yield
    finally:
        operator.voxel_matvec, operator.voxel_energies = saved


def run_e2e_check(pt, ck):
    """Phase 6: kernel path against plain path on a small grid, float64
    and float32.

    float32 rtol 5e-4: the two float32 paths differ only in the rounding
    of their element products (3xTF32 on the tensor cores against fp32
    matmuls), but a trajectory carries that difference through CG solves
    that stop at a relative residual of 1e-5 and through the SIMP updates,
    and the energies end up ~1e-4 apart (1.0e-4 on an H100 in this phase);
    5e-4 leaves a margin of five."""
    nels = (24, 12, 12)
    for dtype, cg_rtol, rtol, with_cpu in [("float64", 1e-10, 1e-9, True),
                                           ("float32", 1e-5, 5e-4, False)]:
        params = pt.OptimizationParameters(
            E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
            filter_radius=1.5, dtype=dtype, max_iterations=3,
            tolerance=1e-9, preconditioner="jacobi", cg_rtol=cg_rtol)
        launches0 = ck.voxel_matvec.launches
        kern = pt.simp_optimize(*cantilever(pt, nels), params, device="cuda")
        assert ck.voxel_matvec.launches > launches0
        with operator_on_plain_versions():
            launches0 = ck.voxel_matvec.launches
            plain = pt.simp_optimize(*cantilever(pt, nels), params,
                                     device="cuda")
            assert ck.voxel_matvec.launches == launches0
        others = [("plain on the card", plain)]
        if with_cpu:
            others.append(("CPU", pt.simp_optimize(*cantilever(pt, nels),
                                                   params, device="cpu")))
        for name, other in others:
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(kern.energy_history, other.energy_history))
            ok = len(kern.energy_history) == len(other.energy_history) \
                and rel <= rtol
            phase("e2e", f"{nels} {dtype}, kernels vs {name}: energy max "
                  f"rel diff {rel:.3e} (tol {rtol:g}), CG "
                  f"{kern.cg_iterations_history} vs "
                  f"{other.cg_iterations_history} {'ok' if ok else 'FAIL'}")
            assert ok


def trace_main_path(pt, ck, iteration, out_dir):
    """The main path with `torch.profiler` on one SIMP iteration: device
    time by kernel and the device's idle share in that iteration.  The
    chrome trace goes to `out_dir`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from easysimp_tpu_torch.opt import optimize

    build = optimize.build_voxel_step
    window = {}

    def traced_build(*args, **kwargs):
        vs = build(*args, **kwargs)
        calls = [0]

        def step(*a, **kw):
            calls[0] += 1
            if calls[0] != iteration:
                return vs.step(*a, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = vs.step(*a, **kw)
                torch.cuda.synchronize()
                window.update(wall=time.perf_counter() - t0, prof=prof,
                              cg=out.cg_iters)
            return out
        return dataclasses.replace(vs, step=step)

    optimize.build_voxel_step = traced_build
    try:
        grid, loads, bcs = cantilever(pt, (128, 128, 128))
        pt.simp_optimize(grid, loads, bcs, main_path_params(pt))
    finally:
        optimize.build_voxel_step = build
    prof = window["prof"]
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    assert kernels, "the profiler recorded no device time"
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:  # union of the kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + (e.time_range.end - e.time_range.start), n + 1)
    groups = {"voxel_matvec": 0.0, "voxel_energies": 0.0,
              "PyTorch elementwise": 0.0, "dots and reductions": 0.0,
              "other": 0.0}
    for name, (t, _) in by_name.items():
        key = ("voxel_matvec" if "voxel_matvec" in name else
               "voxel_energies" if "voxel_energies" in name else
               "PyTorch elementwise" if "elementwise" in name.lower() else
               "dots and reductions" if any(
                   s in name.lower() for s in ("dot", "reduce", "gemv"))
               else "other")
        groups[key] += t
    wall_ms, busy_ms = window["wall"] * 1e3, busy_us / 1e3
    phase("trace", f"iteration {iteration}: CG {window['cg']}, wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for key, t in groups.items():
        phase("trace", f"  {key}: {t / 1e3:.1f} ms, "
              f"{100 * t / busy_us:.1f}% of busy")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        phase("trace", f"  {t / 1e3:8.2f} ms {n:6d} x  {name[:110]}")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace_iteration{iteration}.json"
    prof.export_chrome_trace(str(path))
    phase("trace", f"chrome trace: {path}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", type=int, metavar="ITERATION",
                        help="run only the main path, profiling this SIMP "
                             "iteration (1-3)")
    parser.add_argument("--trace-dir", type=Path, default=Path("traces"),
                        help="where --trace writes its chrome trace "
                             "(default: traces/)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.ops import cuda_kernels as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    phase("card", f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    ck.build_kernels()
    ptxas = [ln.strip() for ln in ck.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    phase("build", f"{time.perf_counter() - t0:.2f} s -> "
          f"{ck.build_info['path']}; ptxas: {ptxas}")

    if args.trace:
        trace_main_path(pt, ck, args.trace, args.trace_dir)
    else:
        timing = check_kernels(pt, ck)
        timing["voxel_matvec"]["library_ms"] = library_matvec(pt, ck)
        launches = run_main_path(pt, ck)
        run_e2e_check(pt, ck)
        kernels = [{
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            **timing[name],
        } for name in ("voxel_matvec", "voxel_energies")]
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
