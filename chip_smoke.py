"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py

Phases, each of which asserts and prints a line:
  1. card:    the `nvidia-smi` name and power limit;
  2. build:   the voxel kernels, from easysimp_tpu_torch/csrc, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at a
              non-divisible 37x19x11 grid and at 128^3, in float64, float32
              and bfloat16; kernel and plain times at 128^3 float32 (CUDA
              events, median of 30 runs);
  4. main:    `easysimp_tpu_torch.simp_optimize(device="cuda")` on the
              128^3 bench cantilever (float32, Jacobi PCG, adaptive forcing,
              8-slot recycle ring), 3 SIMP iterations; both kernels' launch
              counters must be > 0 for that run;
  5. e2e:     3 SIMP iterations of a small float64 problem on the card
              through the kernels, against the same run with the operator's
              plain versions on the card, and on the CPU (rtol 1e-9).
Then a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits non-zero, printing no result, when no CUDA device is available or the
package is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "easysimp_tpu_torch/csrc/voxel_kernels.cu"
REPLACES = {
    "voxel_matvec": "easysimp_tpu/ops/pallas_kernels.py:183",
    "voxel_energies": "easysimp_tpu/ops/pallas_kernels.py:345",
}
TIMING_RUNS = 30


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


def cuda_ms(fn, runs=TIMING_RUNS):
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def check_kernels(pt, ck):
    """Phase 3.  Returns {kernel: (max_abs_err, ms, plain_ms)} at 128^3
    float32, the main path's shape and dtype."""
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    tol = {  # (matvec, energies) tolerances
        torch.float64: ("rtol/atol", 1e-12, 1e-11),
        torch.float32: ("of max|out|", 1e-5, 1e-5),
        torch.bfloat16: ("of max|out|", 5e-2, 5e-2),
    }
    report = {}
    for nels in [(37, 19, 11), (128, 128, 128)]:
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
                torch.cuda.synchronize()
                want = plain()
                assert got.dtype == want.dtype == dtype
                assert got.shape == want.shape
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
                      f"tol {t:g} {kind}) {'ok' if ok else 'FAIL'}")
                assert ok, f"{name} disagrees with its plain version"
                if nels[0] == 128 and dtype == torch.float32:
                    ms = cuda_ms(fn)
                    plain_ms = cuda_ms(plain)
                    phase("kernels", f"{name} 128^3 float32: kernel "
                          f"{ms:.4f} ms, plain {plain_ms:.4f} ms "
                          f"(median of {TIMING_RUNS})")
                    report[name] = (err, ms, plain_ms)
    return report


def run_main_path(pt, ck):
    """Phase 4: the port's entry point at full size on the card."""
    nels = (128, 128, 128)
    grid, loads, bcs = cantilever(pt, nels)
    params = pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype="float32", max_iterations=3,
        tolerance=1e-9, preconditioner="jacobi", cg_rtol=1e-5,
        cg_rtol_max=1e-3, cg_forcing="adaptive", cg_recycle_k=8,
        cg_maxiter=20000)
    ck.voxel_matvec.launches = 0
    ck.voxel_energies.launches = 0
    t0 = time.perf_counter()
    res = pt.simp_optimize(grid, loads, bcs, params, device="cuda")
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
    """Phase 5: kernel path against plain path, float64, small grid."""
    nels = (24, 12, 12)
    params = pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype="float64", max_iterations=3,
        tolerance=1e-9, preconditioner="jacobi", cg_rtol=1e-10)
    launches0 = ck.voxel_matvec.launches
    kern = pt.simp_optimize(*cantilever(pt, nels), params, device="cuda")
    assert ck.voxel_matvec.launches > launches0
    with operator_on_plain_versions():
        launches0 = ck.voxel_matvec.launches
        plain = pt.simp_optimize(*cantilever(pt, nels), params,
                                 device="cuda")
        assert ck.voxel_matvec.launches == launches0
    cpu = pt.simp_optimize(*cantilever(pt, nels), params, device="cpu")
    for name, other in [("plain on the card", plain), ("CPU", cpu)]:
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(kern.energy_history, other.energy_history))
        ok = len(kern.energy_history) == len(other.energy_history) \
            and rel <= 1e-9
        phase("e2e", f"{nels} float64, kernels vs {name}: energy max rel "
              f"diff {rel:.3e} (tol 1e-9) {'ok' if ok else 'FAIL'}")
        assert ok


def main() -> int:
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
    regs = [ln.strip() for ln in ck.build_info["log"].splitlines()
            if "registers" in ln]
    phase("build", f"{time.perf_counter() - t0:.2f} s -> "
          f"{ck.build_info['path']}; ptxas: {regs}")

    timing = check_kernels(pt, ck)
    launches = run_main_path(pt, ck)
    run_e2e_check(pt, ck)

    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": timing[name][0], "ms": timing[name][1],
        "plain_ms": timing[name][2],
    } for name in ("voxel_matvec", "voxel_energies")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
