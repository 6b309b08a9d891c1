"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --trace 3  # multigrid main path only, iteration 3
                                     # profiled (chrome trace into
                                     # --trace-dir)

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
              counted; median of 2 x 30 replays, interleaved), and at 128^3
              bfloat16 the matvec and its plain version, as the multigrid
              cycle runs them;
  4. library: the matvec's yardstick, one cuSPARSE SpMV (`torch.mv` on K(rho)
              assembled as a CSR matrix with int32 indices, the 27-point
              node stencil) at 128^3 float32, checked against the kernel;
  5. main:    `easysimp_tpu_torch.simp_optimize(device="cuda")` on the
              128^3 bench cantilever (float32, Jacobi PCG, adaptive forcing,
              8-slot recycle ring), 3 SIMP iterations; both kernels' launch
              counters must be > 0 for that run (the path before multigrid);
  6. multigrid: the V-cycle M(r) through the kernels against M(r) with the
              operator on its plain versions, on the card: float64 at
              16x8x8 (rtol 1e-12, also against the CPU) and at 128^3
              float32 with a bfloat16 cycle (5e-2 of max|M r|); two runs of
              M on one r bitwise equal; at 128^3 the level layout and memory,
              one V-cycle's device time, in all and by level, and one
              stencil apply per level (CUDA-graph replays);
  7. main-mg: the main path, `simp_optimize` on the 128^3 bench cantilever
              with the bench.py:543-559 composition (Galerkin multigrid,
              bfloat16 V(1,2) cycle, light setup every 4, adaptive forcing,
              8-slot recycle ring), 10 SIMP iterations: seconds per
              iteration, CG counts (< 500), volume fraction, peak memory,
              launches per kernel and storage dtype (matvec on float32 and
              bfloat16 > 0, energies > 0); then the same run again with a
              synchronising timer around each setup and step, for the
              split between setup and solve time;
  8. e2e:     3 SIMP iterations of a small problem on the card through the
              kernels, against the same run with the operator's plain
              versions on the card: Jacobi float64 (also against the CPU,
              rtol 1e-9) and float32 (rtol 5e-4); multigrid float64 (as
              preconditioner="auto" resolves; also against the CPU, rtol
              1e-9) and float32 with a bfloat16 cycle (rtol 5e-4).
  9. lame:    the two-field Lamé operator of a `material_model`:
              `apply_K_lame` (two `voxel_matvec` launches, with ke_lam and
              ke_mu) and `element_energies_lame` (two `voxel_energies`
              launches) against their plain versions on the card, at
              37x19x11 and 128^3, float64 and float32, with random positive
              Lamé fields and with lam = 0; the launch counters rise by 2
              per call; two runs bitwise equal; a CUDA graph of the call
              replays to the eager result; apply_K_lame(u, lam(E), mu(E))
              against apply_K(u, E); at 128^3 float32 the two-launch route
              and the plain route are timed (CUDA-graph replays);
 10. main-lame: the main-mg composition with material_model = the SIMP
              closure, 5 SIMP iterations, three runs in turns with three
              of the same 5 iterations without it: energies against
              main-mg's first 5 (rtol 5e-3, the accuracy of solves that
              stop at 1e-3; at 24x12x12 with every solve at 1e-5, rtol
              5e-4), CG < 500, volume fraction 0.3, float32 matvec launches
              1.5-2x the default run's, energies launches exactly twice,
              seconds for the 5 iterations of each; then 3 iterations of a
              RAMP law whose Poisson ratio depends on the density: finite,
              energy falling, CG < 500;
 11. continuation: main-mg with continuation_levels=1 (a 64^3 stage of 10
              iterations), 3 fine iterations: the prolonged design's volume
              fraction, CG and seconds of the first fine iteration beside
              main-mg's cold first iteration;
 12. io:      at 24x12x12 float64 on the card (multigrid, 8-slot recycle
              ring) 6 iterations against 3, a checkpoint and 3 resumed:
              energies rtol 1e-10, densities atol 1e-12; a 4-iteration run
              with profile_dir leaves a trace; at 128^3 the main-mg result
              exported with export_results_vtu (seconds, bytes) and read
              back, and one checkpoint of the main-mg state saved and
              loaded (seconds, bytes).
 13. unstructured-ops: the unstructured path's modules (library tensor ops,
              no hand kernel: the reference runs them outside Pallas) on
              `tet_mesh_from_grid` of 12x6x6 in float64 and float32: the
              operator, the neighbour-list filter, the AMG setup and one
              V-cycle on the card against the same objects on the CPU
              (float64 1e-10, float32 1e-4 of max|out|); two operator
              applies and two V-cycles bitwise equal; the neighbour route;
 14. main-unstructured: `simp_optimize` on an UnstructuredMesh with the
              bench.py:262-281 composition: tet_mesh_from_grid of 44^3
              (511,104 tets, 273,375 dofs), float32, AMG (tentative
              prolongator, coarsest level <= 6000 dofs), adaptive forcing,
              8-slot ring, 5 SIMP iterations: host build seconds by part,
              seconds and CG per iteration, the hierarchy, peak memory; a
              second run with a synchronising timer for AMG setup and solve
              seconds; one operator apply and one V-cycle as CUDA-graph
              replays (event-timed if they do not capture); energies
              finite and falling, volume fraction 0.3, CG < 2000; the two
              voxel kernels launch no time on this path; then the same
              composition at 16^3, 24^3 and 32^3 for the CG count's growth
              with the size;
 15. e2e-unstructured: 12x6x6 tets, 6 iterations on the card against the
              CPU in float64 (energies rtol 1e-8, CG counts equal) and
              float32 on the card against float64 (5e-3).
 16. sharded: the multi-device path, its shards on the visible cards
              round-robin (cuda:0 repeated when one card is visible; the
              device list is printed): (b) the sharded masked matvec, M(r)
              and one SIMP step against one device, both on the card, at
              24x12x12 float64 over (4,1,1), (2,2,1), (2,2,2) with the
              coarsest level lowered (EASYSIMP_MAX_COARSE_DOFS=500) so that
              level 1 is distributed (1e-12 matvec, 1e-10 M(r) and step,
              equal CG counts), at 128^3 float32 over (4,1,1) (1e-5 of
              max|out| for the matvec, 1e-4 for M(r) with a float32 cycle:
              see run_sharded; float64 1e-12 / 1e-10) and at 8x4x4 over
              (8,1,1), one cell per shard; (c) main-sharded: the main-mg
              composition at 128^3 for 5 iterations over (4,1,1), then
              (2,2,2), with the shards' device list printed: energies against
              main-mg's first 5 (rtol 5e-3), CG within 2, seconds per
              iteration, launches and halo copies per CG iteration, the
              distributed levels, the coarse gather's time, peak memory;
              (a) both kernels against their plain versions at every
              shard-local block shape (b) and (c) gave them; (d) the
              dry-run twin (easysimp_tpu_torch/dryrun.py) on the card
              against the unsharded step on the card (rtol 1e-6, CG 11 on
              every split) and MULTICHIP_r05.json (rtol 1e-4), and the
              element-sharded unstructured path on 16^3 x 6 tets over 4
              shards against one device (float64, rtol 1e-9, equal CG).
Then a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`bound_ms` in the kernels line is the least time the card could take for
the kernel's work at 128^3 float32: the larger of its bytes (each input read
once, the output written once) at 3.35 TB/s and its operations at the peak
rates: the element products at the cheapest split that keeps float32
accuracy (float32 storage: three TF32 products of 2 x 576 flops per element
at 495 TFLOP/s; bfloat16 storage, whose values are exact in bfloat16: ke
split into three bfloat16 pieces, three bfloat16 products at 989 TFLOP/s)
plus the fp32 scale, sums or dot on the CUDA cores (67 TFLOP/s).  The
launches are those of the main-mg run; `launches_lame` those of one
main-lame run (5 iterations with the SIMP closure);
`launches_unstructured` those of the main-unstructured run (0: no TPU
kernel lies on that path); `launches_sharded` those of the two
main-sharded runs together.

Exits non-zero, printing no result, when no CUDA device is available or the
package is missing.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
BF16_FLOPS = 989e12
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


def bound(nbytes, tensor_flops, cuda_flops, tensor_rate=TF32_FLOPS):
    """(bound_ms, bound_by) by the rule in the module docstring."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tensor_flops / tensor_rate + cuda_flops / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def agree(got, want, kind, t):
    """(ok, max_abs_err, max|want|) of `got` against `want` in float64:
    kind "rtol/atol" holds |got - want| <= t + t |want| elementwise, any
    other kind max|got - want| <= t max|want|; `got` must be finite."""
    got64, want64 = got.double(), want.double()
    err = float((got64 - want64).abs().max())
    ref = float(want64.abs().max())
    if kind == "rtol/atol":
        ok = bool(torch.all((got64 - want64).abs() <= t + t * want64.abs()))
    else:
        ok = err <= t * ref
    return ok and bool(torch.isfinite(got64).all()), err, ref


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
                ok, err, ref = agree(got, want, kind, t)
                phase("kernels", f"{name} {nels} {str(dtype)[6:]}: "
                      f"max_abs_err {err:.3e} (max|out| {ref:.3e}, "
                      f"tol {t:g} {kind}), two launches bitwise equal: "
                      f"{same} {'ok' if ok and same else 'FAIL'}")
                assert ok, f"{name} disagrees with its plain version"
                assert same, f"{name} is not deterministic"
            if nels == (128, 128, 128) and dtype == torch.float32:
                report.update(time_kernels(ck, op, u, scale))
            if nels == (128, 128, 128) and dtype == torch.bfloat16:
                report["voxel_matvec"].update(
                    time_matvec_bf16(ck, op, u, scale))
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


def time_matvec_bf16(ck, op, u, scale):
    """The matvec on bfloat16 storage at 128^3, as the multigrid cycle's
    level 0 runs it: kernel and plain times, with its bound (three
    bfloat16 products per element, ke split into three bfloat16 pieces)."""
    nels, nn = scale.numel(), u.numel() // 3
    ms, plain_ms = interleaved_ms([
        lambda: ck.voxel_matvec(u, scale, op.ke),
        lambda: ck.voxel_matvec_plain(u, scale, op.ke)])
    b_ms, b_by = bound(2 * u.nbytes + scale.nbytes + op.ke.nbytes,
                       3 * 2 * 576 * nels, 24 * nels + 21 * nn,
                       tensor_rate=BF16_FLOPS)
    phase("kernels", f"voxel_matvec 128^3 bfloat16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
          f"{100 * b_ms / ms:.1f}% of bound")
    return dict(bf16_ms=ms, bf16_plain_ms=plain_ms, bf16_bound_ms=b_ms,
                bf16_bound_by=b_by)


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
    """Phase 8: kernel path against plain path on a small grid, float64
    and float32, with Jacobi and with multigrid.

    float32 rtol 5e-4: the two float32 paths differ only in the rounding
    of their element products (3xTF32 on the tensor cores against fp32
    matmuls; with a bfloat16 cycle, also in which bfloat16 value a matvec
    output rounds to), but a trajectory carries that difference through CG
    solves that stop at a relative residual of 1e-5 and through the SIMP
    updates, and the energies end up ~1e-4 apart (Jacobi: 1.0e-4 on an
    H100 in this phase); 5e-4 leaves a margin of five."""
    nels = (24, 12, 12)
    for precond, dtype, cycle, cg_rtol, rtol, with_cpu in [
            ("jacobi", "float64", "", 1e-10, 1e-9, True),
            ("jacobi", "float32", "", 1e-5, 5e-4, False),
            ("auto", "float64", "", 1e-10, 1e-9, True),  # multigrid here
            ("multigrid", "float32", "bfloat16", 1e-5, 5e-4, False)]:
        params = pt.OptimizationParameters(
            E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
            filter_radius=1.5, dtype=dtype, max_iterations=3,
            tolerance=1e-9, preconditioner=precond, cg_rtol=cg_rtol,
            mg_cycle_dtype=cycle, mg_smooth_iters=(1, 2))
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
            phase("e2e", f"{nels} {precond} {dtype}"
                  f"{' ' + cycle + ' cycle' if cycle else ''}, kernels vs "
                  f"{name}: energy max "
                  f"rel diff {rel:.3e} (tol {rtol:g}), CG "
                  f"{kern.cg_iterations_history} vs "
                  f"{other.cg_iterations_history} {'ok' if ok else 'FAIL'}")
            assert ok


def mg_problem(pt, nels, dtype, device, seed=0):
    """The bench cantilever's operator and free mask at `nels`, moduli of a
    mild design (rho uniform in [0.3, 1]) and a masked random residual, all
    made from `seed` with numpy."""
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    grid, _, bcs = cantilever(pt, nels)
    op = VoxelOperator(grid, E0=1.0, Emin=1e-9, nu=0.3, p=3.0, dtype=dtype,
                       device=device)
    dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    mask = dev(pt.build_free_mask(grid, bcs))
    rng = np.random.default_rng(seed)
    scale = op.youngs_modulus(dev(rng.uniform(0.3, 1.0, nels)))
    r = dev(rng.standard_normal((*grid.nnodes_per_axis, 3))) * mask
    return op, mask, scale, r


def max_rel(got, want):
    """max|got - want| / max|want|, in float64."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).abs().max() / want.abs().max())


def check_multigrid(pt, ck):
    """Phase 6."""
    from easysimp_tpu_torch.ops.multigrid import (
        MultigridPreconditioner,
        restrict,
    )
    from easysimp_tpu_torch.ops.stencil import apply_stencil

    kw = dict(smooth_iters=(1, 2))
    # float64 16x8x8: kernels against plain versions on the card and the CPU
    runs = {}
    for name, device in [("kernels", "cuda"), ("plain on the card", "cuda"),
                         ("CPU", "cpu")]:
        op, mask, scale, r = mg_problem(pt, (16, 8, 8), torch.float64, device)
        plain = (operator_on_plain_versions() if name.startswith("plain")
                 else contextlib.nullcontext())
        with plain:
            launches0 = ck.voxel_matvec.launches
            mg = MultigridPreconditioner(op, **kw)
            runs[name] = mg.preconditioner_factory()(scale, mask)(r)
            assert (ck.voxel_matvec.launches > launches0) == \
                (name == "kernels"), name
    for name in ("plain on the card", "CPU"):
        rel = max_rel(runs["kernels"], runs[name])
        ok = rel <= 1e-12 and bool(torch.isfinite(runs["kernels"]).all())
        phase("multigrid", f"M(r) 16x8x8 float64, {mg.n_levels} levels, "
              f"kernels vs {name}: max_abs_err/max|M r| {rel:.3e} (tol "
              f"1e-12) {'ok' if ok else 'FAIL'}")
        assert ok

    # 128^3 float32 with a bfloat16 cycle, as the main path runs it
    nels = (128, 128, 128)
    op, mask, scale, r = mg_problem(pt, nels, torch.float32, "cuda")
    mg = MultigridPreconditioner(op, cycle_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pvecs = mg.power_init(scale, mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, _ = mg.setup(scale, mask, pvecs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    setup_peak = torch.cuda.max_memory_allocated() - base
    M = mg.make_M(state)
    got = M(r)
    again = M(r)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    with operator_on_plain_versions():
        launches0 = ck.voxel_matvec.launches
        state_p, _ = mg.setup(scale, mask, pvecs)
        want = mg.make_M(state_p)(r)
        assert ck.voxel_matvec.launches == launches0
        del state_p
    rel = max_rel(got, want)
    ok = rel <= 5e-2 and bool(torch.isfinite(got).all())
    phase("multigrid", f"M(r) 128^3 float32, bfloat16 cycle, kernels vs "
          f"plain on the card: max_abs_err/max|M r| {rel:.3e} (tol 5e-2: "
          f"one bfloat16 ulp is 2^-8), two runs bitwise equal: {same} "
          f"{'ok' if ok and same else 'FAIL'}")
    assert ok and same
    phase("multigrid", f"128^3 power_init {t1 - t0:.3f} s, setup "
          f"{t2 - t1:.3f} s (host clock, first calls), setup peak "
          f"{setup_peak / 1e6:.0f} MB above {base / 1e6:.0f} MB")
    for lvl, o in enumerate(mg.ops):
        st = state["stencils"][lvl]
        what = ("voxel_matvec on " + str(mg.cycle_ops[lvl].dtype)[6:]
                if st is None else
                f"stencil {tuple(st.shape)} {str(st.dtype)[6:]} "
                f"{st.nbytes / 1e6:.1f} MB")
        if lvl == mg.n_levels - 1:
            what += f", dense Cholesky {tuple(state['cho'][0].shape)}"
        phase("multigrid", f"  level {lvl}: {o.grid.nels} elements, "
              f"{3 * o.grid.n_nodes} dofs, {what}")

    # one V-cycle's device time, in all and from each level down
    lp = torch.bfloat16
    rs = [r.to(lp)]
    for lvl in range(1, mg.n_levels):
        rs.append(state["masks"][lvl] * restrict(rs[-1]))
    cycle_ms, = interleaved_ms([lambda: M(r)])
    down = [interleaved_ms([lambda lvl=lvl: mg._vcycle(lvl, state,
                                                       rs[lvl])])[0]
            for lvl in range(mg.n_levels)] + [0.0]
    own = [down[lvl] - down[lvl + 1] for lvl in range(mg.n_levels)]
    phase("multigrid", f"one V-cycle 128^3 (M(r), bfloat16 cycle, CUDA-graph "
          f"replays): {cycle_ms:.4f} ms; by level (cycle from the level down "
          f"minus the next): "
          + ", ".join(f"L{lvl} {t:.4f} ms" for lvl, t in enumerate(own)))
    # one apply_stencil per level that the cycle smooths with a stencil,
    # with its byte bound (coefficients and field read once, the result
    # written once)
    for lvl in range(1, mg.n_levels - 1):
        st = state["stencils"][lvl]
        ms, = interleaved_ms([lambda: apply_stencil(st, rs[lvl])])
        b_ms = (st.nbytes + 2 * rs[lvl].nbytes) / HBM_BYTES_PER_S * 1e3
        phase("multigrid", f"  apply_stencil level {lvl} "
              f"{tuple(rs[lvl].shape[:3])} nodes {str(st.dtype)[6:]}: "
              f"{ms:.4f} ms (CUDA-graph replays), byte bound {b_ms:.4f} ms")
    del state, M, got, again, want
    torch.cuda.empty_cache()


def main_mg_params(pt, iterations=10):
    """The bench.py:543-559 composition."""
    return pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype="float32", max_iterations=iterations,
        tolerance=1e-9, preconditioner="multigrid",
        mg_cycle_dtype="bfloat16", mg_smooth_iters=(1, 2),
        mg_refresh_iters=2, mg_full_setup_every=4, cg_rtol=1e-5,
        cg_rtol_max=1e-3, cg_forcing="adaptive", cg_recycle_k=8,
        cg_maxiter=500)


@contextlib.contextmanager
def patched_voxel_step(wrap):
    """simp_optimize builds its VoxelStep through wrap(vs) -> vs'."""
    from easysimp_tpu_torch.opt import optimize

    build = optimize.build_voxel_step
    optimize.build_voxel_step = lambda *a, **kw: wrap(build(*a, **kw))
    try:
        yield
    finally:
        optimize.build_voxel_step = build


def timed(fn, seconds):
    """fn, with the host time of each call (synchronised on both sides)
    appended to `seconds`."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def run_main_mg(pt, ck):
    """Phase 7: the multigrid main path at 128^3 on the card, as a user
    runs it (seconds per iteration, CG, launches), then once more with a
    synchronising timer around each power_init, setup and step for the
    split between setup and solve (those syncs cost the overlap of a
    setup's device tail with the step's enqueue, so the split comes from
    that second run only)."""
    grid, loads, bcs = cantilever(pt, (128, 128, 128))
    params = main_mg_params(pt)

    for fn in (ck.voxel_matvec, ck.voxel_energies):
        fn.launches = 0
        fn.launches_by_dtype.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pt.simp_optimize(grid, loads, bcs, params)  # device="cuda"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"voxel_matvec": ck.voxel_matvec.launches,
                "voxel_energies": ck.voxel_energies.launches}
    by_dtype = {fn.__name__: {str(k)[6:]: v for k, v in
                              fn.launches_by_dtype.items()}
                for fn in (ck.voxel_matvec, ck.voxel_energies)}
    mv = dict(ck.voxel_matvec.launches_by_dtype)

    times = {"power_init": [], "setup": [], "step": []}
    kinds = []      # "F" full setup, "L" light setup (on a previous state)

    def wrap(vs):
        setup = timed(vs.setup, times["setup"])

        def kind_setup(design, pvecs, prev_state=None):
            kinds.append("F" if prev_state is None else "L")
            return setup(design, pvecs, prev_state)

        return dataclasses.replace(
            vs, power_init=timed(vs.power_init, times["power_init"]),
            setup=kind_setup, step=timed(vs.step, times["step"]))

    with patched_voxel_step(wrap):
        timed_res = pt.simp_optimize(grid, loads, bcs, params)

    vol_fracs = [v / grid.total_volume for v in res.volume_history]
    fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"  # noqa
    phase("main-mg", f"128^3 float32, multigrid bfloat16 V(1,2): "
          f"{res.iterations} iterations, seconds/iteration "
          f"{fmt(res.iteration_seconds)} (median "
          f"{float(np.median(res.iteration_seconds)):.4f}), CG "
          f"{res.cg_iterations_history}")
    phase("main-mg", f"  timed run (synchronised around each call): setup s "
          f"{fmt(times['setup'])} ({''.join(kinds)}: F full, L light; "
          f"power_init {fmt(times['power_init'])} before the loop), step s "
          f"(solve, sensitivities, OC) {fmt(times['step'])}, "
          f"seconds/iteration {fmt(timed_res.iteration_seconds)}, CG "
          f"{timed_res.cg_iterations_history}")
    phase("main-mg", f"  energy {res.energy_history}")
    phase("main-mg", f"  volume fraction {vol_fracs}, total {wall:.2f} s "
          f"(power_init and final analysis included), peak memory "
          f"{peak / 1e9:.3f} GB, launches {launches}, by storage dtype "
          f"{by_dtype}")
    assert res.iterations == params.max_iterations
    assert all(math.isfinite(e) for e in res.energy_history)
    assert math.isfinite(res.energy)
    assert all(abs(v - 0.3) <= 1e-4 for v in vol_fracs), vol_fracs
    assert all(c < 500 for c in res.cg_iterations_history)
    assert np.all(np.isfinite(res.densities))
    assert np.all(np.isfinite(res.displacements))
    # the timed run is the same computation (5e-4: the float32 rtol of e2e)
    assert len(timed_res.energy_history) == len(res.energy_history)
    assert all(abs(a - b) <= 5e-4 * abs(b) for a, b in
               zip(timed_res.energy_history, res.energy_history))
    assert all(c < 500 for c in timed_res.cg_iterations_history)
    assert mv[torch.float32] > 0 and mv[torch.bfloat16] > 0, by_dtype
    assert ck.voxel_energies.launches > 0
    return launches, grid, res


def counted_run(pt, ck, problem, params, **kw):
    """simp_optimize on the card with both kernels' counters set to 0 just
    before: (result, {kernel: launches}, {matvec storage dtype: launches})."""
    for fn in (ck.voxel_matvec, ck.voxel_energies):
        fn.launches = 0
        fn.launches_by_dtype.clear()
    res = pt.simp_optimize(*problem, params, **kw)  # device="cuda"
    torch.cuda.synchronize()
    launches = {"voxel_matvec": ck.voxel_matvec.launches,
                "voxel_energies": ck.voxel_energies.launches}
    return res, launches, dict(ck.voxel_matvec.launches_by_dtype)


def check_lame(pt, ck):
    """Phase 9."""
    from easysimp_tpu_torch.ops.elements import lame_parameters
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    tol = {torch.float64: ("rtol/atol", 1e-12, 1e-11),
           torch.float32: ("of max|out|", 1e-5, 1e-5)}

    for nels in [(37, 19, 11), (128, 128, 128)]:
        grid = pt.generate_grid(nels, (0.0, 0.0, 0.0), (1.6, 1.1, 0.9))
        gen = torch.Generator(device="cuda").manual_seed(1)
        rand = lambda shape: torch.rand(  # noqa: E731
            shape, generator=gen, dtype=torch.float64, device="cuda")
        u64 = 2.0 * rand((*grid.nnodes_per_axis, 3)) - 1.0
        lam64, mu64, rho64 = (0.05 + 0.95 * rand(grid.nels)
                              for _ in range(3))
        for dtype, (kind, tol_mv, tol_en) in tol.items():
            op = VoxelOperator(grid, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                               dtype=dtype, device="cuda")
            u, mu = u64.to(dtype), mu64.to(dtype)
            ke_lam, ke_mu = op.ke_lame_basis
            for case, lam in [("random lam, mu", lam64.to(dtype)),
                              ("lam = 0", torch.zeros_like(mu))]:
                n0 = ck.voxel_matvec.launches
                got = op.apply_K_lame(u, lam, mu)
                again = op.apply_K_lame(u, lam, mu)
                assert ck.voxel_matvec.launches == n0 + 4
                ok, err, ref = agree(got, op.apply_K_lame_plain(u, lam, mu),
                                     kind, tol_mv)
                same = torch.equal(got, again)
                phase("lame", f"apply_K_lame {nels} {str(dtype)[6:]} "
                      f"{case}: max_abs_err {err:.3e} (max|out| {ref:.3e}, "
                      f"tol {tol_mv:g} {kind}), 2 launches per call, two "
                      f"runs bitwise equal: {same} "
                      f"{'ok' if ok and same else 'FAIL'}")
                assert ok and same
            n0 = ck.voxel_energies.launches
            wl, wm = op.element_energies_lame(u)
            wl2, wm2 = op.element_energies_lame(u)
            assert ck.voxel_energies.launches == n0 + 4
            for name, w, w2, ke in [("lam", wl, wl2, ke_lam),
                                    ("mu", wm, wm2, ke_mu)]:
                ok, err, ref = agree(w, ck.voxel_energies_plain(u, ke), kind,
                                     tol_en)
                same = torch.equal(w, w2)
                phase("lame", f"element_energies_lame[{name}] {nels} "
                      f"{str(dtype)[6:]}: max_abs_err {err:.3e} (max|out| "
                      f"{ref:.3e}, tol {tol_en:g} {kind}), bitwise repeat "
                      f"{same} {'ok' if ok and same else 'FAIL'}")
                assert ok and same
            # the SIMP law through the Lamé route is the one-field operator
            E = op.youngs_modulus(rho64).to(dtype)
            lam_E, mu_E = lame_parameters(E, op.nu)
            ok, err, ref = agree(op.apply_K_lame(u, lam_E, mu_E),
                                 op.apply_K(u, E), kind, tol_mv)
            phase("lame", f"apply_K_lame(u, lam(E), mu(E)) vs apply_K(u, E) "
                  f"{nels} {str(dtype)[6:]}: max_abs_err {err:.3e} (max|out| "
                  f"{ref:.3e}, tol {tol_mv:g} {kind}) "
                  f"{'ok' if ok else 'FAIL'}")
            assert ok
            if nels == (37, 19, 11):
                # each of the two launches sees its own ke inside a graph
                # too (the float64 kernels copy ke to __constant__ memory
                # per launch)
                lam = lam64.to(dtype)
                eager = op.apply_K_lame(u, lam, mu)
                torch.cuda.synchronize()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = op.apply_K_lame(u, lam, mu)
                out.zero_()
                g.replay()
                torch.cuda.synchronize()
                same = torch.equal(out, eager)
                phase("lame", f"apply_K_lame {nels} {str(dtype)[6:]} as a "
                      f"CUDA graph: replay bitwise equal to the eager call: "
                      f"{same} {'ok' if same else 'FAIL'}")
                assert same
            if nels == (128, 128, 128) and dtype == torch.float32:
                lam = lam64.to(dtype)
                ms, plain_ms = interleaved_ms([
                    lambda: op.apply_K_lame(u, lam, mu),
                    lambda: op.apply_K_lame_plain(u, lam, mu)])
                en_ms, = interleaved_ms([
                    lambda: op.element_energies_lame(u)])
                phase("lame", f"128^3 float32 (CUDA-graph replays): "
                      f"apply_K_lame, two launches and their sum, "
                      f"{ms:.4f} ms; apply_K_lame_plain {plain_ms:.4f} ms; "
                      f"element_energies_lame, two launches, {en_ms:.4f} ms")
    torch.cuda.empty_cache()


def ramp_material_model(pt):
    """RAMP interpolation (q = 4) with a density-dependent Poisson ratio:
    a law the one-field operator cannot express."""
    def model(rho):
        E = 1e-6 + rho / (1.0 + 4.0 * (1.0 - rho))
        return pt.lame_parameters(E, 0.25 + 0.1 * rho)
    return model


def run_main_lame(pt, ck, mg_res):
    """Phase 10.  Returns the launches of one run with the SIMP closure."""
    problem = cantilever(pt, (128, 128, 128))
    total = problem[0].total_volume
    base = main_mg_params(pt, iterations=5)
    lame = dataclasses.replace(
        base, material_model=pt.create_simp_material_model(1.0, 0.3, 1e-9,
                                                           3.0))
    # the process's first forward-mode derivative builds PyTorch's
    # decompositions for it, once: keep that out of the iterations' times
    t0 = time.perf_counter()
    rho = torch.full((2, 2, 2), 0.5, device="cuda")
    torch.func.jvp(lame.material_model, (rho,), (torch.ones_like(rho),))
    torch.cuda.synchronize()
    phase("main-lame", f"first torch.func.jvp of the process: "
          f"{time.perf_counter() - t0:.2f} s (once)")
    runs = {"default": [], "lame": []}
    for name in ("default", "lame", "lame", "default", "default", "lame"):
        runs[name].append(counted_run(
            pt, ck, problem, base if name == "default" else lame))
    fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"  # noqa
    for name, rs in runs.items():
        for res, launches, by_dtype in rs:
            phase("main-lame", f"128^3 float32 multigrid, {name}: "
                  f"seconds/iteration {fmt(res.iteration_seconds)} (sum "
                  f"{sum(res.iteration_seconds):.4f}), CG "
                  f"{res.cg_iterations_history}, launches {launches}, "
                  f"matvec by storage dtype "
                  f"{ {str(k)[6:]: v for k, v in by_dtype.items()} }")
    # a run's 5 iterations differ in CG count, so compare whole runs
    sums = {name: sorted(sum(res.iteration_seconds) for res, _, _ in rs)
            for name, rs in runs.items()}
    phase("main-lame", f"  seconds for the 5 iterations, three runs of each "
          f"in turns: default {fmt(sums['default'])}, lame "
          f"{fmt(sums['lame'])}; medians {sums['default'][1]:.4f} and "
          f"{sums['lame'][1]:.4f} "
          f"({100 * (sums['lame'][1] / sums['default'][1] - 1):+.1f}%), "
          f"least {sums['default'][0]:.4f} and {sums['lame'][0]:.4f} "
          f"({100 * (sums['lame'][0] / sums['default'][0] - 1):+.1f}%)")
    res, launches, by_dtype = runs["lame"][0]
    _, launches_d, by_dtype_d = runs["default"][0]
    vol_fracs = [v / total for v in res.volume_history]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(res.energy_history, mg_res.energy_history))
    cg = sum(res.cg_iterations_history)
    cg_d = sum(runs["default"][0][0].cg_iterations_history)
    phase("main-lame", f"  energy {res.energy_history}: max rel diff to "
          f"main-mg's first 5 {rel:.3e} (tol 5e-3), volume fraction "
          f"{vol_fracs}; float32 matvec launches per CG iteration "
          f"{by_dtype[torch.float32] / cg:.2f} against "
          f"{by_dtype_d[torch.float32] / cg_d:.2f} without the model")
    assert res.iterations == 5 and len(res.energy_history) == 5
    # 5e-3: this composition stops its solves at a relative residual of
    # 1e-3 (the first) to 1e-5, and the two runs' bfloat16 cycles round
    # differently, so their energies agree to about that 1e-3 and no
    # better (they were 2.0e-3 apart on an H100); the small run below
    # holds the closure to 5e-4 with every solve at 1e-5
    assert rel <= 5e-3
    assert all(abs(v - 0.3) <= 1e-4 for v in vol_fracs), vol_fracs
    for rs in runs.values():
        for r, _, _ in rs:
            assert all(c < 500 for c in r.cg_iterations_history)
            assert np.all(np.isfinite(r.densities))
    assert 1.5 * by_dtype_d[torch.float32] <= by_dtype[torch.float32] \
        <= 2.0 * by_dtype_d[torch.float32], (by_dtype, by_dtype_d)
    # two launches per iteration and two for the final element energies
    assert launches["voxel_energies"] == 2 * launches_d["voxel_energies"] \
        == 2 * (res.iterations + 1), (launches, launches_d)

    small = cantilever(pt, (24, 12, 12))
    tight = dataclasses.replace(base, max_iterations=3, cg_forcing="fixed",
                                cg_recycle_k=0)
    want = pt.simp_optimize(*small, tight)
    got = pt.simp_optimize(*small, dataclasses.replace(
        tight, material_model=lame.material_model))
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(got.energy_history, want.energy_history))
    ok = len(got.energy_history) == 3 and rel <= 5e-4
    phase("main-lame", f"  24x12x12 float32, bfloat16 cycle, every solve at "
          f"rtol 1e-5, with the SIMP closure against without: energy max "
          f"rel diff {rel:.3e} (tol 5e-4), CG {got.cg_iterations_history} "
          f"vs {want.cg_iterations_history} {'ok' if ok else 'FAIL'}")
    assert ok

    ramp = dataclasses.replace(main_mg_params(pt, iterations=3),
                               material_model=ramp_material_model(pt))
    res_r, launches_r, _ = counted_run(pt, ck, problem, ramp)
    phase("main-lame", f"RAMP law with nu(rho) = 0.25 + 0.1 rho: "
          f"seconds/iteration {fmt(res_r.iteration_seconds)}, CG "
          f"{res_r.cg_iterations_history}, energy {res_r.energy_history}, "
          f"launches {launches_r}")
    assert all(math.isfinite(e) for e in res_r.energy_history)
    assert res_r.energy_history == sorted(res_r.energy_history, reverse=True)
    assert all(c < 500 for c in res_r.cg_iterations_history)
    assert np.all(np.isfinite(res_r.densities))
    assert np.all(np.isfinite(res_r.stresses.von_mises))
    return launches


def run_continuation(pt, ck, mg_res):
    """Phase 11."""
    problem = cantilever(pt, (128, 128, 128))
    params = dataclasses.replace(main_mg_params(pt, iterations=3),
                                 continuation_levels=1,
                                 continuation_iters=10)
    t0 = time.perf_counter()
    res, launches, _ = counted_run(pt, ck, problem, params)
    wall = time.perf_counter() - t0
    vf = res.volume_history[0] / problem[0].total_volume
    fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"  # noqa
    phase("continuation", f"128^3 float32 from a 64^3 stage of 10 "
          f"iterations: volume fraction of the prolonged design {vf:.8f}, "
          f"fine seconds/iteration {fmt(res.iteration_seconds)}, CG "
          f"{res.cg_iterations_history}, energy {res.energy_history}; cold "
          f"main-mg iteration 1: {mg_res.iteration_seconds[0]:.4f} s, CG "
          f"{mg_res.cg_iterations_history[0]}, energy "
          f"{mg_res.energy_history[0]}; total {wall:.2f} s (coarse stage "
          f"and final analysis included), launches {launches}")
    assert res.iterations == 3
    assert abs(vf - 0.3) <= 1e-6, vf
    assert all(math.isfinite(e) for e in res.energy_history)
    assert all(c < 500 for c in res.cg_iterations_history)
    # the developed start is stiffer than the uniform one
    assert res.energy_history[0] < mg_res.energy_history[0]
    assert np.all(np.isfinite(res.densities))


def check_io(pt, ck, grid_mg, res_mg):
    """Phase 12."""
    from easysimp_tpu_torch.opt import checkpoint
    from easysimp_tpu_torch.post.vtu import read_vtu

    small = cantilever(pt, (24, 12, 12))

    def params(**kw):
        return pt.OptimizationParameters(
            E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
            filter_radius=1.5, dtype="float64", tolerance=1e-12,
            preconditioner="multigrid", mg_smooth_iters=(1, 2),
            cg_rtol=1e-10, cg_recycle_k=8, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        full = pt.simp_optimize(*small, params(max_iterations=6))
        path = os.path.join(tmp, "ckpt")
        pt.simp_optimize(*small, params(max_iterations=3,
                                        checkpoint_interval=3,
                                        checkpoint_path=path))
        resumed = pt.simp_optimize(*small, params(max_iterations=6),
                                   resume_from=path)
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(resumed.energy_history, full.energy_history))
        dens = float(np.abs(resumed.densities - full.densities).max())
        ok = (len(resumed.energy_history) == 6 and rel <= 1e-10
              and dens <= 1e-12 and len(resumed.iteration_seconds) == 3)
        phase("io", f"24x12x12 float64 multigrid, 8-slot ring: 3 iterations, "
              f"checkpoint, 3 resumed against 6 uninterrupted: energy max "
              f"rel diff {rel:.3e} (tol 1e-10), densities max abs diff "
              f"{dens:.3e} (tol 1e-12), CG {resumed.cg_iterations_history} "
              f"vs {full.cg_iterations_history} {'ok' if ok else 'FAIL'}")
        assert ok

        prof = os.path.join(tmp, "prof")
        pt.simp_optimize(*small, params(max_iterations=4, profile_dir=prof))
        traces = os.listdir(prof)
        size = os.path.getsize(os.path.join(prof, traces[0]))
        phase("io", f"profile_dir: {traces} {size} bytes")
        assert len(traces) == 1 and size > 0

        # 128^3: the main-mg result as a results VTU, and back
        t0 = time.perf_counter()
        out = pt.export_results_vtu(
            pt.create_results_data(grid_mg, res_mg),
            os.path.join(tmp, "main_mg"))
        vtu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = read_vtu(out)
        read_s = time.perf_counter() - t0
        phase("io", f"export_results_vtu 128^3 ({grid_mg.n_cells} cells, "
              f"{grid_mg.n_nodes} nodes): {vtu_s:.2f} s on the host, "
              f"{os.path.getsize(out)} bytes; read_vtu {read_s:.2f} s")
        assert np.array_equal(back.cell_data["density"], res_mg.densities)
        assert np.array_equal(
            back.point_data["displacement"].reshape(-1),
            res_mg.displacements)
        del back

        # 128^3: one checkpoint of the main-mg state (design, u, 5 power
        # vectors, 8-slot ring), as iteration 1 of the main path saves it
        seconds = []
        save = checkpoint.save_checkpoint

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            out = save(*a, **kw)
            seconds.append(time.perf_counter() - t0)
            return out

        checkpoint.save_checkpoint = timed_save
        try:
            path = os.path.join(tmp, "big")
            pt.simp_optimize(*cantilever(pt, (128, 128, 128)),
                             dataclasses.replace(
                                 main_mg_params(pt, iterations=1),
                                 checkpoint_interval=1,
                                 checkpoint_path=path))
        finally:
            checkpoint.save_checkpoint = save
        t0 = time.perf_counter()
        state = checkpoint.load_checkpoint(path)
        load_s = time.perf_counter() - t0
        phase("io", f"checkpoint 128^3 (float64 .npz, compressed): saved in "
              f"{seconds[0]:.2f} s, "
              f"{os.path.getsize(path + '.npz')} bytes, loaded in "
              f"{load_s:.2f} s; {len(state['pvecs'])} power vectors, ring "
              f"{state['recycle'].shape}")
        assert state["iteration"] == 1 and state["recycle"].shape[0] == 8
        assert state["design"].shape == (128, 128, 128)


# Trace groups for the kernels launched inside these ranges (the innermost
# matching range wins in this order), after the kernel-name groups.

def tet_cantilever(pt, nels):
    """The bench.py:262-281 problem: the cantilever on the 6-tets-per-voxel
    mesh of a grid of `nels`."""
    nx, ny, nz = nels
    mesh = pt.tet_mesh_from_grid(pt.generate_grid(
        nels, (0.0, 0.0, 0.0), tuple(float(n) for n in nels)))
    bc = pt.apply_fixed_boundary(
        mesh, pt.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    load = pt.PointLoad(
        pt.select_nodes_by_box(mesh, [nx, 0, 0], [nx, 0, nz], 1e-6),
        [0.0, -1.0, 0.0])
    return mesh, [load], [bc]


def unstructured_params(pt, iterations, dtype="float32", **kw):
    """The bench.py:252-277 composition."""
    kw = {"cg_rtol": 1e-5, "cg_rtol_max": 1e-3, **kw}
    return pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype=dtype, max_iterations=iterations,
        tolerance=1e-9, preconditioner="auto", cg_maxiter=2000,
        cg_recycle_k=8, cg_forcing="adaptive", amg_max_coarse_dofs=6000,
        amg_smooth_prolongator=False, **kw)


def check_unstructured_ops(pt, ck):
    """Phase 13: operator, filter and AMG on the card against the CPU."""
    from easysimp_tpu_torch.ops import filters
    from easysimp_tpu_torch.ops.amg import MultilevelAMG
    from easysimp_tpu_torch.ops.elements import element_stiffness_batch_np
    from easysimp_tpu_torch.ops.operator import UnstructuredOperator

    mesh, _, bcs = tet_cantilever(pt, (12, 6, 6))
    ke, vols = element_stiffness_batch_np(
        mesh.node_coords[mesh.connectivity], E=1.0, nu=0.3)
    mask_np = pt.build_free_mask(mesh, bcs)
    rng = np.random.default_rng(0)
    rho_np = rng.uniform(0.3, 1.0, mesh.n_cells)
    r_np = rng.standard_normal(mesh.n_dofs) * mask_np
    sens_np = -rng.uniform(0.0, 5.0, mesh.n_cells)
    radius = 1.5 * mesh.characteristic_element_size

    def outputs(dtype, device):
        dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        op = UnstructuredOperator(ke, mesh.connectivity, mesh.n_nodes,
                                  E0=1.0, Emin=1e-9, nu=0.3, p=3.0,
                                  dtype=dtype, device=device)
        filt = filters.UnstructuredFilter(mesh.cell_centers, vols, radius,
                                          dtype=dtype, device=device)
        amg = MultilevelAMG(op, mesh, mask_np, max_coarse_dofs=60)
        mask, rho, r, sens = dev(mask_np), dev(rho_np), dev(r_np), \
            dev(sens_np)
        scale = op.youngs_modulus(rho)
        A = lambda v: op.apply(v, scale, mask)  # noqa: E731
        Binv = op.block_diagonal_inverse(scale, mask)
        state = amg.setup(scale, mask, Binv, A)
        M = lambda v: amg.apply(v, A, Binv, state, mask)  # noqa: E731
        out = {
            "apply_K": op.apply_K(r, scale), "apply": A(r),
            "diagonal": op.diagonal(scale, mask),
            "block_diagonal_inverse": Binv,
            "block_jacobi": op.apply_block_jacobi(Binv, r),
            "energies": op.element_energies_unit(r),
            "sensitivities": op.compliance_sensitivities(r, rho),
            "sensitivity_filter": filt.sensitivity_filter(rho, sens),
            "density_filter": filt.density_filter(rho),
            "chain_rule": filt.chain_rule(sens),
            "amg level-1 blocks": state["blocks"][0],
            "amg fine l1 inverses": state["Binv0"],
            "amg coarsest factor": state["L"][0],
            "amg V-cycle": M(r),
        }
        same = None
        if device == "cuda":
            same = (torch.equal(A(r), A(r)), torch.equal(M(r), M(r)))
        return out, amg, filt.neighbor_route, same

    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        got, amg, route, (same_A, same_M) = outputs(dtype, "cuda")
        want = outputs(dtype, "cpu")[0]
        worst = 0.0
        for name in got:
            assert got[name].is_cuda and got[name].dtype == dtype
            rel = max_rel(got[name], want[name])
            worst = max(worst, rel)
            ok = rel <= tol and bool(torch.isfinite(got[name]).all())
            assert ok, f"{name} {dtype}: card vs CPU {rel:.3e} > {tol:g}"
        phase("unstructured-ops", f"12x6x6 tets ({mesh.n_cells} cells, "
              f"{mesh.n_dofs} dofs) {str(dtype)[6:]}: {len(got)} outputs "
              f"(operator, filter, AMG setup and V-cycle; levels "
              f"{[mesh.n_nodes] + amg.sizes} nodes) card vs CPU: worst "
              f"max_abs_err/max|out| {worst:.3e} (tol {tol:g}); two "
              f"applies bitwise equal: {same_A}, two V-cycles bitwise "
              f"equal: {same_M} ok")
        assert same_A and same_M
    phase("unstructured-ops", f"neighbour search route: {route}")


@contextlib.contextmanager
def patched_unstructured_step(captured, times=None):
    """simp_optimize builds its UnstructuredStep so that the host seconds
    of the build go to captured["build_s"] and the step object to
    captured["us"]; with `times`, every AMG setup and every CG solve is
    timed with the device synchronised on both sides (times["setup"],
    times["solve"])."""
    from easysimp_tpu_torch.opt import optimize_unstructured as ou

    build, solve = ou.build_unstructured_step, ou.cg_solve

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        us = build(*a, **kw)
        torch.cuda.synchronize()
        captured.update(us=us, build_s=time.perf_counter() - t0)
        if times is not None:
            us.amg.setup = timed(us.amg.setup, times["setup"])
        return us

    ou.build_unstructured_step = wrapped
    if times is not None:
        ou.cg_solve = timed(solve, times["solve"])
    try:
        yield
    finally:
        ou.build_unstructured_step, ou.cg_solve = build, solve


def replay_or_event_ms(fn):
    """(median device ms of fn, how): CUDA-graph replays where fn captures,
    else CUDA events around back-to-back calls."""
    try:
        return interleaved_ms([fn])[0], "CUDA-graph replays"
    except Exception as exc:  # noqa: BLE001
        torch.cuda.synchronize()
        phase("main-unstructured", f"  no graph capture "
              f"({type(exc).__name__}: {str(exc)[:120]}); event-timed")
        return interleaved_ms([fn], graph=False)[0], "CUDA events"


def run_main_unstructured(pt, ck, n=44, iterations=5):
    """Phase 14: the unstructured main path on the card, as a user runs
    it, then once more with a synchronising timer around each AMG setup and
    each CG solve."""
    nels = (n, n, n)
    mesh, loads, bcs = tet_cantilever(pt, nels)
    params = unstructured_params(pt, iterations)
    for fn in (ck.voxel_matvec, ck.voxel_energies):
        fn.launches = 0
    first, second = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched_unstructured_step(first):
        res = pt.simp_optimize(mesh, loads, bcs, params)  # device="cuda"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"voxel_matvec": ck.voxel_matvec.launches,
                "voxel_energies": ck.voxel_energies.launches}
    us = first["us"]
    assert us.device.type == "cuda" and us.dtype == torch.float32
    parts = us.build_seconds
    rest = first["build_s"] - sum(parts.values())
    amg = us.amg
    fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"  # noqa
    phase("main-unstructured", f"{n}^3 x 6 tets: {mesh.n_cells} cells, "
          f"{mesh.n_nodes} nodes, {mesh.n_dofs} dofs, float32; host build "
          f"{first['build_s']:.2f} s: AMG aggregation "
          f"{parts['amg_aggregation']:.2f}, prolongators "
          f"{parts['amg_prolongator']:.2f}, neighbour search and filter "
          f"table {parts['neighbor_search']:.2f}, element stiffnesses "
          f"(numpy float64) and incidence table {parts['elements']:.2f}, "
          f"AMG pair structures {parts['amg_structure']:.2f}, the rest "
          f"{rest:.2f}")
    phase("main-unstructured", f"  hierarchy: nodes per level "
          f"{[mesh.n_nodes] + amg.sizes}, block pairs per level "
          f"{[int(r.shape[0]) for r in amg.pair_rows]}, coarsest dense "
          f"{amg.nc} dofs, {len(amg.chunk_slices)} assembly chunks; node "
          f"valence table {tuple(us.op.node_slots.shape)}, filter table "
          f"{tuple(us.filt.neighbors.shape)}")

    t = {"setup": [], "solve": []}   # the final analysis is the last entry
    with patched_unstructured_step(second, t):
        timed_res = pt.simp_optimize(mesh, loads, bcs, params)
    vol_fracs = [v / us.total_volume for v in res.volume_history]
    phase("main-unstructured", f"  {res.iterations} iterations, "
          f"seconds/iteration {fmt(res.iteration_seconds)} (median "
          f"{float(np.median(res.iteration_seconds)):.4f}), CG "
          f"{res.cg_iterations_history}, total {wall:.2f} s (build and "
          f"final analysis included), peak memory {peak / 1e9:.3f} GB")
    phase("main-unstructured", f"  timed run (synchronised around each "
          f"call): AMG setup s {fmt(t['setup'])}, solve s "
          f"{fmt(t['solve'])} (the last of each is the final analysis), "
          f"seconds/iteration {fmt(timed_res.iteration_seconds)}, CG "
          f"{timed_res.cg_iterations_history}")
    phase("main-unstructured", f"  energy {res.energy_history}, volume "
          f"fraction {vol_fracs}, voxel kernel launches {launches}")

    # one operator apply, one V-cycle and one AMG setup on the final design
    op, mask = us.op, None
    dev = lambda a: torch.as_tensor(a, dtype=us.dtype, device="cuda")  # noqa
    mask = dev(pt.build_free_mask(mesh, bcs))
    scale = op.youngs_modulus(dev(res.densities))
    r = dev(np.random.default_rng(0).standard_normal(mesh.n_dofs)) * mask
    A = lambda v: op.apply(v, scale, mask)  # noqa: E731
    state = amg.setup(scale, mask)
    again = amg.setup(scale, mask)
    setup_rel = max(max_rel(a, b) for a, b in
                    zip(state["blocks"] + state["L"],
                        again["blocks"] + again["L"]))
    M = lambda v: amg.apply(v, A, None, state, mask)  # noqa: E731
    same = torch.equal(A(r), A(r)) and torch.equal(M(r), M(r))
    apply_ms, how_a = replay_or_event_ms(lambda: A(r))
    cycle_ms, how_m = replay_or_event_ms(lambda: M(r))
    # the apply by part: gather, batched element products, fixed-order sum
    ue, q = op.apply_elements(r)
    qs = q * scale[:, None]
    gather_ms, bmm_ms, sum_ms = interleaved_ms([
        lambda: r[op.dofmap],
        lambda: torch.bmm(op.ke, ue.unsqueeze(-1)),
        lambda: op.scatter_dofs(qs)])
    inv_ms, = interleaved_ms(
        [lambda: op.block_diagonal_inverse(scale, mask)], graph=False)
    setup_ms, = interleaved_ms([lambda: amg.setup(scale, mask)],
                               graph=False)
    nbytes = (op.ke.nbytes + op.dofmap.nbytes + scale.nbytes
              + 3 * r.nbytes)
    phase("main-unstructured", f"  device time on the final design: one "
          f"operator apply {apply_ms:.4f} ms ({how_a}; its bytes, "
          f"{nbytes / 1e6:.0f} MB of element matrices, dof map and "
          f"vectors, take {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"3.35 TB/s; by part: gather {gather_ms:.4f}, batched 12x12 "
          f"products (bmm) {bmm_ms:.4f}, fixed-order sum into the dofs "
          f"{sum_ms:.4f} ms), one V-cycle {cycle_ms:.4f} ms ({how_m}), one "
          f"AMG setup {setup_ms:.3f} ms and one batched 3x3 inversion of "
          f"{mesh.n_nodes} blocks with its assembly {inv_ms:.3f} ms (CUDA "
          f"events); applies and V-cycles bitwise equal on repeat: {same}; "
          f"two setups (index_add_ assemblies) differ by {setup_rel:.3e} "
          f"of max")
    assert same
    assert res.iterations == iterations
    for run in (res, timed_res):
        e = run.energy_history
        assert all(math.isfinite(x) for x in e) and math.isfinite(run.energy)
        assert all(b < a for a, b in zip(e, e[1:])), e
        assert all(c < params.cg_maxiter for c in run.cg_iterations_history)
    assert all(abs(v - 0.3) <= 1e-4 for v in vol_fracs), vol_fracs
    assert np.all(np.isfinite(res.densities))
    assert np.all(np.isfinite(res.displacements))
    assert res.densities.shape == (mesh.n_cells,)
    assert all(abs(a - b) <= 5e-3 * abs(b) for a, b in
               zip(timed_res.energy_history, res.energy_history))
    assert launches == {"voxel_matvec": 0, "voxel_energies": 0}, launches
    del state, again, first, second
    torch.cuda.empty_cache()
    # the same composition on smaller meshes: how the CG count grows with
    # the size (plain aggregation)
    for m in (16, 24, 32):
        small = pt.simp_optimize(*tet_cantilever(pt, (m, m, m)), params)
        phase("main-unstructured", f"  the same at {m}^3 x 6 tets "
              f"({6 * m ** 3} cells): CG {small.cg_iterations_history}, "
              f"seconds/iteration {fmt(small.iteration_seconds)}")
        assert all(c < params.cg_maxiter
                   for c in small.cg_iterations_history)
    return launches


def run_e2e_unstructured(pt, ck):
    """Phase 15: trajectories on 12x6x6 tets: float64 on the card against
    the CPU, float32 on the card against float64."""
    nels = (12, 6, 6)
    runs = {}
    for name, dtype, device, cg in [("float64 card", "float64", "cuda", 1e-8),
                                    ("float64 CPU", "float64", "cpu", 1e-8),
                                    ("float32 card", "float32", "cuda", 1e-5)]:
        params = unstructured_params(pt, 6, dtype=dtype, cg_rtol=cg,
                                     cg_rtol_max=cg)
        runs[name] = pt.simp_optimize(*tet_cantilever(pt, nels), params,
                                      device=device)
    base = runs["float64 card"]
    for name, rtol, counts in [("float64 CPU", 1e-8, True),
                               ("float32 card", 5e-3, False)]:
        other = runs[name]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(other.energy_history, base.energy_history))
        ok = len(other.energy_history) == len(base.energy_history) == 6 \
            and rel <= rtol and (not counts or other.cg_iterations_history
                                 == base.cg_iterations_history)
        phase("e2e-unstructured", f"{nels} tets AMG, float64 card vs "
              f"{name}: energy max rel diff {rel:.3e} (tol {rtol:g}), CG "
              f"{base.cg_iterations_history} vs "
              f"{other.cg_iterations_history}"
              f"{' (must be equal)' if counts else ''} "
              f"{'ok' if ok else 'FAIL'}")
        assert ok


# --------------------------------------------------------------------------
# Phase 16: sharded
# --------------------------------------------------------------------------

def shard_devices(n):
    """n shard devices: the visible cards round-robin (cuda:0 repeated when
    one card is visible), as strings for the printed lines."""
    from easysimp_tpu_torch.parallel.sharding import round_robin_cards

    return [str(d) for d in round_robin_cards(n)]


def grid_layout(pt, nels, shape):
    from easysimp_tpu_torch.parallel.sharding import GridLayout, make_mesh

    n = int(np.prod(shape))
    return GridLayout(make_mesh(n, shape=shape, devices=shard_devices(n)),
                      nels)


@contextlib.contextmanager
def recorded_shard_shapes(seen):
    """Record (kernel, u shape, dtype) of every kernel call the sharded
    operator makes (a checking harness: the calls and their launch counts
    are unchanged)."""
    from easysimp_tpu_torch.parallel import halo

    saved = halo.voxel_matvec, halo.voxel_energies

    def recorded(name, fn):
        def call(u, *a):
            seen.add((name, tuple(u.shape), u.dtype))
            return fn(u, *a)
        return call

    halo.voxel_matvec = recorded("voxel_matvec", saved[0])
    halo.voxel_energies = recorded("voxel_energies", saved[1])
    try:
        yield
    finally:
        halo.voxel_matvec, halo.voxel_energies = saved


@contextlib.contextmanager
def max_coarse_dofs(n):
    saved = os.environ.get("EASYSIMP_MAX_COARSE_DOFS")
    os.environ["EASYSIMP_MAX_COARSE_DOFS"] = str(n)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["EASYSIMP_MAX_COARSE_DOFS"]
        else:
            os.environ["EASYSIMP_MAX_COARSE_DOFS"] = saved


def sharded_vs_unsharded(pt, nels, dtype, shapes, tol_a, tol_m, step=None):
    """The masked matvec and M(r) over each mesh split against one device,
    both on the card; with `step`, also one SIMP step of those params."""
    from easysimp_tpu_torch.ops.multigrid import MultigridPreconditioner
    from easysimp_tpu_torch.opt.optimize import build_voxel_step
    from easysimp_tpu_torch.parallel.halo import HaloVoxelOperator
    from easysimp_tpu_torch.parallel.sharded_multigrid import (
        ShardedMultigrid,
    )
    from easysimp_tpu_torch.parallel.sharding import make_mesh

    kw = dict(smooth_iters=(1, 2))
    op, mask, scale, r = mg_problem(pt, nels, dtype, "cuda")
    want_a = op.apply(r, scale, mask)
    mg = MultigridPreconditioner(op, **kw)
    state, _ = mg.setup(scale, mask)
    want_m = mg.make_M(state)(r)
    if step is not None:
        vs = build_voxel_step(*cantilever(pt, nels), step)
        st, _ = vs.setup(vs.design0, vs.power_init(vs.design0))
        want_step = vs.step(vs.design0, vs.u0, st)
    for shape in shapes:
        L = grid_layout(pt, nels, shape)
        h = HaloVoxelOperator(op, L)
        smg = ShardedMultigrid(h, **kw)
        S, M, R = (L.split(scale, "cell"), L.split(mask, "node"),
                   L.split(r, "node"))
        err_a = max_rel(L.gather(h.apply(R, S, M)), want_a)
        sstate, _ = smg.setup(S, M)
        err_m = max_rel(L.gather(smg.make_M(sstate)(R)), want_m)
        ok = err_a <= tol_a and err_m <= tol_m
        msg = (f"{nels} {str(dtype)[6:]} mesh {shape}: matvec "
               f"{err_a:.3e} (tol {tol_a:g}), M(r) {err_m:.3e} (tol "
               f"{tol_m:g}) of max|out|, levels {smg.n_levels}, distributed "
               f"{smg.n_distributed}")
        if step is not None:
            vs = build_voxel_step(*cantilever(pt, nels), step,
                                  mesh=make_mesh(L.n_shards, shape=shape,
                                                 devices=L.devices))
            st, _ = vs.setup(vs.design0, vs.power_init(vs.design0))
            out = vs.step(vs.design0, vs.u0, st)
            errs = [abs(float(out.energy) / float(want_step.energy) - 1),
                    max_rel(vs.gather(out.new_design), want_step.new_design),
                    max_rel(vs.gather(out.u), want_step.u)]
            ok = ok and max(errs) <= tol_m \
                and out.cg_iters == want_step.cg_iters
            msg += (f"; one SIMP step: energy, design, u {errs[0]:.3e} / "
                    f"{errs[1]:.3e} / {errs[2]:.3e} (tol {tol_m:g}), CG "
                    f"{out.cg_iters} vs {want_step.cg_iters} (must be equal)")
        phase("sharded", f"{msg} {'ok' if ok else 'FAIL'}")
        assert ok
    del state, want_m, want_a
    torch.cuda.empty_cache()


def check_shard_kernels(pt, ck, seen):
    """(a) Each kernel against its plain version at every shard-local shape
    the sharded runs gave it."""
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    tol = {torch.float64: ("rtol/atol", 1e-12, 1e-11),
           torch.float32: ("of max|out|", 1e-5, 1e-5),
           torch.bfloat16: ("of max|out|", 5e-2, 5e-2)}
    for name, shape, dtype in sorted(seen, key=str):
        nels = tuple(s - 1 for s in shape[:3])
        grid = pt.generate_grid(nels, (0.0, 0.0, 0.0), (1.6, 1.1, 0.9))
        gen = torch.Generator(device="cuda").manual_seed(1)
        op = VoxelOperator(grid, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                           dtype=dtype, device="cuda")
        u = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device="cuda").to(dtype)
        scale = op.youngs_modulus(0.05 + 0.95 * torch.rand(
            nels, generator=gen, dtype=torch.float64, device="cuda")).to(dtype)
        kind, t_mv, t_en = tol[dtype]
        if name == "voxel_matvec":
            got = ck.voxel_matvec(u, scale, op.ke)
            want, t = ck.voxel_matvec_plain(u, scale, op.ke), t_mv
        else:
            got = ck.voxel_energies(u, op.ke)
            want, t = ck.voxel_energies_plain(u, op.ke), t_en
        ok, err, ref = agree(got, want, kind, t)
        phase("sharded", f"(a) {name} shard block {shape[:3]} nodes "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} (max|out| "
              f"{ref:.3e}, tol {t:g} {kind}) {'ok' if ok else 'FAIL'}")
        assert ok, f"{name} disagrees with its plain version at {shape}"


def run_main_sharded(pt, ck, mg_res):
    """(c) The main-mg composition at 128^3 over (4,1,1) and (2,2,2)."""
    from easysimp_tpu_torch.parallel import halo
    from easysimp_tpu_torch.parallel.sharding import make_mesh

    grid, loads, bcs = cantilever(pt, (128, 128, 128))
    params = main_mg_params(pt, iterations=5)
    ref_e = mg_res.energy_history[:5]
    ref_cg = mg_res.cg_iterations_history[:5]
    ref_s = float(np.median(mg_res.iteration_seconds[:5]))
    launches = {"voxel_matvec": 0, "voxel_energies": 0}
    for shape in [(4, 1, 1), (2, 2, 2)]:
        n = int(np.prod(shape))
        captured = {}

        def wrap(vs):
            captured["vs"] = vs
            return vs

        mesh = make_mesh(n, shape=shape, devices=shard_devices(n))
        for fn in (ck.voxel_matvec, ck.voxel_energies):
            fn.launches = 0
        c0, b0 = halo.extend.copies, halo.extend.bytes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched_voxel_step(wrap):
            res = pt.simp_optimize(grid, loads, bcs, params, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        run = {"voxel_matvec": ck.voxel_matvec.launches,
               "voxel_energies": ck.voxel_energies.launches}
        copies, nbytes = halo.extend.copies - c0, halo.extend.bytes - b0
        for k in launches:
            launches[k] += run[k]
        cg = sum(res.cg_iterations_history)
        mg = captured["vs"].precond
        dist = [mg.ops[lvl].grid.nels for lvl in range(mg.n_distributed)]
        # the coarse-level gather: one level-(n_distributed - 1) residual
        # onto the first device (CUDA events, median of 20)
        lay = mg.layouts[-1]
        f = lay.split(torch.ones((*(n + 1 for n in lay.nels), 3),
                                 dtype=torch.bfloat16, device="cuda"), "node")
        gather_ms = float(np.median(cuda_times(lambda: lay.gather(f),
                                               runs=20, graph=False)))
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(res.energy_history, ref_e))
        ok = (len(res.energy_history) == 5 and rel <= 5e-3 and all(
            abs(a - b) <= 2 for a, b in zip(res.cg_iterations_history,
                                            ref_cg))
              and all(v > 0 for v in run.values()))
        fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"  # noqa
        phase("sharded", f"(c) main-sharded mesh {shape} on "
              f"{[str(d) for d in mesh.devices.flat]}: seconds/iteration "
              f"{fmt(res.iteration_seconds)} (median "
              f"{float(np.median(res.iteration_seconds)):.4f}; main-mg "
              f"{ref_s:.4f}), CG {res.cg_iterations_history} vs main-mg "
              f"{ref_cg} (within 2), energy max rel diff {rel:.3e} (tol "
              f"5e-3) {'ok' if ok else 'FAIL'}")
        phase("sharded", f"    launches {run} ({sum(run.values()) / cg:.1f} "
              f"per CG iteration of the run, {cg} CG iterations), halo "
              f"copies {copies / cg:.1f} and {nbytes / cg / 1e6:.2f} MB per "
              f"CG iteration of the run, distributed levels {dist} of "
              f"{mg.n_levels}, coarse gather (level {mg.n_distributed - 1}, "
              f"{tuple(n + 1 for n in lay.nels)} nodes bf16) {gather_ms:.4f} "
              f"ms, peak memory {peak / 1e9:.3f} GB, total {wall:.2f} s")
        assert ok
        del res, captured, f
        torch.cuda.empty_cache()
    return launches


def run_sharded_twins(pt, ck):
    """(d) The dry-run twin on the card, and the element-sharded
    unstructured path against the unsharded card run."""
    from easysimp_tpu_torch.dryrun import dryrun_multichip
    from easysimp_tpu_torch.parallel.sharding import make_element_mesh

    from easysimp_tpu_torch import dryrun

    results = dryrun_multichip(8)   # the cards, round-robin
    one = dryrun._one_step(dryrun._build((16, 8, 8), max_cg=50))
    e1 = float(one.energy)
    # against the unsharded step on the card (rtol 1e-6, equal CG) and
    # against the JAX package's record (rtol 1e-4: float32 solves stopped at
    # rtol 1e-6, rounded by the card's 3xTF32 kernels, not XLA's CPU)
    ok = all(abs(e - e1) <= 1e-6 * e1 and cg == one.cg_iters == 11
             and abs(e - 4.009019e+01) <= 1e-4 * 4.009019e+01
             for _, e, cg in results[:3]) and \
        abs(results[3][1] - 8.712991e+01) <= 1e-4 * 8.712991e+01
    phase("sharded", f"(d) dry-run twin on {shard_devices(8)}: {results}; "
          f"unsharded on the card {e1:.6e} CG {one.cg_iters} (rtol 1e-6, "
          f"equal CG); MULTICHIP_r05.json 4.009019e+01 with CG 11 per "
          f"split, 8.712991e+01 (rtol 1e-4) {'ok' if ok else 'FAIL'}")
    assert ok
    nels = (16, 16, 16)
    params = unstructured_params(pt, 3, dtype="float64", cg_rtol=1e-8,
                                 cg_rtol_max=1e-8)
    mesh, loads, bcs = tet_cantilever(pt, nels)
    one = pt.simp_optimize(mesh, loads, bcs, params)
    emesh = make_element_mesh(mesh.n_cells, 4, devices=shard_devices(4))
    four = pt.simp_optimize(mesh, loads, bcs, params, mesh=emesh)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(four.energy_history, one.energy_history))
    ok = rel <= 1e-9 and four.cg_iterations_history == \
        one.cg_iterations_history
    phase("sharded", f"(d) element-sharded {nels} x 6 tets "
          f"({mesh.n_cells} cells) on {emesh.size} shards vs one device, "
          f"float64: energy max rel diff {rel:.3e} (tol 1e-9), CG "
          f"{four.cg_iterations_history} vs {one.cg_iterations_history} "
          f"(must be equal) {'ok' if ok else 'FAIL'}")
    assert ok


def run_sharded(pt, ck, mg_res):
    """Phase 16.  Returns the kernels' launches in the main-sharded runs."""
    t0 = time.perf_counter()
    phase("sharded", f"{torch.cuda.device_count()} card(s) visible: shards "
          f"on {shard_devices(8)}")
    seen = set()
    with recorded_shard_shapes(seen):
        # (b) sharded against unsharded, both on the card; a coarse level
        # distributed at 24x12x12 (coarsest 6x3x3)
        with max_coarse_dofs(500):
            step = pt.OptimizationParameters(
                E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
                filter_radius=1.5, dtype="float64", cg_rtol=1e-10,
                preconditioner="multigrid", mg_smooth_iters=(1, 2))
            sharded_vs_unsharded(pt, (24, 12, 12), torch.float64,
                                 [(4, 1, 1), (2, 2, 1), (2, 2, 2)], 1e-12,
                                 1e-10, step=step)
        # float32 M(r): 5e-5, about 3x the 1.75e-5 read on an H100, not
        # 1e-5.  The two hierarchies are the same math (float64 below:
        # 1e-10), but the float32 stencils of levels 2-3 differ by ~1e-6 and
        # the coarsest float32 Cholesky amplifies that
        # (scripts/sharded_mg_drift.py prints the split)
        sharded_vs_unsharded(pt, (128, 128, 128), torch.float32,
                             [(4, 1, 1)], 1e-5, 5e-5)
        sharded_vs_unsharded(pt, (128, 128, 128), torch.float64,
                             [(4, 1, 1)], 1e-12, 1e-10)
        # a one-cell-thick shard: 8x4x4 over (8, 1, 1)
        sharded_vs_unsharded(pt, (8, 4, 4), torch.float64, [(8, 1, 1)],
                             1e-12, 1e-10)
        launches = run_main_sharded(pt, ck, mg_res)
    check_shard_kernels(pt, ck, seen)
    run_sharded_twins(pt, ck)
    phase("sharded", f"phase took {time.perf_counter() - t0:.1f} s")
    return launches


MG_RANGES = [("mg:setup", "im2col and setup"),
             ("mg:dense_solve", "dense solve"),
             ("mg:transfer", "transfers"),
             ("mg:stencil", "stencil apply")]


@contextlib.contextmanager
def annotated_multigrid():
    """Profiler ranges around the multigrid's stencil applies, transfers
    and coarsest solves (a tracing harness only)."""
    from torch.profiler import record_function

    from easysimp_tpu_torch.ops import multigrid as mgm

    def ranged(fn, label):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call

    cls = mgm.MultigridPreconditioner
    saved = (mgm.apply_stencil, mgm.prolong, mgm.restrict,
             cls.__dict__["_cholesky_solve"])
    mgm.apply_stencil = ranged(saved[0], "mg:stencil")
    mgm.prolong = ranged(saved[1], "mg:transfer")
    mgm.restrict = ranged(saved[2], "mg:transfer")
    cls._cholesky_solve = staticmethod(ranged(saved[3].__func__,
                                              "mg:dense_solve"))
    try:
        yield
    finally:
        mgm.apply_stencil, mgm.prolong, mgm.restrict = saved[:3]
        cls._cholesky_solve = saved[3]


def trace_groups(path):
    """Device time by group from an exported chrome trace: each kernel is
    tied to its launch (by correlation id) and grouped by its name or by
    the profiler ranges around its launch."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch_at, ranges, kernels = {}, [], []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_at[args["correlation"]] = (e["ts"], e.get("tid"))
        elif cat == "user_annotation" and e["name"].startswith("mg:"):
            ranges.append((e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"),
                           e["name"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append(e)
    groups = collections.Counter()
    for k in kernels:
        name, dur = k["name"], k.get("dur", 0)
        ts, tid = launch_at.get(k.get("args", {}).get("correlation"),
                                (None, None))
        inside = {label for a, b, t, label in ranges
                  if ts is not None and t == tid and a <= ts <= b}
        low = name.lower()
        if "voxel_matvec" in name:
            key = ("voxel_matvec bf16" if "bfloat16" in low
                   else "voxel_matvec fp32")
        elif "voxel_energies" in name:
            key = "voxel_energies"
        else:
            key = next((g for label, g in MG_RANGES if label in inside), None)
        if key is None:
            key = ("dots and reductions" if any(
                       w in low for w in ("dot", "reduce", "gemv"))
                   else "PyTorch elementwise" if "elementwise" in low
                   else "other")
        groups[key] += dur
    return groups


def trace_main_path(pt, ck, iteration, out_dir):
    """The multigrid main path with `torch.profiler` on one SIMP iteration
    (its setup and its step): device time by group and the device's idle
    share in that iteration.  The chrome trace goes to `out_dir`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    window = {}

    def wrap(vs):
        steps = [0]
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

        def begin():
            if steps[0] == iteration - 1 and "prof" not in window:
                torch.cuda.synchronize()
                prof.__enter__()
                window.update(prof=prof, t0=time.perf_counter())

        def setup(*a, **kw):
            begin()
            with record_function("mg:setup"):
                return vs.setup(*a, **kw)

        def step(*a, **kw):
            begin()
            out = vs.step(*a, **kw)
            steps[0] += 1
            if steps[0] == iteration:
                torch.cuda.synchronize()
                window.update(wall=time.perf_counter() - window["t0"],
                              cg=out.cg_iters)
                prof.__exit__(None, None, None)
            return out
        return dataclasses.replace(vs, setup=setup, step=step)

    grid, loads, bcs = cantilever(pt, (128, 128, 128))
    with patched_voxel_step(wrap), annotated_multigrid():
        pt.simp_optimize(grid, loads, bcs,
                         main_mg_params(pt, iterations=iteration))
    prof = window["prof"]
    # device events, without the device-side spans of the profiler ranges
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not e.name.startswith("mg:")]
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
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace_mg_iteration{iteration}.json"
    prof.export_chrome_trace(str(path))
    groups = trace_groups(path)
    wall_ms, busy_ms = window["wall"] * 1e3, busy_us / 1e3
    phase("trace", f"multigrid iteration {iteration} (setup and step): CG "
          f"{window['cg']}, wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {len(kernels)} device "
          f"events")
    total = sum(groups.values())
    for key, t in groups.most_common():
        phase("trace", f"  {key}: {t / 1e3:.2f} ms, "
              f"{100 * t / total:.1f}% of kernel time")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        phase("trace", f"  {t / 1e3:8.2f} ms {n:6d} x  {name[:110]}")
    phase("trace", f"chrome trace: {path}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", type=int, metavar="ITERATION",
                        help="run only the multigrid main path, profiling "
                             "this SIMP iteration")
    parser.add_argument("--trace-dir", type=Path, default=Path("traces"),
                        help="where --trace writes its chrome trace "
                             "(default: traces/)")
    args = parser.parse_args()
    t_start = time.perf_counter()
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
        run_main_path(pt, ck)
        check_multigrid(pt, ck)
        launches, grid_mg, res_mg = run_main_mg(pt, ck)
        run_e2e_check(pt, ck)
        check_lame(pt, ck)
        launches_lame = run_main_lame(pt, ck, res_mg)
        run_continuation(pt, ck, res_mg)
        check_io(pt, ck, grid_mg, res_mg)
        check_unstructured_ops(pt, ck)
        launches_un = run_main_unstructured(pt, ck)
        run_e2e_unstructured(pt, ck)
        launches_sh = run_sharded(pt, ck, res_mg)
        kernels = [{
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_lame": launches_lame[name],
            "launches_unstructured": launches_un[name],
            "launches_sharded": launches_sh[name], **timing[name],
        } for name in ("voxel_matvec", "voxel_energies")]
        print(json.dumps({"kernels": kernels}), flush=True)
        phase("total", f"chip_smoke.py took "
              f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
