"""Where the time of the float32 voxel kernels goes, on one NVIDIA GPU.

    python3 scripts/voxel_kernel_probe.py

Builds variants of easysimp_tpu_torch/csrc/voxel_kernels.cu with nvcc (in
parallel, into easysimp_tpu_torch/_build/probe/) and times, at 128^3 float32
with CUDA graphs of 10 launches (median of 20 replays):

  base          the kernels as the package builds them;
  no_products   the element products (A loads, 3xTF32 split, wgmma)
                replaced by zeros: what staging, copies, scaling and sums
                cost alone;
  no_staging    no cp.async and no plane copies (the products read stale
                shared memory): what the loads cost;
  timed         base with each block's start and end (%globaltimer) and SM
                recorded: block durations and how many blocks share an SM.

It also times the first float32 energies design, one thread per element
on the CUDA cores, which the package no longer launches for float32, and
measures the rate of wgmma m64n24k8 TF32 with A in registers and B in
shared memory, as the kernels issue it (four independent accumulators per
warpgroup): the card's ceiling for the kernels' products.
Only `base` is checked against the plain version (1e-5 of max|out|); the
other variants compute wrong values on purpose.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import collections
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "easysimp_tpu_torch/csrc/voxel_kernels.cu"
BUILD = ROOT / "easysimp_tpu_torch/_build/probe"
N = 128

PRODUCTS = "issue_products<T>(acc, a, smem, pa, smem);"
ZEROS = ("for (int r_ = 0; r_ < kRows; ++r_) for (int n_ = 0; n_ < 3; ++n_) "
         "for (int i_ = 0; i_ < 4; ++i_) acc[r_][n_][i_] = a[r_][n_][i_] = "
         "(float)pa[n_][i_ & 1];")
STAGE = "auto stage = [&](int k) {"
COPY = "auto copy = [&](int k) {"
SMEM = "  extern __shared__ __align__(16) unsigned char smem[];\n"
MV_END = ("  }\n}\n\ntemplate <typename T>\n__global__ void "
          "__launch_bounds__(kTC, 2)\nvoxel_energies_tc")
EN_END = "  }\n}\n\n// " + "-" * 75 + "\n// 2. Simple kernels"
CLOCK = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));'


def record(kind):
    return ("  if (threadIdx.x == 0) { unsigned long long t1_; "
            + CLOCK.format("t1_") + " unsigned sm_; "
            'asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_)); '
            "const unsigned b_ = blockIdx.x + gridDim.x * blockIdx.y; "
            f"if (b_ < 8192) {{ g_blocks[{kind}][b_][0] = t0_; "
            f"g_blocks[{kind}][b_][1] = t1_; g_blocks[{kind}][b_][2] = sm_; "
            "} }\n")


VARIANTS = {
    "base": [],
    "no_products": [(PRODUCTS, ZEROS)],
    "no_staging": [(STAGE, STAGE + " if (nx > 0) return;"),
                   (COPY, COPY + " if (nx > 0) return;")],
    "timed": [(SMEM, SMEM + "  unsigned long long t0_; "
               + CLOCK.format("t0_") + "\n"),
              (MV_END, "  }\n" + record(0) + MV_END[4:]),
              (EN_END, "  }\n" + record(1) + EN_END[4:]),
              ("namespace {\n", "namespace {\n__device__ unsigned long long "
               "g_blocks[2][8192][3];\n")],
}
EXTRA = r'''
extern "C" int probe_energies_simple_f32(const void* u, const void* ke,
                                         void* out, int nx, int ny, int nz,
                                         void* stream) {
  return launch_energies_simple<float, float>(u, ke, out, nx, ny, nz, stream);
}
__global__ void probe_mma_kernel(float* out, int iters) {
  __shared__ __align__(128) unsigned char tile[KE_TILE];
  for (int i = threadIdx.x; i < KE_TILE / 4; i += blockDim.x)
    reinterpret_cast<float*>(tile)[i] = 1.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[4][3][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const uint64_t b = ke_desc(tile);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_tf32(acc[j], a, b);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int j = 0; j < 4; ++j)
    for (int k = 0; k < 12; ++k) s += acc[j][k / 4][k % 4];
  if (s == 12345.f) out[threadIdx.x] = s;
}
extern "C" int probe_mma(void* out, int blocks, int iters, void* stream) {
  probe_mma_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out,
                                                            iters);
  return (int)cudaGetLastError();
}
'''
READ_BLOCKS = r'''
extern "C" int probe_read_blocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_blocks, sizeof(g_blocks));
}
'''


def build():
    """{variant: ctypes library}, all variants compiled at once."""
    src = SOURCE.read_text()
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = Path("/usr/local/cuda/bin/nvcc")
    nvcc = str(nvcc) if nvcc.exists() else "nvcc"
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) >= 1, f"{name}: anchor {old!r} not found"
            text = text.replace(old, new)
        text += EXTRA + (READ_BLOCKS if name == "timed" else "")
        cu, so = BUILD / f"{name}.cu", BUILD / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.voxel_matvec_f32.argtypes = [p, p, p, p, i, i, i, p]
        lib.voxel_energies_f32.argtypes = [p, p, p, i, i, i, p]
        lib.probe_mma.argtypes = [p, i, i, p]
        lib.probe_energies_simple_f32.argtypes = [p, p, p, i, i, i, p]
        libs[name] = lib
    return libs


def graph_ms(call, calls=10, replays=20):
    """Device ms of one call: a CUDA graph of `calls` calls, replayed."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("voxel_kernel_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.ops import cuda_kernels as ck
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    libs = build()
    grid = pt.generate_grid((N, N, N), (0.0, 0.0, 0.0), (1.6, 1.1, 0.9))
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((N + 1, N + 1, N + 1, 3), generator=gen,
                    dtype=torch.float64, device="cuda").float()
    rho = 0.05 + 0.95 * torch.rand((N, N, N), generator=gen,
                                   dtype=torch.float64, device="cuda")
    op = VoxelOperator(grid, E0=3.0, Emin=1e-9, nu=0.3, p=3.0,
                       dtype=torch.float32, device="cuda")
    scale = op.youngs_modulus(rho).float()
    mv_out, en_out = torch.empty_like(u), torch.empty_like(scale)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def calls(lib):
        def mv():
            assert lib.voxel_matvec_f32(u.data_ptr(), scale.data_ptr(),
                                        op.ke.data_ptr(), mv_out.data_ptr(),
                                        N, N, N, stream()) == 0

        def en():
            assert lib.voxel_energies_f32(u.data_ptr(), op.ke.data_ptr(),
                                          en_out.data_ptr(), N, N, N,
                                          stream()) == 0
        return mv, en

    for name, lib in libs.items():
        mv, en = calls(lib)
        if name == "base":
            mv()
            en()
            for got, want in ((mv_out, ck.voxel_matvec_plain(u, scale, op.ke)),
                              (en_out, ck.voxel_energies_plain(u, op.ke))):
                assert float((got - want).abs().max()) <= \
                    1e-5 * float(want.abs().max())
        print(f"[probe] {name:12s} matvec {graph_ms(mv) * 1e3:7.1f} us  "
              f"energies {graph_ms(en) * 1e3:7.1f} us", flush=True)

    lib = libs["timed"]
    lib.probe_read_blocks.argtypes = [ctypes.c_void_p]
    for kind, call in enumerate(calls(lib)):
        call()
        torch.cuda.synchronize()
        rec = np.zeros((2, 8192, 3), dtype=np.uint64)
        assert lib.probe_read_blocks(rec.ctypes.data) == 0
        rec = rec[kind][rec[kind][:, 1] > 0].astype(np.int64)
        start, end = rec[:, 0] - rec[:, 0].min(), rec[:, 1] - rec[:, 0].min()
        per_sm = collections.Counter(rec[:, 2].tolist())
        alone = [e - s for s, e, sm in zip(start, end, rec[:, 2])
                 if per_sm[sm] == 1]
        print(f"[blocks] {('matvec', 'energies')[kind]}: {len(rec)} blocks, "
              f"{min(per_sm.values())}..{max(per_sm.values())} per SM, span "
              f"{end.max() / 1e3:.1f} us, block duration median "
              f"{np.median(end - start) / 1e3:.1f} us (alone on its SM: "
              f"{np.median(alone) / 1e3 if alone else float('nan'):.1f} us)",
              flush=True)

    base = libs["base"]

    def simple_energies():
        assert base.probe_energies_simple_f32(
            u.data_ptr(), op.ke.data_ptr(), en_out.data_ptr(), N, N, N,
            stream()) == 0
    simple_energies()
    want = ck.voxel_energies_plain(u, op.ke)
    assert float((en_out - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    print(f"[probe] first float32 energies design (CUDA cores): "
          f"{graph_ms(simple_energies) * 1e3:.1f} us", flush=True)
    for blocks in (132, 264, 1056):
        iters = 2000

        def mma():
            assert base.probe_mma(mv_out.data_ptr(), blocks, iters,
                                  stream()) == 0
        ms = graph_ms(mma, calls=1, replays=5)
        n = blocks * 2 * 4 * iters  # wgmma, 2 warpgroups a block
        print(f"[mma] wgmma m64n24k8 tf32, {blocks} blocks of 8 warps: "
              f"{n * 64 * 24 * 8 * 2 / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
