// Hand-written Hopper kernel for the multigrid's masked stencil apply.
//
//   y(n)_i   = sum_o sum_j C[o][i][j](n) * (m * x)(n + o)_j
//   out(n)_i = m(n)_i * y(n)_i                  (plain form)
//   out(n)_i = r(n)_i - m(n)_i * y(n)_i         (residual form, r given)
//
// over the 27 offsets o in {-1, 0, 1}^3 of an (nnx, nny, nnz) node grid;
// terms outside the grid are zero.  C is a level's Galerkin stencil in the
// coefficient-major layout of ops/stencil.py, (243, nodes): row
// (o, i, j) = ((ox + 1) * 9 + (oy + 1) * 3 + oz + 1) * 9 + 3 i + j, nodes
// flattened with z fastest.  x, m (the 0/1 dof mask), r and out are node
// fields (nodes, 3).
//
// It replaces no Pallas kernel: the JAX package leaves this apply to XLA
// (easysimp_tpu/ops/stencil.py apply_stencil, 243 multiply-adds that XLA
// fuses into one pass).  The port ran it as a strided unfold view of the
// padded field times C and a sum over the taps, around a pad, a copy and
// two mask products: a transient the size of C written and read back, ~7
// launches, 8-18% of the card's bandwidth.
//
// What bounds it on an H100.  Per node it reads 243 coefficients and does
// 243 FMAs, ~0.5 flop per byte in float32: far under the card's balance,
// so the bytes of C bind.  The level-1 stencil of the 256x128x128 MBB beam
// (129 x 65 x 65 nodes, float32) is 529.8 MB, 0.16 ms at 3.35 TB/s; the
// field, the mask and the output are 1/81 of C each.
//
// What the design does about it.
// - Three threads per node, one per output row i, kNodes consecutive nodes
//   (flattened) per block: warp w of row i reads, for each of its 81
//   coefficient planes (o, i, j), 32 consecutive values, fully coalesced,
//   and each plane is read once.  The plane stride (the node count) is odd
//   at every level, so the planes are not 16-byte aligned and the loads
//   are scalar; they are independent and unrolled.  A thread per row, not
//   per node, keeps few registers per thread and so many threads and loads
//   in flight, and makes the last partial wave of a launch a third as long
//   (at the cantilever's level 1, 274,625 nodes fill an H100 about twice).
// - The field is small and read 27 times per node.  A block's neighbours
//   lie in 9 contiguous runs of the flattened field, one per (x, y)
//   offset, each kNodes + 2 nodes long.  The block stages the runs once in
//   shared memory with coalesced loads, masked and rounded to the
//   stencil's type, and each thread reads its 81 values from there
//   (stride 3 words: no bank conflicts).  Whether a neighbour lies in the
//   grid is decided from the node's coordinates, so a run's wrap from one
//   row or plane into the next is never used.
// - Sums are FMAs on the CUDA cores, fp32 for float32 and bfloat16
//   stencils, fp64 for float64, over the taps and then j in a fixed
//   order.  Each thread owns one output, so there are no atomics and the
//   result is bitwise equal from launch to launch.
// - The rounding points are the plain version's: m x in the field's type,
//   then rounded to the stencil's; the sum rounded to the stencil's type,
//   then to the field's; the mask product and r - y in the field's type.
//   Only the products are kept in fp32 where the plain bfloat16 version
//   rounds each to bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kNodes = 128;            // nodes per block, 3 threads each
constexpr int kRunVals = 3 * (kNodes + 2);  // values of one staged run

// Storage type T, compute type C: bf16 computes in fp32.
template <typename T> struct Num;
template <> struct Num<double> {
  using C = double;
  __device__ static C in(double x) { return x; }
  __device__ static double out(C x) { return x; }
};
template <> struct Num<float> {
  using C = float;
  __device__ static C in(float x) { return x; }
  __device__ static float out(C x) { return x; }
};
template <> struct Num<__nv_bfloat16> {
  using C = float;
  __device__ static C in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(C x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// A value of storage type From as storage type To, rounded as PyTorch's
// cast rounds it (through the compute types: double -> float -> bf16).
template <typename To, typename From>
__device__ __forceinline__ To convert(From v) {
  return Num<To>::out(static_cast<typename Num<To>::C>(Num<From>::in(v)));
}

template <typename TS, typename TF>
__global__ void __launch_bounds__(3 * kNodes, 4)
    stencil_apply_kernel(const TS* __restrict__ C, const TF* __restrict__ mask,
                         const TF* __restrict__ x, const TF* __restrict__ r,
                         TF* __restrict__ out, int nnx, int nny, int nnz) {
  using A = typename Num<TS>::C;   // accumulation
  using F = typename Num<TF>::C;   // the field's arithmetic
  __shared__ A xs[9 * kRunVals];
  const long long N = (long long)nnx * nny * nnz;
  const long long plane = (long long)nny * nnz;
  const long long n0 = (long long)blockIdx.x * kNodes;

  // 1. The 9 runs of m x, run (ox + 1) * 3 + oy + 1 from node
  // n0 + ox * plane + oy * nnz - 1; zero outside [0, N).
  for (int e = threadIdx.x; e < 9 * kRunVals; e += 3 * kNodes) {
    const int run = e / kRunVals;
    const long long g =
        3 * (n0 + (run / 3 - 1) * plane + (run % 3 - 1) * (long long)nnz - 1) +
        (e - run * kRunVals);
    A v = A(0);
    if (g >= 0 && g < 3 * N) {
      const TF mx = Num<TF>::out(Num<TF>::in(mask[g]) * Num<TF>::in(x[g]));
      v = Num<TS>::in(convert<TS>(mx));
    }
    xs[e] = v;
  }
  __syncthreads();

  const int t = threadIdx.x % kNodes;   // the node in the block
  const int i = threadIdx.x / kNodes;   // the output row
  const long long n = n0 + t;
  if (n >= N) return;
  const int iz = (int)(n % nnz);
  const int iy = (int)((n / nnz) % nny);
  const int ix = (int)(n / plane);
  const bool in_x[3] = {ix > 0, true, ix < nnx - 1};
  const bool in_y[3] = {iy > 0, true, iy < nny - 1};
  const bool in_z[3] = {iz > 0, true, iz < nnz - 1};

  // 2. Row i of the 27 taps' 3x3 blocks against the staged neighbours.
  A acc = A(0);
  const TS* c = C + (long long)(3 * i) * N + n;
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int ox = o / 9, oy = (o / 3) % 3, oz = o % 3;
    const bool inside = in_x[ox] && in_y[oy] && in_z[oz];
    const A* s = xs + (ox * 3 + oy) * kRunVals + 3 * (t + oz);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc = fma_rn(Num<TS>::in(__ldg(c + (long long)(o * 9 + j) * N)),
                   inside ? s[j] : A(0), acc);
  }

  // 3. Mask, and the residual form's r - y, in the field's type.
  const long long g = 3 * n + i;
  const F y = Num<TF>::in(convert<TF>(Num<TS>::out(acc)));
  F v = Num<TF>::in(Num<TF>::out(Num<TF>::in(mask[g]) * y));
  if (r != nullptr) v = Num<TF>::in(r[g]) - v;
  out[g] = Num<TF>::out(v);
}

template <typename TS, typename TF>
int launch(const void* C, const void* mask, const void* x, const void* r,
           void* out, int nnx, int nny, int nnz, void* stream) {
  const long long nodes = (long long)nnx * nny * nnz;
  const long long blocks = (nodes + kNodes - 1) / kNodes;
  stencil_apply_kernel<TS, TF><<<(unsigned)blocks, 3 * kNodes, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TS*>(C), static_cast<const TF*>(mask),
      static_cast<const TF*>(x), static_cast<const TF*>(r),
      static_cast<TF*>(out), nnx, nny, nnz);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes: stencil_apply_<stencil>_<field>
// for every pair of float64 (f64), float32 (f32) and bfloat16 (bf16).  C
// in the stencil's type, (243, nnx * nny * nnz); mask, x, r and out in the
// field's, (nnx * nny * nnz, 3); r may be null (the plain form).  Each
// returns cudaGetLastError() after the launch (0 = success).
#define STENCIL_APPLY(NAME, TS, TF)                                          \
  int NAME(const void* C, const void* mask, const void* x, const void* r,   \
           void* out, int nnx, int nny, int nnz, void* stream) {            \
    return launch<TS, TF>(C, mask, x, r, out, nnx, nny, nnz, stream);       \
  }

extern "C" {
STENCIL_APPLY(stencil_apply_f64_f64, double, double)
STENCIL_APPLY(stencil_apply_f64_f32, double, float)
STENCIL_APPLY(stencil_apply_f64_bf16, double, __nv_bfloat16)
STENCIL_APPLY(stencil_apply_f32_f64, float, double)
STENCIL_APPLY(stencil_apply_f32_f32, float, float)
STENCIL_APPLY(stencil_apply_f32_bf16, float, __nv_bfloat16)
STENCIL_APPLY(stencil_apply_bf16_f64, __nv_bfloat16, double)
STENCIL_APPLY(stencil_apply_bf16_f32, __nv_bfloat16, float)
STENCIL_APPLY(stencil_apply_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
}  // extern "C"
