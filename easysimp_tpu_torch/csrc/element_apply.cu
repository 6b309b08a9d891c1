// Hand-written Hopper kernel for the unstructured (imported tet4/hex8 mesh)
// operator's element product.
//
//   out[e, i] = s_e * sum_j ke[e, i, j] * (m * u)[dof(e, j)],
//   dof(e, j) = 3 * conn[e, j / 3] + j % 3,
//
// written as the per-corner rows (E * d / 3, 3) that the operator's
// fixed-order incidence-table sum reads, followed by one zero row (the
// table's padding slot).  s (the element scale) and m (a 0/1 dof mask) may
// be absent.
//
// It replaces no Pallas kernel: the JAX package leaves this product to XLA
// (easysimp_tpu/ops/operator.py UnstructuredOperator.apply_elements, an
// einsum), and the port ran it as a gather, torch.bmm (cuBLAS's batched
// gemv) and a scale.  It was added because that gemv streamed the element
// matrices at about a tenth of the card's bandwidth.
//
// What bounds it on an H100.  Each element brings its own d x d matrix:
// at 44^3 x 6 tets in float32 (511,104 tets, d = 12) one launch reads
// 294.4 MB of ke, 16.4 MB of int64 connectivity, 2.0 MB of scale and the
// 1.1 MB vector (L2-resident), and writes 24.5 MB: ~0.10 ms at 3.35 TB/s.
// The arithmetic is 2 flops per 4 bytes of ke, so the bytes bind; the FMAs
// run in fp32 (fp64 for float64 storage) on the CUDA cores, no TF32.
//
// What the design does about it.
// - One thread per (element, row), kRows rows (kRows / d whole elements)
//   per block, small blocks, many resident per SM.  The block's rows of ke are one contiguous span of memory;
//   it is copied to shared memory with cp.async in 16-byte chunks,
//   consecutive threads on consecutive chunks, so every warp-wide request
//   is fully coalesced and the matrix bytes bypass L1 and registers.
// - While those copies fly, each thread gathers one dof of its element
//   (its own row index j picks dof j) from conn and u, applies the mask,
//   and puts it in shared memory: d loads per element, not d * d.
// - Then each thread reads its row of ke from shared memory in 16-byte
//   (8 for bf16 tets) vectors, conflict-free for float32 tets, and sums
//   ke[i, j] * u_j over j in ascending order with FMAs: no atomics, so the
//   result is bitwise equal from launch to launch.  The scaled row goes
//   out in the storage dtype, coalesced.
// - Up to 21 blocks are resident per SM, so one block's copies overlap the
//   others' products and stores; there is no ring inside a block.
// - The threads past the last row write the trailing zero row, so the
//   caller needs no concatenation before its table sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Rows per block: 8 tet4 or 4 hex8 elements.  Measured at 44^3 x 6 tets
// float32 (H100): 96 rows 82% of the byte bound, 192 80%, 384 77%, 768 70%;
// small blocks keep more of them resident and their copies in flight.
constexpr int kRows = 96;

// Storage type T, compute type C: bf16 computes in fp32.
template <typename T> struct Num;
template <> struct Num<double> {
  using C = double;
  __device__ static C in(double x) { return x; }
  __device__ static double out(C x) { return x; }
  __device__ static C fma(C a, C b, C c) { return __fma_rn(a, b, c); }
};
template <> struct Num<float> {
  using C = float;
  __device__ static C in(float x) { return x; }
  __device__ static float out(C x) { return x; }
  __device__ static C fma(C a, C b, C c) { return __fmaf_rn(a, b, c); }
};
template <> struct Num<__nv_bfloat16> {
  using C = float;
  __device__ static C in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(C x) { return __float2bfloat16(x); }
  __device__ static C fma(C a, C b, C c) { return __fmaf_rn(a, b, c); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <typename T, int D>
constexpr int smem_bytes() {
  return kRows * D * (int)sizeof(T) + kRows * (int)sizeof(typename Num<T>::C);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    element_apply_kernel(const T* __restrict__ u,
                         const long long* __restrict__ conn,
                         const T* __restrict__ ke, const T* __restrict__ scale,
                         const T* __restrict__ mask, T* __restrict__ out,
                         long long n_elem) {
  using N = Num<T>;
  using C = typename N::C;
  constexpr int ROWB = D * (int)sizeof(T);  // bytes of one row of ke
  constexpr int TILEB = kRows * ROWB;       // a multiple of 16
  // Row reads from shared memory: 16-byte vectors, 8 where a row is not a
  // multiple of 16 bytes (bf16 tets: 24 bytes).
  constexpr int VB = ROWB % 16 == 0 ? 16 : 8;
  using V = typename std::conditional<VB == 16, uint4, uint2>::type;
  constexpr int PER = VB / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  C* ue = reinterpret_cast<C*>(smem + TILEB);

  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;  // a multiple of D
  const long long rows = n_elem * D;
  const long long r = r0 + t;
  const long long e = r / D;
  const int j = t % D;

  // 1. The block's rows of ke, straight to shared memory.  Every element's
  // d * d values are a whole number of 16-byte chunks.
  const long long avail = (rows - r0) * ROWB;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(ke) + r0 * ROWB;
  for (int c = t * 16; c < TILEB; c += kRows * 16)
    if (c < avail) cp_async16(smem + c, src + c);

  // 2. Dof j of element e, masked, to shared memory.
  C x = C(0);
  if (r < rows) {
    const long long dof = 3 * conn[e * (D / 3) + j / 3] + j % 3;
    x = N::in(u[dof]);
    if (mask != nullptr) x *= N::in(mask[dof]);
  }
  ue[t] = x;
  cp_async_wait_all();
  __syncthreads();

  // 3. Row j of element e against its d dofs, in ascending order.
  if (r < rows) {
    const C* v = ue + (t - j);
    const V* row = reinterpret_cast<const V*>(smem + t * ROWB);
    C acc = C(0);
#pragma unroll
    for (int k = 0; k < ROWB / VB; ++k) {
      const V w = row[k];
      const T* vals = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int m = 0; m < PER; ++m)
        acc = N::fma(N::in(vals[m]), v[k * PER + m], acc);
    }
    if (scale != nullptr) acc *= N::in(scale[e]);
    out[r] = N::out(acc);
  } else if (r < rows + 3) {
    out[r] = N::out(C(0));  // the zero row after the last corner
  }
}

template <typename T, int D>
int launch(const void* u, const void* conn, const void* ke, const void* scale,
           const void* mask, void* out, long long n_elem, void* stream) {
  constexpr int smem = smem_bytes<T, D>();
  static_assert(smem <= 48 * 1024, "above the default dynamic smem limit");
  const long long blocks = (n_elem * D + 3 + kRows - 1) / kRows;
  element_apply_kernel<T, D><<<(unsigned)blocks, kRows, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const long long*>(conn),
      static_cast<const T*>(ke), static_cast<const T*>(scale),
      static_cast<const T*>(mask), static_cast<T*>(out), n_elem);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* u, const void* conn, const void* ke,
             const void* scale, const void* mask, void* out, long long n_elem,
             int d, void* stream) {
  switch (d) {
    case 12:
      return launch<T, 12>(u, conn, ke, scale, mask, out, n_elem, stream);
    case 24:
      return launch<T, 24>(u, conn, ke, scale, mask, out, n_elem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  u, ke, scale, mask and out in the
// storage type; conn int64 (n_elem, d / 3); scale and mask may be null;
// out holds n_elem * d + 3 values.  Each returns cudaGetLastError() after
// the launch (0 = success).
extern "C" {

int element_apply_f64(const void* u, const void* conn, const void* ke,
                      const void* scale, const void* mask, void* out,
                      long long n_elem, int d, void* stream) {
  return dispatch<double>(u, conn, ke, scale, mask, out, n_elem, d, stream);
}
int element_apply_f32(const void* u, const void* conn, const void* ke,
                      const void* scale, const void* mask, void* out,
                      long long n_elem, int d, void* stream) {
  return dispatch<float>(u, conn, ke, scale, mask, out, n_elem, d, stream);
}
int element_apply_bf16(const void* u, const void* conn, const void* ke,
                       const void* scale, const void* mask, void* out,
                       long long n_elem, int d, void* stream) {
  return dispatch<__nv_bfloat16>(u, conn, ke, scale, mask, out, n_elem, d,
                                 stream);
}

}  // extern "C"
