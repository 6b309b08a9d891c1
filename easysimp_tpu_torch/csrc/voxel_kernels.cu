// Hand-written Hopper kernels for the hex8 voxel SIMP operator.
//
// Replaces the two Pallas TPU kernels of easysimp_tpu/ops/pallas_kernels.py:
//   voxel_matvec   <- _kernel / make_pallas_matvec (pallas_call at :287)
//   voxel_energies <- _energies_kernel / make_pallas_energies (:406)
//
// Layouts are the package's public ones, C-contiguous:
//   node field u, out : (nx+1, ny+1, nz+1, 3)
//   element field     : (nx, ny, nz)
//
// What bounds them on an H100.  The matvec at 128^3 in fp32 moves about
// 60 MB (u in, scale in, out) -- ~18 us at 3.35 TB/s -- against ~1.2 G
// FMAs (2.1 M nodes x 576), ~36 us at the 67 TFLOP/s fp32 rate.  A simple
// kernel is bound by instruction issue, not bytes.  The design therefore
// spends no instruction on the 24x24 element matrix: it lives in __constant__
// memory and every index into it is a compile-time constant after full
// unrolling, so each FMA reads its coefficient straight from the constant
// bank (no load instruction, a broadcast to the warp).
//
// voxel_matvec is node-centric: one thread per output node gathers from its
// <= 8 incident elements (out-of-range elements count as E = 0) and writes
// its 3 components once.  No atomics, no reassembly: the result is
// deterministic.  Per node it keeps 24 accumulators, one 3-vector per
// incident element c (before the modulus scale), walks the 27 neighbour
// nodes once, and scales by E_c at the end: 576 + 24 FMAs, 27 + 8 loads.
//
// voxel_energies is element-centric: one thread per element gathers its 24
// dofs into registers and forms u_e^T ke u_e over the upper triangle of the
// symmetric ke (300 coefficient FMAs).
//
// Storage types: double, float, and bfloat16.  bfloat16 storage computes in
// float, as the Pallas kernel does; the stored ke is then float.
//
// The constant-memory ke is written by an async device-to-device copy on the
// launch stream before each launch, so it is stream-ordered with the kernel
// that reads it.  Launches with different ke on different streams at once
// would race; the package launches on the current stream only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NKE = 24 * 24;

__constant__ double c_ke64[NKE];
__constant__ float c_ke32[NKE];

// VTK / Ferrite hexahedron corner offsets (easysimp_tpu/ops/elements.py:39).
__host__ __device__ constexpr int corner_x(int c) {
  return (c == 1 || c == 2 || c == 5 || c == 6) ? 1 : 0;
}
__host__ __device__ constexpr int corner_y(int c) {
  return (c == 2 || c == 3 || c == 6 || c == 7) ? 1 : 0;
}
__host__ __device__ constexpr int corner_z(int c) { return c >= 4 ? 1 : 0; }
// Corner index of offset (x, y, z) in {0,1}^3, -1 if outside.
__host__ __device__ constexpr int corner_index(int x, int y, int z) {
  return (x < 0 || x > 1 || y < 0 || y > 1 || z < 0 || z > 1)
             ? -1
             : z * 4 + (y ? (x ? 2 : 3) : (x ? 1 : 0));
}

template <typename C> struct Ke;
template <> struct Ke<double> {
  __device__ static double at(int k) { return c_ke64[k]; }
};
template <> struct Ke<float> {
  __device__ static float at(int k) { return c_ke32[k]; }
};

template <typename T, typename C> __device__ inline C load(const T* p) {
  return static_cast<C>(*p);
}
template <> __device__ inline float load<__nv_bfloat16, float>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T, typename C> __device__ inline T store(C v) {
  return static_cast<T>(v);
}
template <> __device__ inline __nv_bfloat16 store<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T, typename C>
__global__ void __launch_bounds__(256)
voxel_matvec_kernel(const T* __restrict__ u, const T* __restrict__ scale,
                    T* __restrict__ out, int nx, int ny, int nz) {
  const int nnx = nx + 1, nny = ny + 1, nnz = nz + 1;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)nnx * nny * nnz) return;
  const int Z = (int)(n % nnz);
  const int Y = (int)((n / nnz) % nny);
  const int X = (int)(n / ((long long)nnz * nny));

  // Modulus of the element that has this node as its corner c.
  C E[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ex = X - corner_x(c), ey = Y - corner_y(c), ez = Z - corner_z(c);
    const bool in = ex >= 0 && ex < nx && ey >= 0 && ey < ny && ez >= 0 &&
                    ez < nz;
    E[c] = in ? load<T, C>(scale + ((long long)ex * ny + ey) * nz + ez)
              : C(0);
  }

  C acc[8][3];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[c][i] = C(0);

#pragma unroll
  for (int d = 0; d < 27; ++d) {
    const int dx = d / 9 - 1, dy = (d / 3) % 3 - 1, dz = d % 3 - 1;
    const int mx = X + dx, my = Y + dy, mz = Z + dz;
    const bool in = mx >= 0 && mx < nnx && my >= 0 && my < nny && mz >= 0 &&
                    mz < nnz;
    C v[3] = {C(0), C(0), C(0)};
    if (in) {
      const T* p = u + (((long long)mx * nny + my) * nnz + mz) * 3;
      v[0] = load<T, C>(p);
      v[1] = load<T, C>(p + 1);
      v[2] = load<T, C>(p + 2);
    }
    // Node n is corner c of element n - off(c); that element's corner
    // b = off(c) + d is the neighbour n + d.
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int b = corner_index(corner_x(c) + dx, corner_y(c) + dy,
                                 corner_z(c) + dz);
      if (b < 0) continue;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          acc[c][i] += Ke<C>::at((3 * c + i) * 24 + 3 * b + j) * v[j];
    }
  }

  C r[3] = {C(0), C(0), C(0)};
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] += E[c] * acc[c][i];
  T* o = out + n * 3;
  o[0] = store<T, C>(r[0]);
  o[1] = store<T, C>(r[1]);
  o[2] = store<T, C>(r[2]);
}

template <typename T, typename C>
__global__ void __launch_bounds__(256)
voxel_energies_kernel(const T* __restrict__ u, T* __restrict__ out, int nx,
                      int ny, int nz) {
  const int nny = ny + 1, nnz = nz + 1;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)nx * ny * nz) return;
  const int ez = (int)(e % nz);
  const int ey = (int)((e / nz) % ny);
  const int ex = (int)(e / ((long long)nz * ny));

  C ue[24];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T* p = u + (((long long)(ex + corner_x(c)) * nny + ey + corner_y(c)) *
                          nnz + ez + corner_z(c)) * 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) ue[3 * c + j] = load<T, C>(p + j);
  }

  // w = sum_p u_p (ke_pp u_p + 2 sum_{q>p} ke_pq u_q)
  C w = C(0);
#pragma unroll
  for (int p = 0; p < 24; ++p) {
    C t = C(0);
#pragma unroll
    for (int q = p + 1; q < 24; ++q) t += Ke<C>::at(p * 24 + q) * ue[q];
    w += ue[p] * (Ke<C>::at(p * 24 + p) * ue[p] + C(2) * t);
  }
  out[e] = store<T, C>(w);
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <typename C>
cudaError_t load_ke(const C* ke, cudaStream_t stream);
template <>
cudaError_t load_ke<double>(const double* ke, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_ke64, ke, NKE * sizeof(double), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}
template <>
cudaError_t load_ke<float>(const float* ke, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_ke32, ke, NKE * sizeof(float), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}

template <typename T, typename C>
int launch_matvec(const void* u, const void* scale, const void* ke, void* out,
                  int nx, int ny, int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = load_ke<C>(static_cast<const C*>(ke), s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)(nx + 1) * (ny + 1) * (nz + 1);
  voxel_matvec_kernel<T, C><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(scale),
      static_cast<T*>(out), nx, ny, nz);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int launch_energies(const void* u, const void* ke, void* out, int nx, int ny,
                    int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = load_ke<C>(static_cast<const C*>(ke), s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nx * ny * nz;
  voxel_energies_kernel<T, C><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns cudaGetLastError()
// after the launch (0 = success).  ke is a device pointer to the 24x24
// element matrix in the compute type (double for f64, float otherwise).
extern "C" {

int voxel_matvec_f64(const void* u, const void* scale, const void* ke,
                     void* out, int nx, int ny, int nz, void* stream) {
  return launch_matvec<double, double>(u, scale, ke, out, nx, ny, nz, stream);
}
int voxel_matvec_f32(const void* u, const void* scale, const void* ke,
                     void* out, int nx, int ny, int nz, void* stream) {
  return launch_matvec<float, float>(u, scale, ke, out, nx, ny, nz, stream);
}
int voxel_matvec_bf16(const void* u, const void* scale, const void* ke,
                      void* out, int nx, int ny, int nz, void* stream) {
  return launch_matvec<__nv_bfloat16, float>(u, scale, ke, out, nx, ny, nz,
                                             stream);
}

int voxel_energies_f64(const void* u, const void* ke, void* out, int nx,
                       int ny, int nz, void* stream) {
  return launch_energies<double, double>(u, ke, out, nx, ny, nz, stream);
}
int voxel_energies_f32(const void* u, const void* ke, void* out, int nx,
                       int ny, int nz, void* stream) {
  return launch_energies<float, float>(u, ke, out, nx, ny, nz, stream);
}
int voxel_energies_bf16(const void* u, const void* ke, void* out, int nx,
                        int ny, int nz, void* stream) {
  return launch_energies<__nv_bfloat16, float>(u, ke, out, nx, ny, nz,
                                               stream);
}

}  // extern "C"
