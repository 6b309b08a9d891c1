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
// Two designs live here.
//
// 1. float32 and bfloat16 storage: tensor-core kernels (voxel_matvec_tc,
//    voxel_energies_tc).
//
//    What bounds them on an H100.  The matvec at 128^3 in fp32 must move
//    59.9 MB (u and scale in, out back), 17.9 us at 3.35 TB/s.  Its element
//    products are 2.4 GFLOP.  Done fp32-accurately on the tensor cores as
//    3xTF32 they cost 3 x 2.4 GFLOP at 495 TFLOP/s = 14.6 us, so the card's
//    bound is the bytes.  On the FP32 CUDA cores the same products cannot
//    take less than 36 us (67 TFLOP/s), twice the byte bound, which is why
//    the products run on the tensor cores.  The energies move 34.2 MB
//    (10.2 us) for the same products, so they are bound by the operations.
//    In practice wgmma TF32 reaches about 75% of the 495 TFLOP/s (measured
//    by scripts/voxel_kernel_probe.py), and the tile's halo adds a third to
//    the matvec's products at 128^3, so its tensor work alone takes ~25 us;
//    shared-memory traffic and instruction issue per element layer cost
//    more than that, and the three overlap only partly (PERF.md).
//
//    What the design does about it.
//    - The element product q_e = ke u_e runs on the tensor cores as wgmma
//      m64n24k8 TF32, with the 3xTF32 split: hi = tf32(x), lo = tf32(x -
//      hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in fp32.
//      Single TF32 keeps ~10 mantissa bits, too few for the reference's
//      precision=HIGHEST.  bf16 values are exact in TF32, so for bf16
//      storage a_lo = 0 and two products remain.  A = the dofs of 16
//      elements along z per warp (64 rows per warpgroup), in registers; B =
//      ke, split once per block into six K-major tiles in shared memory
//      (stage_ke): no per-launch copy of ke anywhere, and no registers held
//      for it.  Each warp takes two consecutive element rows.
//    - A block takes a column of the grid, 16 x 16 elements in (y, z), and
//      marches along x over a chunk of element layers, a loop inside the
//      block; the chunk is chosen so that the grid fills the SMs' resident
//      slots in as few rounds as it can (chunk_length).  Node planes of u
//      (17 x 17 nodes) and element layers of scale are staged in shared
//      memory with cp.async in 16-byte chunks, in a ring of five slots that
//      keeps two groups in flight ahead of the one in use.  A staged row
//      lies at its global alignment phase, so every chunk lands aligned
//      whatever the grid's extents; the public layout is neither padded nor
//      transposed (TMA would need 16-byte row strides, which (nz+1)*3*4
//      bytes is not in general).
//    - Each staged node plane is copied once, as fp32, to fixed offsets, so
//      that every lane's A columns are per-layer constants (no branches, no
//      per-use alignment arithmetic; the first design picked among staged
//      rows at run time, which the compiler turned into divergent branches).
//    - Only the bytes of the field are read.  Staged slots outside the
//      field hold stale data, and every element that touches one lies
//      outside the field itself: its product is replaced by an exact 0 (a
//      select, not a multiply), and no output is written from it.
//    - matvec: the block owns the 15 x 15 nodes interior to its element
//      tile; the one-element halo is recomputed by the neighbouring block
//      (tensor work only).  Per layer it writes E_e (ke u_e) for its 16 x 16
//      elements to a shared-memory tile; each owned node sums its 4
//      incident element corners of this layer with the 4 of the layer
//      before, carried in a register, in a fixed order, and the three
//      components are stored coalesced.  Those sums for one layer run while
//      the next layer's products are in flight.  No atomics, so the result
//      is deterministic.
//    - energies: ke's output columns are permuted so that each lane's
//      accumulators hold q_e at the very dofs of its A fragment: the dot
//      w_e = u_e . q_e is taken from registers, reduced over the four lanes
//      of an mma row group with shuffles in a fixed order; one store per
//      element, no halo.  The A fragment is centred first: each element's
//      mean displacement (per component, over its 8 corners, summed over
//      the row group's four lanes with shuffles) is taken from its dofs.
//      ke annihilates translations, so w_e is unchanged; without it a field
//      that carries a large near-rigid motion (a simply supported beam's
//      deflection, several units where an element's strain moves its
//      corners by 1e-3) loses the energy's leading digits to cancellation,
//      and cells of low energy read it wrong by tens of percent.
//
// 2. float64 storage: the first, simple kernels (voxel_matvec_kernel,
//    voxel_energies_kernel), on the FP64 CUDA cores.  float64 runs only in
//    tests and in a small trajectory; its tensor-core path (DMMA) is later
//    work.  Node-centric matvec: one thread per output node gathers from its
//    <= 8 incident elements (out-of-range elements count as E = 0), 600
//    FMAs per node with every ke coefficient taken from __constant__ memory
//    by a compile-time index; element-centric energies over the upper
//    triangle of the symmetric ke, from the centred element dofs as above.
//    ke is copied to constant memory on the launch stream before each
//    launch, stream-ordered with the kernel; launches with different ke on
//    different streams at once would race, and the package launches on the
//    current stream only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NKE = 24 * 24;

__constant__ double c_ke64[NKE];

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

template <typename T, typename C> __device__ inline C load(const T* p) {
  return static_cast<C>(*p);
}
template <typename T, typename C> __device__ inline T store(C v) {
  return static_cast<T>(v);
}
template <> __device__ inline __nv_bfloat16 store<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// 1. Tensor-core kernels: float and bfloat16 storage, fp32 arithmetic.
// ---------------------------------------------------------------------------

constexpr int TE = 16;              // elements per tile edge in y and z
constexpr int TN = TE + 1;          // staged nodes per tile edge
constexpr int kTC = 256;            // threads per block
constexpr int kWarps = kTC / 32;
constexpr int kRows = TE / kWarps;  // element rows per warp and layer
constexpr int kStages = 5;          // raw ring slots, one cp.async group each
constexpr int kAhead = kStages - 2; // groups beyond the one copied this layer
constexpr int kCopies = 3;          // copied-plane slots: ex, ex + 1, ex + 2
constexpr int QS = 26;              // floats per element in the q tile (24
                                    // and 2 against bank conflicts)

// Bytes of a staged row holding `data` bytes at any 16-byte phase.
__host__ __device__ constexpr int row_bytes(int data) {
  return (15 + data + 15) / 16 * 16;
}

// A copied node row: TN nodes x 3 fp32 values at fixed offsets (no
// alignment phase), padded to 56 words.
constexpr int PROW = 56 * 4;
constexpr int PPLANE = TN * PROW;
constexpr int PNODE8 = 8 * 12;      // element g + 8: eight nodes further
static_assert(TN * 12 <= PROW, "row fits");

// ke's six wgmma B tiles (stage_ke), at the start of shared memory.
constexpr int KE_TILE = 24 * 8 * 4;     // bytes per (kt, part) tile
constexpr int KE_SMEM = 6 * KE_TILE;

template <typename T> struct Tile {
  static constexpr int W = 3 * (int)sizeof(T);            // bytes per node
  static constexpr int UROW = row_bytes(TN * W);          // staged node row
  static constexpr int UPLANE = TN * UROW;                // staged node plane
  static constexpr int SROW = row_bytes(TE * (int)sizeof(T));
  static constexpr int SLAYER = TE * SROW;                // staged scale layer
  static constexpr int QLAYER = TE * TE * QS * 4;         // E (ke u_e), bytes
  // matvec: ke tiles, raw node planes, raw scale layers, copied planes, two
  // q tiles
  static constexpr int MV_RAW = KE_SMEM;
  static constexpr int MV_SCALE = MV_RAW + kStages * UPLANE;
  static constexpr int MV_COPY = MV_SCALE + kStages * SLAYER;
  static constexpr int MV_Q = MV_COPY + kCopies * PPLANE;
  static constexpr int MATVEC_SMEM = MV_Q + 2 * QLAYER;
  // energies: ke tiles, raw node planes, copied planes
  static constexpr int EN_RAW = KE_SMEM;
  static constexpr int EN_COPY = EN_RAW + kStages * UPLANE;
  static constexpr int ENERGIES_SMEM = EN_COPY + kCopies * PPLANE;
  static_assert(MV_COPY % 16 == 0 && EN_COPY % 16 == 0 && MV_Q % 16 == 0,
                "aligned regions");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of the committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages ROWS rows of a field into shared memory, one 16-byte chunk per
// thread at most.  Slot 0 of tile row r is at global byte address
// src0 + r * stride (an address that may lie outside the field); rows
// [rlo, rhi) and slots [ilo, ihi), W bytes each, are in the field.  Exactly
// those bytes are read: the 16-byte chunks that cover them, the last one
// cut short (cp.async zero-fills its tail).  A chunk lands at its global
// alignment phase within the shared row: byte a of the row sits at
// dst + r * ROWB + (a - (slot 0 address & ~15)).
template <int ROWS, int ROWB, int W>
__device__ __forceinline__ void stage_rows(unsigned char* dst, long long src0,
                                           long long stride, int rlo, int rhi,
                                           int ilo, int ihi) {
  constexpr int MAXCH = ROWB / 16;
  static_assert(ROWS * MAXCH <= kTC, "one chunk per thread");
  const int r = (int)threadIdx.x / MAXCH, k = (int)threadIdx.x - r * MAXCH;
  if (r < rlo || r >= rhi || ilo >= ihi) return;
  const long long g = src0 + r * stride;
  const long long hi = g + (long long)ihi * W;
  const long long ch = ((g + (long long)ilo * W) & ~15LL) + 16LL * k;
  if (ch >= hi) return;
  cp_async16(dst + r * ROWB + (int)(ch - (g & ~15LL)),
             reinterpret_cast<const void*>(ch),
             (int)(hi - ch < 16 ? hi - ch : 16));
}

// Alignment phase (0..15) of a staged row whose slot 0 is slot `index` of a
// field at `base` with W-byte slots (unsigned: wraps, only the low bits
// count).
__device__ __forceinline__ int phase(uintptr_t base, int index, int W) {
  return (int)(((unsigned)base + (unsigned)index * (unsigned)W) & 15u);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32 (and of tf32_round in
// ops/cuda_kernels.py), in two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <typename T> __device__ __forceinline__ float lds(
    const unsigned char* p);
template <> __device__ __forceinline__ float lds<float>(
    const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
template <> __device__ __forceinline__ float lds<__nv_bfloat16>(
    const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
__device__ __forceinline__ float ldsf(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// The order of the products' output columns.  Lane (g, t) holds output
// columns n = 8 nt + 2 t + h (h = 0, 1) of its mma rows; column n is dof
// pi(n) of the element:
//   kNatural: pi(n) = n (the matvec writes them out as they are);
//   kAOrder:  pi(8 nt + 2 t + h) = 8 nt + t + 4 h -- the dofs of the lane's
//     own A fragment (the energies dot it with them in registers).
enum ColumnOrder { kNatural, kAOrder };

__device__ __forceinline__ int ke_column(ColumnOrder order, int nt, int g) {
  return order == kAOrder ? 8 * nt + (g >> 1) + 4 * (g & 1) : 8 * nt + g;
}

// ke as wgmma B operands in shared memory, split hi/lo: tile (kt, part)
// holds B[k][n] = part(ke[8 kt + k][pi(n)]), k < 8, n < 24 (ke is
// symmetric, so column n of A B is (ke u_e)[pi(n)]), K-major without
// swizzle: 8 x 4 core matrices (n, k % 4), the two along k 128 bytes apart
// and the three along n 256 bytes apart.

__device__ __forceinline__ void stage_ke(const float* __restrict__ ke,
                                         unsigned char* dst,
                                         ColumnOrder order) {
  float* tiles = reinterpret_cast<float*>(dst);
  for (int i = threadIdx.x; i < 3 * 24 * 8; i += kTC) {
    const int kt = i / 192, n = (i % 192) / 8, k = i % 8;
    const float v = __ldg(ke + (8 * kt + k) * 24 + ke_column(order, n / 8,
                                                            n % 8));
    const uint32_t hi = to_tf32(v);
    const int at = ((n / 8) * 2 + k / 4) * 32 + (n % 8) * 4 + k % 4;
    tiles[2 * kt * 192 + at] = __uint_as_float(hi);
    tiles[(2 * kt + 1) * 192 + at] =
        __uint_as_float(to_tf32(v - __uint_as_float(hi)));
  }
  // The tiles are read by wgmma (the async proxy): order the stores first.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a ke tile: address / 16, leading (k) byte
// offset 128 / 16, stride (n) byte offset 256 / 16, no swizzle.
__device__ __forceinline__ uint64_t ke_desc(const unsigned char* tile) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(tile);
  return ((a >> 4) & 0x3FFF) | (8ull << 16) | (16ull << 32);
}

// d += a b for the warpgroup's 64 rows (16 per warp, A in registers in the
// mma.sync m16n8k8 layout), N = 24 columns of a ke tile; d[nt] holds
// D[g][8nt+2t..+1] ([0..1]) and D[g+8][..] ([2..3]).
__device__ __forceinline__ void wgmma_tf32(float (&d)[3][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, %16, "
      "p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The thread's share of copying a staged node plane: values
// idx = tid + kTC k of its TN x TN x 3, row r = idx / (3 TN).  src[k]: the
// value's byte offset in a raw plane slot, before its row's alignment phase
// (-1: none); dst[k]: its byte offset in a copied plane slot (bits 0..15)
// and its row's phase step r dy (bits 16..).
constexpr int kPlaneValues = TN * TN * 3;
constexpr int kCopyIt = (kPlaneValues + kTC - 1) / kTC;

struct CopyMap {
  int src[kCopyIt], dst[kCopyIt];
};

template <typename T>
__device__ __forceinline__ CopyMap copy_map(int dy) {
  CopyMap m;
#pragma unroll
  for (int k = 0; k < kCopyIt; ++k) {
    const int idx = (int)threadIdx.x + kTC * k;
    const int r = idx / (3 * TN), f = idx - r * 3 * TN;
    m.src[k] = idx < kPlaneValues ? r * Tile<T>::UROW + f * (int)sizeof(T)
                                  : -1;
    m.dst[k] = (r * PROW + f * 4) | ((r * dy) << 16);
  }
  return m;
}

// Copies the staged node plane at `raw` (its row 0 at alignment phase ph)
// to the plane at `dst`, in fp32 at fixed offsets, so that every later
// read has an address known to its lane.  Slots outside the field hold
// stale data; only elements outside the field read them.
template <typename T>
__device__ __forceinline__ void copy_plane(unsigned char* smem, int raw,
                                           int ph, int dst,
                                           const CopyMap& m) {
#pragma unroll
  for (int k = 0; k < kCopyIt; ++k) {
    if (m.src[k] < 0) continue;
    *reinterpret_cast<float*>(smem + dst + (m.dst[k] & 0xffff)) =
        lds<T>(smem + raw + m.src[k] + ((ph + (m.dst[k] >> 16)) & 15));
  }
}

// Copied-plane byte offset of dof k = 3c + j of lane (g, t)'s element in
// an element row, from the row of the element's (0, 0) corner: row cy,
// node g + cz, value j; bit 31 set when the dof lies in the next node plane
// (cx = 1).  Lanes read their columns without branches.
__device__ __forceinline__ int column(int k, int g) {
  const int c = k / 3, j = k - 3 * c;
  return (int)((unsigned)corner_x(c) << 31) |
         (corner_y(c) * PROW + ((g + corner_z(c)) * 3 + j) * 4);
}

// A column's shared-memory byte offset for the warp's first element row,
// whose (0, 0) corner row is at `base`; the next node plane's slot lies
// `dnext` bytes after this one's.
__device__ __forceinline__ int column_at(int col, int base, int dnext) {
  return base + (col & 0x7fffffff) + (dnext & (col >> 31));
}

// Takes each element's mean displacement from its A fragment values.
// Lane (g, t) holds, per row tile r, columns k = 8 kt + t + 4 h (value
// [r][kt][2 h + w]) of elements g (w = 0) and g + 8 (w = 1); column k is
// component k % 3 = (2 kt + t + h) % 3, two of each per lane, eight per
// element over the four lanes t of the row group.  Sums in a fixed order:
// the lane's own, then over t with shuffles.
__device__ __forceinline__ void centre_rows(float (&a)[kRows][3][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float m[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int kt = 0; kt < 3; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = (2 * kt + t + (i >> 1)) % 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (j == c) m[i & 1][c] += a[r][kt][i];
      }
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        m[w][c] += __shfl_xor_sync(0xffffffffu, m[w][c], 1);
        m[w][c] += __shfl_xor_sync(0xffffffffu, m[w][c], 2);
        m[w][c] *= 0.125f;
      }
#pragma unroll
    for (int kt = 0; kt < 3; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = (2 * kt + t + (i >> 1)) % 3;
        const float* mw = m[i & 1];
        a[r][kt][i] -= j == 0 ? mw[0] : (j == 1 ? mw[1] : mw[2]);
      }
  }
}

// Issues q = A ke for the warp's kRows mma row tiles (16 elements along z
// each, consecutive element rows) in fp32 accuracy, as wgmma over the
// warpgroup's four warps: every A fragment is loaded and split first, then
// all products are issued as one group, which runs on while the caller does
// other work; wgmma_wait() ends it.  pa[kt][h]: the A columns 8 kt + t + 4 h
// of the first row tile; ke: the ke tiles.
// acc[r][nt] holds Q[g][8nt+2t..+1] ([0..1]) and Q[g+8][..] ([2..3]);
// a[r][kt] the A fragment's values as loaded (rows g, g+8 of columns
// 8 kt + t, 8 kt + t + 4), less their element's mean displacement if
// kCentre (centre_rows).
template <typename T, bool kCentre = false>
__device__ __forceinline__ void issue_products(float (&acc)[kRows][3][4],
                                                 float (&a)[kRows][3][4],
                                                 const unsigned char* sm,
                                                 const int (&pa)[3][2],
                                                 const unsigned char* ke) {
  // bf16 is exact in TF32, unless centring moved it off the bf16 grid
  constexpr bool kSplitA = sizeof(T) == 4 || kCentre;
  uint32_t ah[kRows][3][4], al[kRows][3][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      const unsigned char* p0 = sm + pa[kt][0] + r * PROW;
      const unsigned char* p1 = sm + pa[kt][1] + r * PROW;
      a[r][kt][0] = ldsf(p0);
      a[r][kt][1] = ldsf(p0 + PNODE8);
      a[r][kt][2] = ldsf(p1);
      a[r][kt][3] = ldsf(p1 + PNODE8);
    }
  if (kCentre) centre_rows(a);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = a[r][kt][i];
        ah[r][kt][i] = to_tf32(x);
        al[r][kt][i] =
            kSplitA ? to_tf32(x - __uint_as_float(ah[r][kt][i])) : 0u;
        acc[r][kt][i] = 0.f;
      }
    }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    const uint64_t bh = ke_desc(ke + 2 * kt * KE_TILE);
    const uint64_t bl = ke_desc(ke + (2 * kt + 1) * KE_TILE);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kSplitA) wgmma_tf32(acc[r], al[r][kt], bh);
      wgmma_tf32(acc[r], ah[r][kt], bl);
      wgmma_tf32(acc[r], ah[r][kt], bh);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kTC, 2)
voxel_matvec_tc(const T* __restrict__ u, const T* __restrict__ scale,
                const float* __restrict__ ke, T* __restrict__ out, int nx,
                int ny, int nz, int chunk) {
  using L = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nnx = nx + 1, nny = ny + 1, nnz = nz + 1;
  const int tiles_z = (nnz + TE - 2) / (TE - 1);
  // Element tile (and staged node tile) origin; owned nodes start one later.
  const int ys = (int)(blockIdx.x / tiles_z) * (TE - 1) - 1;
  const int zs = (int)(blockIdx.x % tiles_z) * (TE - 1) - 1;
  const int xa = (int)blockIdx.y * chunk;        // owned node planes [xa, xb)
  const int xb = min(nnx, xa + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uintptr_t ubase = reinterpret_cast<uintptr_t>(u);
  const uintptr_t sbase = reinterpret_cast<uintptr_t>(scale);

  stage_ke(ke, smem, kNatural);
  int ca[3][2];
#pragma unroll
  for (int kt = 0; kt < 3; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h) ca[kt][h] = column(8 * kt + t + 4 * h, g);
  const CopyMap cm = copy_map<T>((nnz * L::W) & 15);

  // The thread's outputs in each owned node plane: component f % 3 of node
  // (ys + 1 + r, zs + 1 + f / 3), read from q at gq[k], written at go[k]
  // within the plane (-1: none).  carry[k]: its corners with cx = 1, summed
  // from the layer before.
  constexpr int kOutRow = (TE - 1) * 3;
  constexpr int kOut = (TE - 1) * kOutRow;
  constexpr int kOutIt = (kOut + kTC - 1) / kTC;
  int gq[kOutIt], go[kOutIt];
  float carry[kOutIt];
#pragma unroll
  for (int k = 0; k < kOutIt; ++k) {
    const int idx = (int)threadIdx.x + k * kTC;
    const int r = idx / kOutRow, f = idx - r * kOutRow;
    const int zl = f / 3, j = f - 3 * zl;
    const int Y = ys + 1 + r, Z3 = (zs + 1) * 3 + f;
    gq[k] = ((r + 1) * TE + zl + 1) * QS + j;
    go[k] = (idx < kOut && Y < nny && Z3 < nnz * 3) ? Y * nnz * 3 + Z3 : -1;
    carry[k] = 0.f;
  }

  // Ring group k: node plane e0 + k and scale layer e0 + k, in raw slot
  // k % kStages; node plane e0 + k is copied into slot k % kCopies.  Element
  // layers e0 .. e0 + nlayers - 1 feed the owned planes and need node
  // planes e0 .. e0 + nlayers.
  const int e0 = xa - 1, nlayers = xb - xa + 1;
  auto stage = [&](int k) {
    const int x = e0 + k, s = k % kStages;
    if (k <= nlayers && x >= 0 && x < nnx)
      stage_rows<TN, L::UROW, L::W>(
          smem + L::MV_RAW + s * L::UPLANE,
          (long long)ubase + (long long)((x * nny + ys) * nnz + zs) * L::W,
          (long long)nnz * L::W, max(0, -ys), min(TN, nny - ys), max(0, -zs),
          min(TN, nnz - zs));
    if (k < nlayers && x >= 0 && x < nx)
      stage_rows<TE, L::SROW, (int)sizeof(T)>(
          smem + L::MV_SCALE + s * L::SLAYER,
          (long long)sbase + (long long)((x * ny + ys) * nz + zs) * sizeof(T),
          (long long)nz * sizeof(T), max(0, -ys), min(TE, ny - ys),
          max(0, -zs), min(TE, nz - zs));
  };
  auto copy = [&](int k) {
    copy_plane<T>(smem, L::MV_RAW + (k % kStages) * L::UPLANE,
                  phase(ubase, ((e0 + k) * nny + ys) * nnz + zs, L::W),
                  L::MV_COPY + (k % kCopies) * PPLANE, cm);
  };
  for (int k = 0; k <= kAhead; ++k) {
    stage(k);
    cp_async_commit();
  }
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  copy(0);
  copy(1);

  // Iteration i issues the products of element layer ex = e0 + i, sums
  // node plane ex - 1 from q tile (i - 1) % 2 while they run, then scales
  // them into q tile i % 2.  One more iteration sums the last plane.
  for (int i = 0; i <= nlayers; ++i) {
    const int ex = e0 + i;
    // Group i + 2 has landed and every warp is done with iteration i - 1:
    // its raw slot takes group i + kAhead + 1, its copied slot node plane
    // ex + 2, and q tile (i - 1) % 2 is complete.
    cp_async_wait<kAhead - 2>();
    __syncthreads();
    stage(i + kAhead + 1);
    cp_async_commit();
    if (i + 2 <= nlayers) copy(i + 2);

    // (In the extra iteration the products read stale planes; they are
    // discarded, and issuing them keeps the control flow uniform.)
    const int m0 = kRows * warp;  // the warp's first element row
    const int ps = i % kCopies;
    const int base = L::MV_COPY + ps * PPLANE + m0 * PROW;
    const int dnext = (ps == kCopies - 1 ? 1 - kCopies : 1) * PPLANE;
    int pa[3][2];
#pragma unroll
    for (int kt = 0; kt < 3; ++kt)
#pragma unroll
      for (int h = 0; h < 2; ++h) pa[kt][h] = column_at(ca[kt][h], base, dnext);
    float acc[kRows][3][4], a[kRows][3][4];
    issue_products<T>(acc, a, smem, pa, smem);

    if (i > 0) {
      // Node plane ex - 1: its corners with cx = 0 from layer ex - 1 after
      // the ones with cx = 1 carried from layer ex - 2; layer ex - 1's
      // cx = 1 corners are carried on.  A fixed corner order.
      const float* qc = reinterpret_cast<const float*>(
          smem + L::MV_Q + ((i - 1) & 1) * L::QLAYER);
      const int plane = (ex - 1) * nny * nnz * 3;
#pragma unroll
      for (int k = 0; k < kOutIt; ++k) {
        if (go[k] < 0) continue;
        float s = carry[k], next = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float v =
              qc[gq[k] - (corner_y(c) * TE + corner_z(c)) * QS + 3 * c];
          if (corner_x(c))
            next += v;
          else
            s += v;
        }
        carry[k] = next;
        if (i > 1) out[plane + go[k]] = store<T, float>(s);
      }
    }

    wgmma_wait();
    if (i < nlayers) {
      unsigned char* q = smem + L::MV_Q + (i & 1) * L::QLAYER;
      const bool layer_in = ex >= 0 && ex < nx;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = m0 + r, ey = ys + m;
        const int ez0 = zs + g, ez1 = ez0 + 8;
        const bool row_in = layer_in && ey >= 0 && ey < ny;
        const bool in0 = row_in && ez0 >= 0 && ez0 < nz;
        const bool in1 = row_in && ez1 < nz;
        // Out-of-field elements read stale slots: an exact 0 replaces them.
        const unsigned char* srow =
            smem + L::MV_SCALE + (i % kStages) * L::SLAYER + m * L::SROW +
            phase(sbase, (ex * ny + ey) * nz + zs, (int)sizeof(T)) +
            g * (int)sizeof(T);
        const float E0 = lds<T>(srow), E1 = lds<T>(srow + 8 * sizeof(T));
        float* q0 = reinterpret_cast<float*>(q) + (m * TE + g) * QS + 2 * t;
        float* q1 = q0 + 8 * QS;
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          *reinterpret_cast<float2*>(q0 + 8 * nt) =
              in0 ? make_float2(acc[r][nt][0] * E0, acc[r][nt][1] * E0)
                  : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(q1 + 8 * nt) =
              in1 ? make_float2(acc[r][nt][2] * E1, acc[r][nt][3] * E1)
                  : make_float2(0.f, 0.f);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTC, 2)
voxel_energies_tc(const T* __restrict__ u, const float* __restrict__ ke,
                  T* __restrict__ out, int nx, int ny, int nz, int chunk) {
  using L = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nny = ny + 1, nnz = nz + 1;
  const int tiles_z = (nz + TE - 1) / TE;
  const int ys = (int)(blockIdx.x / tiles_z) * TE;
  const int zs = (int)(blockIdx.x % tiles_z) * TE;
  const int ea = (int)blockIdx.y * chunk;        // element layers [ea, eb)
  const int eb = min(nx, ea + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uintptr_t ubase = reinterpret_cast<uintptr_t>(u);

  stage_ke(ke, smem, kAOrder);
  int ca[3][2];
#pragma unroll
  for (int kt = 0; kt < 3; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h) ca[kt][h] = column(8 * kt + t + 4 * h, g);
  const CopyMap cm = copy_map<T>((nnz * L::W) & 15);

  // Ring group k: node plane ea + k in raw slot k % kStages, copied into
  // slot k % kCopies.
  const int nlayers = eb - ea;
  auto stage = [&](int k) {
    if (k > nlayers) return;
    const int x = ea + k;
    stage_rows<TN, L::UROW, L::W>(
        smem + L::EN_RAW + (k % kStages) * L::UPLANE,
        (long long)ubase + (long long)((x * nny + ys) * nnz + zs) * L::W,
        (long long)nnz * L::W, 0, min(TN, nny - ys), 0, min(TN, nnz - zs));
  };
  auto copy = [&](int k) {
    copy_plane<T>(smem, L::EN_RAW + (k % kStages) * L::UPLANE,
                  phase(ubase, ((ea + k) * nny + ys) * nnz + zs, L::W),
                  L::EN_COPY + (k % kCopies) * PPLANE, cm);
  };
  for (int k = 0; k <= kAhead; ++k) {
    stage(k);
    cp_async_commit();
  }
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  copy(0);
  copy(1);

  for (int i = 0; i < nlayers; ++i) {
    const int ex = ea + i;
    cp_async_wait<kAhead - 2>();
    __syncthreads();
    stage(i + kAhead + 1);
    cp_async_commit();
    if (i + 2 <= nlayers) copy(i + 2);

    const int ps = i % kCopies;
    const int base = L::EN_COPY + ps * PPLANE + kRows * warp * PROW;
    const int dnext = (ps == kCopies - 1 ? 1 - kCopies : 1) * PPLANE;
    int pa[3][2];
#pragma unroll
    for (int kt = 0; kt < 3; ++kt)
#pragma unroll
      for (int h = 0; h < 2; ++h) pa[kt][h] = column_at(ca[kt][h], base, dnext);
    float acc[kRows][3][4], a[kRows][3][4];
    issue_products<T, true>(acc, a, smem, pa, smem);
    wgmma_wait();
    // w_e = u_e . q_e: in kAOrder, accumulator column (nt, h) of this lane
    // holds q at the dof of its A value a[kt = nt][2 h] (row g; a[..][2 h +
    // 1] for row g + 8).  Summed over the lane's six dofs, then over the
    // four lanes of the row group, in a fixed order.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ey = ys + kRows * warp + r;
      float w0 = 0.f, w1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          w0 += acc[r][nt][h] * a[r][nt][2 * h];
          w1 += acc[r][nt][2 + h] * a[r][nt][2 * h + 1];
        }
      w0 += __shfl_xor_sync(0xffffffffu, w0, 1);
      w1 += __shfl_xor_sync(0xffffffffu, w1, 1);
      w0 += __shfl_xor_sync(0xffffffffu, w0, 2);
      w1 += __shfl_xor_sync(0xffffffffu, w1, 2);
      if (t == 0 && ey < ny) {
        T* o = out + (ex * ny + ey) * nz + zs + g;
        if (zs + g < nz) o[0] = store<T, float>(w0);
        if (zs + g + 8 < nz) o[8] = store<T, float>(w1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Simple kernels: float64 storage, and the fp32 yardstick.
// ---------------------------------------------------------------------------

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
  // centred: less the element's mean displacement
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    C m = C(0);
#pragma unroll
    for (int c = 0; c < 8; ++c) m += ue[3 * c + j];
    m *= C(0.125);
#pragma unroll
    for (int c = 0; c < 8; ++c) ue[3 * c + j] -= m;
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

template <typename T, typename C>
int launch_matvec_simple(const void* u, const void* scale, const void* ke,
                         void* out, int nx, int ny, int nz, void* stream) {
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
int launch_energies_simple(const void* u, const void* ke, void* out, int nx,
                           int ny, int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = load_ke<C>(static_cast<const C*>(ke), s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nx * ny * nz;
  voxel_energies_kernel<T, C><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz);
  return (int)cudaGetLastError();
}

// Launch shape of a tensor-core kernel on the current device: the SM count
// and the blocks of kTC threads with `smem` bytes that one SM holds, found
// once per device (in the caller's `cache`) after raising the kernel's
// dynamic shared-memory limit.
struct Shape {
  int sms, per_sm;
};

template <typename K>
cudaError_t launch_shape(K kernel, int smem, Shape (&cache)[64],
                         Shape& shape) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Shape& c = cache[dev & 63];
  if (c.per_sm == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTC, smem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    c.per_sm = n;
  }
  shape = c;
  return cudaSuccess;
}

// Chunk length along x for `cols` block columns marching over n x-steps,
// each block paying `extra` steps of set-up (the ring's first planes, a
// halo layer).  A block's steps take about as long whether it shares its SM
// or not, so the time is the rounds of resident blocks on the busiest SM
// times the steps of one block: the chunk that makes
// ceil(ceil(blocks / SMs) / per_sm) x (chunk + extra) least, the shorter
// one on a tie.
inline int chunk_length(int n, int cols, int sms, int per_sm, int extra) {
  int best = n;
  long long best_cost = -1;
  for (int nch = 1; nch <= n && nch <= 65535; ++nch) {
    const int chunk = (n + nch - 1) / nch;
    const long long blocks = (long long)cols * ((n + chunk - 1) / chunk);
    const long long rounds = ((blocks + sms - 1) / sms + per_sm - 1) / per_sm;
    const long long cost = rounds * (chunk + extra);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = chunk;
    }
  }
  return best;
}

template <typename T>
int launch_matvec_tc(const void* u, const void* scale, const void* ke,
                     void* out, int nx, int ny, int nz, void* stream) {
  using L = Tile<T>;
  static Shape cache[64] = {};
  Shape sh;
  cudaError_t err = launch_shape(voxel_matvec_tc<T>, L::MATVEC_SMEM, cache, sh);
  if (err != cudaSuccess) return (int)err;
  const int cols =
      ((ny + 1 + TE - 2) / (TE - 1)) * ((nz + 1 + TE - 2) / (TE - 1));
  // Set-up of a block: about two layers' time, and one halo layer.
  const int chunk = chunk_length(nx + 1, cols, sh.sms, sh.per_sm, 3);
  const dim3 grid(cols, (nx + 1 + chunk - 1) / chunk);
  voxel_matvec_tc<T><<<grid, kTC, L::MATVEC_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(scale),
      static_cast<const float*>(ke), static_cast<T*>(out), nx, ny, nz, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_energies_tc(const void* u, const void* ke, void* out, int nx,
                       int ny, int nz, void* stream) {
  using L = Tile<T>;
  static Shape cache[64] = {};
  Shape sh;
  cudaError_t err =
      launch_shape(voxel_energies_tc<T>, L::ENERGIES_SMEM, cache, sh);
  if (err != cudaSuccess) return (int)err;
  const int cols = ((ny + TE - 1) / TE) * ((nz + TE - 1) / TE);
  // Set-up of a block: about two layers' time.
  const int chunk = chunk_length(nx, cols, sh.sms, sh.per_sm, 2);
  const dim3 grid(cols, (nx + chunk - 1) / chunk);
  voxel_energies_tc<T><<<grid, kTC, L::ENERGIES_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const float*>(ke),
      static_cast<T*>(out), nx, ny, nz, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns cudaGetLastError()
// after the launch (0 = success).  ke is a device pointer to the 24x24
// element matrix in the compute type (double for f64, float otherwise).
extern "C" {

int voxel_matvec_f64(const void* u, const void* scale, const void* ke,
                     void* out, int nx, int ny, int nz, void* stream) {
  return launch_matvec_simple<double, double>(u, scale, ke, out, nx, ny, nz,
                                              stream);
}
int voxel_matvec_f32(const void* u, const void* scale, const void* ke,
                     void* out, int nx, int ny, int nz, void* stream) {
  return launch_matvec_tc<float>(u, scale, ke, out, nx, ny, nz, stream);
}
int voxel_matvec_bf16(const void* u, const void* scale, const void* ke,
                      void* out, int nx, int ny, int nz, void* stream) {
  return launch_matvec_tc<__nv_bfloat16>(u, scale, ke, out, nx, ny, nz,
                                         stream);
}

int voxel_energies_f64(const void* u, const void* ke, void* out, int nx,
                       int ny, int nz, void* stream) {
  return launch_energies_simple<double, double>(u, ke, out, nx, ny, nz,
                                                stream);
}
int voxel_energies_f32(const void* u, const void* ke, void* out, int nx,
                       int ny, int nz, void* stream) {
  return launch_energies_tc<float>(u, ke, out, nx, ny, nz, stream);
}
int voxel_energies_bf16(const void* u, const void* ke, void* out, int nx,
                        int ny, int nz, void* stream) {
  return launch_energies_tc<__nv_bfloat16>(u, ke, out, nx, ny, nz, stream);
}

}  // extern "C"
