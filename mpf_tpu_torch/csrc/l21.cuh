// L21 = A[:, panel] @ U11^{-1}, the L21 pass of kernels 3 (fp32 slabs) and
// 12 (bf16 slabs).
//
// On the (m, bc) slab of storage type T, panel at column jj0, U11^{-1}
// (r x r, T), thr = j0 + r: every entry is one fp32 chain acc = fmaf(a[k],
// u[k], acc) for k = 0, 1, ..., r - 1 from acc = 0 (bf16 products are exact
// in fp32), rounded once to T.  Rows at position >= thr get L21 written
// into their panel columns; every row writes its L21 to the side buffer
// (row stride ldl), zeros on the rows at position < thr, so the update pass
// needs no row mask.
//
// What bounds it on the H100: operations.  2 m r^2 fp32 FMA operations
// (0.54 GFLOP at m = 16384, r = 128: 8.0 us at the 67 TFLOP/s FFMA rate)
// against 6 m r bytes of bf16 traffic (3.8 us at 3.35 TB/s).
//
// Design: the FFMA GEMM of gemm_ffma.cuh, shaped for K = r <= 128.
// - One block of 256 threads a 128-row tile, all r <= 128 output columns
//   (128 blocks at m = 16384: one wave on 132 SMs); 8 x 8 outputs a thread
//   in the FFMA routine's lane layout, so fp32 tiles run its step_products.
// - All of K fits: the tile's panel rows and U11^{-1} land in up to 8
//   16-deep stages, each with its own `full` mbarrier, all issued by one
//   thread at the start as 2-D TMA loads (zero-filled past m and r).  The
//   warps take the stages in order as they land and meet at no block
//   barrier.  Operands TMA cannot read in place (a base or row stride that
//   is no multiple of 16 bytes) take an instance in which every thread
//   copies its elements first, one __syncthreads().
// - bf16 operands stay bf16 in shared memory (32-byte rows of A, 256-byte
//   rows of B: conflict-free 8-byte reads) and are widened to fp32 as they
//   are read, with a shift or a mask: exact.
// - The epilogue writes both outputs from registers with the row mask,
//   vector stores where the addresses allow.
// - Sum order: each entry's chain is ascending k from 0; the zero-filled
//   tail adds fmaf(0, 0, acc) = acc (acc is never -0).  So every entry is
//   the same whatever the tiling or the copy instance, and kernel 10's L21
//   (panel_update_full.cu, one thread an entry, the same chain) is bitwise
//   this one.
#pragma once

#include "gemm_ffma.cuh"

namespace l21 {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kMaxSteps = 128 / kBK;

// shared layout of one 16-deep stage: A (kBM rows of kLdA elements), then B
// (kBK rows of kBN elements); fp32 keeps the FFMA routine's 20-float rows
template <typename T>
struct Stage {
  static constexpr int kLdA = sizeof(T) == 4 ? gemm::ffma::kLdA : kBK;
  static constexpr int kAElems = kBM * kLdA;
  static constexpr uint32_t kBytes = (uint32_t)((kAElems + kBK * kBN) * sizeof(T));
  static constexpr int kSmem = 1024 + kMaxSteps * (int)kBytes + kMaxSteps * 8;
};

struct Args {
  int m, r;
  void* slab;
  i64 ld;
  int jj0;
  const int* pos;
  int thr;
  const void* uinv;
  void* l21buf;
  i64 ldl;
};

// the fp32 value of bf16 number k (0..3) of 4 packed in a uint2
__device__ __forceinline__ float bf16_at(const uint2& u, int k) {
  const uint32_t w = k < 2 ? u.x : u.y;
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

// acc += one 16-deep stage, k ascending for every entry; ar is the
// thread's first tile row (rows ar + 4 i), bc its first column (columns
// bc + j, bc + 32 + j).  fp32: the FFMA routine's own step.
__device__ __forceinline__ void step(const float* As, const float* Bs, int ar, int bc,
                                     float (&acc)[8][8]) {
  gemm::ffma::step_products(As, Bs, ar, bc, acc);
}

__device__ __forceinline__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs, int ar,
                                     int bc, float (&acc)[8][8]) {
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    uint2 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const uint2*>(As + (ar + 4 * i) * kBK + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint2 b0 = *reinterpret_cast<const uint2*>(Bs + (kq + kk) * kBN + bc);
      const uint2 b1 = *reinterpret_cast<const uint2*>(Bs + (kq + kk) * kBN + bc + 32);
      const float b[8] = {bf16_at(b0, 0), bf16_at(b0, 1), bf16_at(b0, 2), bf16_at(b0, 3),
                          bf16_at(b1, 0), bf16_at(b1, 1), bf16_at(b1, 2), bf16_at(b1, 3)};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = bf16_at(a[i], kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
      }
    }
  }
}

// 4 adjacent entries p[0..n) (n <= 4): one vector store where n == 4 and
// the address allows, single entries otherwise
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int n) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = v[j];
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 (&v)[4], int n) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const uint32_t lo = (uint32_t)__bfloat16_as_ushort(v[0]) |
                        (uint32_t)__bfloat16_as_ushort(v[1]) << 16;
    const uint32_t hi = (uint32_t)__bfloat16_as_ushort(v[2]) |
                        (uint32_t)__bfloat16_as_ushort(v[3]) << 16;
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = v[j];
}

namespace {

template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    l21_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
               const __grid_constant__ Args g) {
  using S = Stage<T>;
  extern __shared__ uint8_t l21_smem[];
  uint8_t* base = l21_smem + ((1024 - (tma::smem_addr(l21_smem) & 1023)) & 1023);
  T* stages = reinterpret_cast<T*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kMaxSteps * S::kBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM;
  const int nk = (g.r + kBK - 1) / kBK;
  const T* slab = static_cast<const T*>(g.slab);
  const T* uinv = static_cast<const T*>(g.uinv);

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < nk; ++s) tma::mbar_init(&full[s], 1);
      tma::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < nk; ++s) {
        T* sa = stages + s * (S::kBytes / sizeof(T));
        tma::mbar_arrive_expect_tx(&full[s], S::kBytes);
        gemm::sm90::load_2d(sa, &tmA, s * kBK, m0, &full[s]);
        gemm::sm90::load_2d(sa + S::kAElems, &tmB, 0, s * kBK, &full[s]);
      }
    }
  } else {
    // every thread copies its elements, zeros past m and r
    const int kk = nk * kBK;
    for (int e = tid; e < kBM * kk; e += kThreads) {
      const int row = e / kk, k = e - row * kk, gr = m0 + row;
      const T v = gr < g.m && k < g.r ? slab[(i64)gr * g.ld + g.jj0 + k] : from_f32<T>(0.0f);
      stages[(k / kBK) * (S::kBytes / sizeof(T)) + row * S::kLdA + k % kBK] = v;
    }
    for (int e = tid; e < kk * kBN; e += kThreads) {
      const int k = e / kBN, c = e % kBN;
      const T v = k < g.r && c < g.r ? uinv[k * g.r + c] : from_f32<T>(0.0f);
      stages[(k / kBK) * (S::kBytes / sizeof(T)) + S::kAElems + (k % kBK) * kBN + c] = v;
    }
    __syncthreads();
  }

  const int ar = (warp >> 1) * 32 + (lane >> 3);
  const int bc = (warp & 1) * 64 + (lane & 7) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < nk; ++s) {
    if constexpr (kTma) tma::mbar_wait(&full[s], 0);
    const T* As = stages + s * (S::kBytes / sizeof(T));
    step(As, As + S::kAElems, ar, bc, acc);
  }

  T* out = static_cast<T*>(g.slab);
  T* buf = static_cast<T*>(g.l21buf);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = m0 + ar + 4 * i;
    if (gr >= g.m) continue;
    const bool below = g.pos[gr] >= g.thr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = bc + 32 * h, n = min(4, g.r - c);
      if (n <= 0) continue;
      T v[4], z[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = from_f32<T>(acc[i][4 * h + j]);
        z[j] = from_f32<T>(0.0f);
      }
      if (below) {
        store4(buf + (i64)gr * g.ldl + c, v, n);
        store4(out + (i64)gr * g.ld + g.jj0 + c, v, n);
      } else {
        store4(buf + (i64)gr * g.ldl + c, z, n);
      }
    }
  }
}

// TMA reads an operand in place at a 16-byte base with a row stride that is
// a multiple of 16 bytes
inline bool tma_ok(const void* p, i64 ld, size_t es) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld * (i64)es) % 16 == 0;
}

// map of the row-major (rows x cols) T matrix at `base`, row stride ld
// elements, boxes of box_cols x box_rows, no swizzle, zero fill past the
// logical sizes.  0 or a cudaError_t code.
template <typename T>
int encode(CUtensorMap* map, const void* base, int rows, int cols, i64 ld, uint32_t box_cols,
           uint32_t box_rows) {
  gemm::sm90::EncodeTiled fn = gemm::sm90::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)(ld * (i64)sizeof(T))};
  cuuint32_t box[2] = {box_cols, box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map,
                  sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// L21 of the (m, bc) slab of T (row stride ld), panel at column jj0, into
// the panel (rows at position >= thr) and l21buf (row stride ldl); r <= 128
template <typename T>
int launch(int m, int r, T* slab, i64 ld, int jj0, const int* pos, int thr, const T* uinv,
           T* l21buf, i64 ldl, cudaStream_t st) {
  if (m <= 0 || r <= 0) return (int)cudaGetLastError();
  if (r > kMaxSteps * kBK) return (int)cudaErrorInvalidValue;
  using S = Stage<T>;
  const Args g{m, r, slab, ld, jj0, pos, thr, uinv, l21buf, ldl};
  const T* panel = slab + jj0;
  const bool tma = tma_ok(panel, ld, sizeof(T)) && tma_ok(uinv, r, sizeof(T));
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  memset(&tb, 0, sizeof(tb));
  if (tma) {
    int err = encode<T>(&ta, panel, m, r, ld, S::kLdA, kBM);
    if (!err) err = encode<T>(&tb, uinv, r, r, r, kBN, kBK);
    if (err) return err;
  }
  const void* kern = tma ? (const void*)l21_kernel<T, true> : (const void*)l21_kernel<T, false>;
  cudaError_t e = dyn_smem(kern, S::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (m + kBM - 1) / kBM;
  if (tma)
    l21_kernel<T, true><<<grid, kThreads, S::kSmem, st>>>(ta, tb, g);
  else
    l21_kernel<T, false><<<grid, kThreads, S::kSmem, st>>>(ta, tb, g);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace l21
