// Kernel 5: inverse of unit-lower-triangular leaves (<= 128 x 128).
//
// Replaces: mpf_tpu/ops/panel_pallas.py:_tri_inv_kernel (via
// unit_lower_inv_pallas), the leaf of blas3.unit_lower_inv_blocked.
// Gauss-Jordan accumulation: out = I; for j: out[i, :] -= l[i, j] * out[j, :]
// for every i > j (the multipliers of a unit-lower matrix are its
// subdiagonal entries; the diagonal of the input is ignored).
// Leaves are fp32, or bf16 under ALL_BF16.  Round points, as the JAX CPU
// backend rounds the TPU kernel's `li - mult * lrow` (probed bitwise):
// fp32 one fused multiply-add; bf16 the product rounded to bf16, then the
// difference rounded to bf16.
//
// What bounds it on the H100: the latency of the step chain.  A column's
// entries depend on each other through r - 1 sequential steps, and the
// work is small (~2 MFLOP and 64 KB per 128 x 128 leaf).
//
// Design: in the Gauss-Jordan loop, entry X[i, c] (i > c) is one chain
// X[i, c] = sub_mul(X[i, c], l[i, j], X[j, c]) for j = c .. i - 1 in
// ascending order, starting from 0, and X[j, c] is final when step j
// reads it.  So the columns of the inverse are independent forward
// substitutions, and running each column's chain alone performs the same
// operations in the same order: the bits of the Gauss-Jordan loop (and of
// the plain version, blas3.tri_inv_leaves_plain).
// - The grid is (leaves x column strips of kBlockCols): 8 leaves of 128
//   give 128 blocks, so the whole card works, not 8 of its 132 SMs.
// - A block stages the part of its leaf that its columns read (l[i, j],
//   i > j >= its first column) once, transposed in shared memory as fp32
//   (row j holds column j of the leaf, padded to 129 floats), so step j's
//   multipliers are one conflict-free row read, not a strided global load.
// - Each warp runs kCols columns at once (independent chains for ILP).
//   Lane t holds rows t, t + 32, t + 64, t + 96 of each column; step j
//   passes the pivot X[j, c] from its lane by shuffle, and every lane
//   updates its rows below j.  No block barrier inside the chain.
// - The block's column strip goes through shared memory once more so that
//   it is written out a row segment at a time, every entry of the leaf
//   (the zeros above the diagonal and the unit diagonal too) once.
#include "common.cuh"

namespace {

constexpr int kMax = 128;                  // largest leaf
constexpr int kPitch = kMax + 1;           // floats a staged row
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 2;                   // columns a warp
constexpr int kBlockCols = kWarps * kCols; // columns a block

template <typename T> __device__ __forceinline__ float sub_mul(float b, float m, float u);
template <> __device__ __forceinline__ float sub_mul<float>(float b, float m, float u) {
  return fmaf(-m, u, b);
}
template <> __device__ __forceinline__ float sub_mul<__nv_bfloat16>(float b, float m, float u) {
  return round_to<__nv_bfloat16>(__fsub_rn(b, round_to<__nv_bfloat16>(__fmul_rn(m, u))));
}

// dynamic shared memory for leaves of at most max_size: the staged rows
// j = 0 .. max_size - 2 of the widest strip
inline size_t smem_bytes(int max_size) {
  return (size_t)(max_size > 1 ? max_size - 1 : 1) * kPitch * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tri_inv_kernel(const T* __restrict__ l, i64 ld, const int* __restrict__ offs,
                   const int* __restrict__ sizes, T* __restrict__ out, i64 ldo, int strips) {
  extern __shared__ float lt[];               // lt[(j - c0) * kPitch + i] = l[i, j], i > j
  __shared__ float xs[kMax][kBlockCols + 1];  // the strip's inverse columns
  const int leaf = blockIdx.x / strips;
  const int c0 = (blockIdx.x - leaf * strips) * kBlockCols;
  const int o = offs[leaf], s = sizes[leaf];
  if (c0 >= s) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* lb = l + (i64)o * ld + o;

  // stage l[i, c0 .. i - 1] for rows i > c0: a warp a row, lanes along it
#pragma unroll 4
  for (int i = c0 + 1 + warp; i < s; i += kWarps) {
    const T* row = lb + (i64)i * ld;
#pragma unroll
    for (int t = 0; t < kMax / 32; ++t) {
      const int j = c0 + lane + 32 * t;
      if (j < i) lt[(j - c0) * kPitch + i] = to_f32(row[j]);
    }
  }
  __syncthreads();

  // x[k][q]: row lane + 32 q of column cw + k; the identity's column first
  const int cw = c0 + warp * kCols;
  float x[kCols][kMax / 32];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int q = 0; q < kMax / 32; ++q) x[k][q] = lane + 32 * q == cw + k ? 1.0f : 0.0f;

  // step j: rows i > j of every column c <= j take X[i, c] = sub_mul(X[i, c],
  // l[i, j], X[j, c]); the pivot X[j, c] sits in lane j % 32, slot j / 32
#pragma unroll
  for (int q = 0; q < kMax / 32; ++q) {
    const int jhi = min(32 * q + 32, s - 1);
    for (int j = max(32 * q, cw); j < jhi; ++j) {
      const int jl = j - 32 * q;
      const float* mrow = lt + (j - c0) * kPitch + lane;
      float m[kMax / 32];
#pragma unroll
      for (int qq = q; qq < kMax / 32; ++qq) m[qq] = mrow[32 * qq];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float piv = __shfl_sync(0xffffffffu, x[k][q], jl);
        if (j < cw + k) continue;  // column cw + k starts at step cw + k
#pragma unroll
        for (int qq = q; qq < kMax / 32; ++qq) {
          const float v = sub_mul<T>(x[k][qq], m[qq], piv);
          if (lane + 32 * qq > j) x[k][qq] = v;  // rows >= s are never written out
        }
      }
    }
  }

  // the strip out through shared memory: each entry once, row segments
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int q = 0; q < kMax / 32; ++q)
      if (lane + 32 * q < s) xs[lane + 32 * q][warp * kCols + k] = x[k][q];
  __syncthreads();
  const int w = min(kBlockCols, s - c0);
  T* ob = out + (i64)o * ldo + o + c0;
  for (int e = threadIdx.x; e < s * kBlockCols; e += kThreads) {
    const int i = e / kBlockCols, c = e % kBlockCols;
    if (c < w) ob[(i64)i * ldo + c] = from_f32<T>(xs[i][c]);
  }
}

template <typename T>
int launch(int nleaves, int max_size, const T* l, i64 ld, const int* offs,
           const int* sizes, T* out, i64 ldo, cudaStream_t st) {
  cudaError_t err = dyn_smem((const void*)tri_inv_kernel<T>, (int)smem_bytes(max_size));
  if (err != cudaSuccess) return (int)err;
  const int strips = (max_size + kBlockCols - 1) / kBlockCols;
  tri_inv_kernel<T><<<nleaves * strips, kThreads, smem_bytes(max_size), st>>>(
      l, ld, offs, sizes, out, ldo, strips);
  return (int)cudaGetLastError();
}

}  // namespace

// Invert the unit-lower leaves at diagonal offsets offs[i] (sizes[i] <= 128)
// of the matrix l (leading dimension ld) into the same positions of out;
// bf16 != 0: l and out are bf16, else fp32.
MPF_API int mpf_tri_inv(int nleaves, int max_size, const void* l, i64 ld, const int* offs,
                        const int* sizes, void* out, i64 ldo, int bf16, void* stream) {
  if (max_size > kMax) return (int)cudaErrorInvalidValue;
  if (nleaves <= 0 || max_size <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (bf16)
    return launch<bf>(nleaves, max_size, (const bf*)l, ld, offs, sizes, (bf*)out, ldo, st);
  return launch<float>(nleaves, max_size, (const float*)l, ld, offs, sizes, (float*)out,
                       ldo, st);
}
