// Kernel 5: inverse of unit-lower-triangular leaves (<= 128 x 128).
//
// Replaces: mpf_tpu/ops/panel_pallas.py:_tri_inv_kernel (via
// unit_lower_inv_pallas), the leaf of blas3.unit_lower_inv_blocked.
// Gauss-Jordan accumulation: out = I; for j: out[i, :] -= l[i, j] * out[j, :]
// for every i > j (the multipliers of a unit-lower matrix are its
// subdiagonal entries; the diagonal of the input is ignored).
//
// What bounds it on the H100: r sequential steps of an r x r rank-1 update
// (r = 128: ~2 MFLOP per leaf) — latency of the step chain, not flops or
// bytes.
//
// Design: the leaves of one block column's recursion are independent, so one
// launch inverts all of them, one block per leaf; each block keeps its leaf
// inverse in shared memory (64 KB at 128 x 128) for the whole chain and
// writes it out once.  Each update is one fused multiply-add (rounded
// once), as in the plain PyTorch version, so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    tri_inv_kernel(const float* __restrict__ l, i64 ld, const int* __restrict__ offs,
                   const int* __restrict__ sizes, float* __restrict__ out, i64 ldo) {
  extern __shared__ float li[];  // s x s
  __shared__ float mult[128];
  const int o = offs[blockIdx.x];
  const int s = sizes[blockIdx.x];
  const float* lb = l + (i64)o * ld + o;
  for (int e = threadIdx.x; e < s * s; e += kThreads)
    li[e] = (e / s == e % s) ? 1.0f : 0.0f;
  __syncthreads();
  for (int j = 0; j < s; ++j) {
    for (int i = threadIdx.x; i < s; i += kThreads) mult[i] = i > j ? lb[(i64)i * ld + j] : 0.0f;
    __syncthreads();
    // rows below j; columns <= j are the only nonzero ones of row j
    for (int e = threadIdx.x; e < (s - j - 1) * (j + 1); e += kThreads) {
      int i = j + 1 + e / (j + 1), c = e % (j + 1);
      li[i * s + c] = fmaf(-mult[i], li[j * s + c], li[i * s + c]);
    }
    __syncthreads();
  }
  float* ob = out + (i64)o * ldo + o;
  for (int e = threadIdx.x; e < s * s; e += kThreads) ob[(i64)(e / s) * ldo + e % s] = li[e];
}

}  // namespace

// Invert the unit-lower leaves at diagonal offsets offs[i] (sizes[i] <= 128)
// of the matrix l (leading dimension ld) into the same positions of out.
MPF_API int mpf_tri_inv(int nleaves, int max_size, const float* l, i64 ld,
                        const int* offs, const int* sizes, float* out, i64 ldo,
                        void* stream) {
  if (max_size > 128) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)max_size * max_size * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tri_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tri_inv_kernel<<<nleaves, kThreads, smem, (cudaStream_t)stream>>>(l, ld, offs, sizes,
                                                                    out, ldo);
  return (int)cudaGetLastError();
}
