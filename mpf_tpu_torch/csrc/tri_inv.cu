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
// What bounds it on the H100: r sequential steps of an r x r rank-1 update
// (r = 128: ~2 MFLOP per leaf) — latency of the step chain, not flops or
// bytes.
//
// Design: the leaves of one block column's recursion are independent, so one
// launch inverts all of them, one block per leaf; each block keeps its leaf
// inverse in shared memory (64 KB at 128 x 128, fp32 values) for the whole
// chain and writes it out once.  The updates round as the plain PyTorch
// version does, so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T> __device__ __forceinline__ float sub_mul(float b, float m, float u);
template <> __device__ __forceinline__ float sub_mul<float>(float b, float m, float u) {
  return fmaf(-m, u, b);
}
template <> __device__ __forceinline__ float sub_mul<__nv_bfloat16>(float b, float m, float u) {
  return round_to<__nv_bfloat16>(__fsub_rn(b, round_to<__nv_bfloat16>(__fmul_rn(m, u))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tri_inv_kernel(const T* __restrict__ l, i64 ld, const int* __restrict__ offs,
                   const int* __restrict__ sizes, T* __restrict__ out, i64 ldo) {
  extern __shared__ float li[];  // s x s
  __shared__ float mult[128];
  const int o = offs[blockIdx.x];
  const int s = sizes[blockIdx.x];
  const T* lb = l + (i64)o * ld + o;
  for (int e = threadIdx.x; e < s * s; e += kThreads)
    li[e] = (e / s == e % s) ? 1.0f : 0.0f;
  __syncthreads();
  for (int j = 0; j < s; ++j) {
    for (int i = threadIdx.x; i < s; i += kThreads)
      mult[i] = i > j ? to_f32(lb[(i64)i * ld + j]) : 0.0f;
    __syncthreads();
    // rows below j; columns <= j are the only nonzero ones of row j
    for (int e = threadIdx.x; e < (s - j - 1) * (j + 1); e += kThreads) {
      int i = j + 1 + e / (j + 1), c = e % (j + 1);
      li[i * s + c] = sub_mul<T>(li[i * s + c], mult[i], li[j * s + c]);
    }
    __syncthreads();
  }
  T* ob = out + (i64)o * ldo + o;
  for (int e = threadIdx.x; e < s * s; e += kThreads)
    ob[(i64)(e / s) * ldo + e % s] = from_f32<T>(li[e]);
}

template <typename T>
int launch(int nleaves, int max_size, const T* l, i64 ld, const int* offs,
           const int* sizes, T* out, i64 ldo, cudaStream_t st) {
  size_t smem = (size_t)max_size * max_size * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tri_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tri_inv_kernel<T><<<nleaves, kThreads, smem, st>>>(l, ld, offs, sizes, out, ldo);
  return (int)cudaGetLastError();
}

}  // namespace

// Invert the unit-lower leaves at diagonal offsets offs[i] (sizes[i] <= 128)
// of the matrix l (leading dimension ld) into the same positions of out;
// bf16 != 0: l and out are bf16, else fp32.
MPF_API int mpf_tri_inv(int nleaves, int max_size, const void* l, i64 ld, const int* offs,
                        const int* sizes, void* out, i64 ldo, int bf16, void* stream) {
  if (max_size > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (bf16)
    return launch<bf>(nleaves, max_size, (const bf*)l, ld, offs, sizes, (bf*)out, ldo, st);
  return launch<float>(nleaves, max_size, (const float*)l, ld, offs, sizes, (float*)out,
                       ldo, st);
}
