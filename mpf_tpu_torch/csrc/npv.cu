// Kernel 8 (npv_inv) and 8b (npv): no-pivot LU of the r x r diagonal block
// in fp32, with (8) or without (8b) the fused triangular inverses.
//
// Replaces: mpf_tpu/ops/panel_pallas.py:_npv_inv_kernel (via
// getf2_npv_inv_block) and _npv_kernel (via getf2_npv_block).
//   for j < r: info = first j + 1 with pivot b[j, j] == 0;
//              mult_i = b[i, j] / pivot (i > j, true divide);
//              b[i, c] -= mult_i b[j, c] (c > j, one fused multiply-add);
//              b[i, j] = mult_i;
//              (8) L^{-1}[i, :] -= mult_i L^{-1}[j, :] (Gauss-Jordan);
//   (8) U^{-1} by back substitution, row by row from the bottom:
//       Y[i, c] = (delta_ic - sum_{k>i} U[i, k] Y[k, c]) / U[i, i].
// The elimination rounds as ops/getf2.py:getf2_npv (and XLA on the CPU), so
// the LU and L^{-1} are bit-identical to the plain version.
//
// What bounds it on the H100: the r-step dependent chains (the elimination
// and, for 8, the back substitution), not flops (4 r^3 / 3) or bytes (4 r^2
// floats).
//
// Design, r <= 128: kernel 2's diagonal routines (csrc/npv_tile.cuh) on the
// r contiguous rows of the block, in ONE launch of one block of 1024
// threads: the elimination in registers (one block barrier a step), the
// tile through shared memory to LU and L^{-1} (coalesced), then, for 8,
// U^{-1}'s back substitution on ceil(r / 32) warps of the same block, one
// column a lane (kernel 2 runs its chains in a second launch beside the
// U12 tiles; here nothing runs beside them, and one launch measured faster
// than two).  The outputs are bitwise kernel 2's on the same rows.
// r > 128 (the masked path's r = 256 panels): the earlier design, one block
// of 1024 threads stepping through the block with two block barriers a step
// and r back-substitution steps, in dynamic shared memory where it fits and
// on the output buffers in global memory beyond.
#include "npv_tile.cuh"

namespace {

using npv_tile::kN;
using npv_tile::kP;
using npv_tile::kYs;
constexpr int kThreads = 1024;

// row i, column c of the block at `in` (leading dimension ld)
struct StridedRows {
  const float* in;
  i64 ld;
  __device__ __forceinline__ float at(int i, int c) const { return in[(i64)i * ld + c]; }
};

// U's entry (i, k), k >= i, from the packed LU in shared memory
struct PackedU {
  const float* sl;
  __device__ __forceinline__ float operator()(int i, int k) const { return sl[i * kP + k]; }
};

// dynamic shared memory of npv_tile_kernel: sl, sw (kN x kP each); for the
// back substitution (kInv) also ud (kN) and kN / 32 warps' columns
constexpr size_t tile_smem(bool inv) {
  return ((size_t)2 * kN * kP + (inv ? kN + kN * kYs : 0)) * sizeof(float);
}

template <bool kInv>
__global__ void __launch_bounds__(kThreads, 1)
    npv_tile_kernel(int r, const float* __restrict__ in, i64 ld, float* __restrict__ lu,
                    float* __restrict__ linv, float* __restrict__ uinv,
                    int* __restrict__ info_out) {
  extern __shared__ __align__(16) float dsm[];
  float* sl = dsm;             // kN x kP: the block, then the packed LU
  float* sw = dsm + kN * kP;   // kN x kP: W; then U^{-1}'s operand us (kN x kN)
  float* ud = sw + kN * kP;    // kN: U's diagonal
  float* ys = ud + kN;         // a back-substitution warp's 32 columns, kYs each
  __shared__ __align__(16) float mcol[2][kN];
  __shared__ int info;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  float W[4][4];
  npv_tile::eliminate(r, StridedRows{in, ld}, W, sl, mcol, &info);
  npv_tile::tile_to_shared(W, sl, sw);
  __syncthreads();
  if (tid == 0) *info_out = info;
  for (int e = tid; e < r * r; e += kThreads) {
    const int i = e / r, c = e - i * r;
    lu[e] = sl[i * kP + c];
    if constexpr (kInv) {
      linv[e] = c < i ? sw[i * kP + c] : (c == i ? 1.0f : 0.0f);
    }
  }
  if constexpr (kInv) {
    const int nbs = (r + 31) >> 5;
    __syncthreads();  // sw read; it now takes us
    npv_tile::bs_stage(r, PackedU{sl}, sw, ud, ys, 32 * nbs, tid, kThreads);
    __syncthreads();
    if (w < nbs) npv_tile::bs_chain<float>(r, 32 * w, sw, ud, ys + 32 * w * kYs, uinv, lane);
  }
}

// r > 128: the block, L^{-1} and U^{-1} in dynamic shared memory where they
// fit (in_smem), else in the output buffers
template <bool kInv>
__global__ void __launch_bounds__(kThreads)
    npv_wide_kernel(int r, const float* __restrict__ in, i64 ld, float* lu_out,
                    float* linv_out, float* uinv_out, int* __restrict__ info_out,
                    int in_smem) {
  extern __shared__ float sm[];
  __shared__ int info;
  float* mult = sm;                                   // r
  float* blk = in_smem ? sm + r : lu_out;             // r x r: the block, then its LU
  float* li = in_smem ? blk + r * r : linv_out;       // r x r: L^{-1}
  float* y = in_smem ? li + r * r : uinv_out;         // r x r: U^{-1}
  const int tid = threadIdx.x;
  const int rr = r * r;
  for (int e = tid; e < rr; e += kThreads) {
    int i = e / r, c = e % r;
    blk[e] = in[(i64)i * ld + c];
    if (kInv) {
      li[e] = i == c ? 1.0f : 0.0f;
      y[e] = 0.0f;
    }
  }
  if (tid == 0) info = 0;
  __syncthreads();
  for (int j = 0; j < r; ++j) {
    const float pv = blk[j * r + j];
    const float safe = pv == 0.0f ? 1.0f : pv;
    if (tid == 0 && pv == 0.0f && info == 0) info = j + 1;
    for (int i = tid; i < r; i += kThreads) mult[i] = i > j ? __fdiv_rn(blk[i * r + j], safe) : 0.0f;
    __syncthreads();
    const int nb = r - j - 1;
    for (int e = tid; e < nb * r; e += kThreads) {
      int i = j + 1 + e / r, c = e % r;
      float mi = mult[i];
      if (c == j)
        blk[i * r + c] = mi;
      else if (c > j)
        blk[i * r + c] = fmaf(-mi, blk[j * r + c], blk[i * r + c]);
      // row j of L^{-1} is zero right of the diagonal
      if (kInv && c <= j) li[i * r + c] = fmaf(-mi, li[j * r + c], li[i * r + c]);
    }
    __syncthreads();
  }
  if (kInv) {
    for (int i = r - 1; i >= 0; --i) {
      const float uii = blk[i * r + i];
      const float safe = uii == 0.0f ? 1.0f : uii;
      for (int c = tid; c < r; c += kThreads) {
        float acc = 0.0f;
        for (int k = i + 1; k < r; ++k) acc = fmaf(blk[i * r + k], y[k * r + c], acc);
        y[i * r + c] = __fdiv_rn(__fsub_rn(c == i ? 1.0f : 0.0f, acc), safe);
      }
      __syncthreads();
    }
  }
  if (in_smem) {
    for (int e = tid; e < rr; e += kThreads) {
      lu_out[e] = blk[e];
      if (kInv) {
        linv_out[e] = li[e];
        uinv_out[e] = y[e];
      }
    }
  }
  if (tid == 0) *info_out = info;
}

template <bool kInv>
int launch(int r, const float* in, i64 ld, float* lu, float* linv, float* uinv, int* info,
           cudaStream_t stream) {
  if (r <= kN) {
    const void* fn = (const void*)npv_tile_kernel<kInv>;
    const size_t smem = tile_smem(kInv);
    cudaError_t err = dyn_smem(fn, (int)smem);
    if (err != cudaSuccess) return (int)err;
    npv_tile_kernel<kInv><<<1, kThreads, smem, stream>>>(r, in, ld, lu, linv, uinv, info);
    return (int)cudaGetLastError();
  }
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const size_t nblk = kInv ? 3 : 1;
  size_t smem = ((size_t)r + nblk * r * r) * sizeof(float);
  int in_smem = smem + 1024 <= (size_t)optin;
  if (!in_smem) smem = (size_t)r * sizeof(float);
  if (smem + 1024 > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = dyn_smem((const void*)npv_wide_kernel<kInv>, (int)smem);
  if (err != cudaSuccess) return (int)err;
  npv_wide_kernel<kInv><<<1, kThreads, smem, stream>>>(r, in, ld, lu, linv, uinv, info,
                                                       in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// LU (r x r, row-major, contiguous), L^{-1} and U^{-1} (with_inv) and info
// of the r x r block at `in` (leading dimension ld).
MPF_API int mpf_npv(int r, const float* in, i64 ld, float* lu, float* linv, float* uinv,
                    int* info, int with_inv, void* stream) {
  if (r <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_inv ? launch<true>(r, in, ld, lu, linv, uinv, info, st)
                  : launch<false>(r, in, ld, lu, linv, uinv, info, st);
}
