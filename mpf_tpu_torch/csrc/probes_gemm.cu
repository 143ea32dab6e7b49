// Kernels 16d and 16k: the GEMM probes of tools/ on the card.
//
// Replaces:
//   16k tools/tpu_crash_bisect_r5.py:try_dot kern (:42)
//       out (s, w) = bf16(A @ B), bf16 operands, fp32 accumulation
//       -> mpf_probe_dot
//   16d tools/tpu_probe_r4.py:probe_overlap kern (:215)
//       steps repeats of d = L (ti, kk) @ U (kk, t), bf16 operands, fp32
//       accumulation; out (1, 1) = the sum over the steps, in step order, of
//       d[0, 0] in fp32.  Each step also streams `extra` bytes of reads from
//       a (rows, w) bf16 array, in 16-row chunks at rows ((step * xrows + j)
//       * 16) mod (rows - 16), j < xrows, and discards them
//       -> mpf_probe_overlap
//
// What bounds them on the H100: operations, 2 s k w (16k) and 2 ti kk t *
// steps (16d) over the bf16 tensor-core rate; 16d also moves steps * xrows
// chunks of 16 rows, which is the question it asks: how many bytes ride
// free under tensor-core work.  The GEMM is the port's tile routine
// (gemm::tile_mma in common.cuh: 128 x 128 x 32 tiles staged through shared
// memory synchronously, warp-level mma.sync), so it runs far below the
// tensor-core peak; the answer is this routine's, the one kernels 3, 6, 12
// and 13 run.
//
// Design: 16k is tile_mma with its store epilogue (kEpiStore), one 128 x
// 128 output tile a block.  16d runs one block an output tile of d, each
// with nine warps.  Warps 0-7 run tile_mma `steps` times with the fold
// epilogue: d stays in registers, each thread keeps the sum of its
// accumulators over the steps (written once at the end, so no product is
// dropped), and block 0 writes d[0, 0] to shared memory and adds it to its
// sum; they synchronise on the named barrier 1 instead of __syncthreads.
// Thread 0 publishes the step it has begun in shared memory.  One thread of
// warp 8 streams the block's share of each step's pieces (16 KB, dealt
// round-robin over the blocks) with cp.async.bulk through a 4-slot ring, one
// mbarrier a slot, and issues step s's pieces only once the GEMM has begun
// step s, so the bytes are paced to the steps as the TPU kernel's are.  It
// folds the first word of every piece into a checksum (an XOR) that it
// writes out, which the plain version computes too: a piece not read fails.
#include "common.cuh"

namespace gemm {

namespace {

typedef __nv_bfloat16 bf;

template <typename TC>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(int M, int N, int K, const bf* __restrict__ A, i64 lda, const bf* __restrict__ B,
               i64 ldb, TC* __restrict__ C, i64 ldc) {
  tile_mma<bf, bf, TC, kEpiStore>(M, N, K, A, lda, B, ldb, C, ldc, nullptr, 0,
                                  blockIdx.y * kBM, blockIdx.x * kBN);
}

constexpr int kOverlapThreads = kThreads + 32;  // the tile's 8 warps + 1 streaming warp
constexpr int kPiece = 16384;                  // bytes a streamed slot
constexpr int kSlots = 4;
constexpr int kTileBar = 1;                    // named barrier of the tile's warps

__global__ void __launch_bounds__(kOverlapThreads)
    overlap_kernel(int ti, int t, int kk, const bf* __restrict__ L, const bf* __restrict__ U,
                   float* __restrict__ keep, int steps, const unsigned char* __restrict__ xsrc,
                   int arows, i64 row_bytes, int g, int xrows, unsigned* __restrict__ sink,
                   float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ov_smem[];
  __shared__ volatile int step_at;  // the step the GEMM has begun
  __shared__ float d00;             // block 0: this step's d[0, 0]
  const int b = blockIdx.x;
  if (threadIdx.x == 0) step_at = 0;
  __syncthreads();
  if (threadIdx.x < kThreads) {
    const int tn = (t + kBN - 1) / kBN;
    const int m0 = (b / tn) * kBM, n0 = (b % tn) * kBN;
    float acc = 0.0f, kept = 0.0f;
    for (int s = 0; s < steps; ++s) {
      if (threadIdx.x == 0) step_at = s;
      kept += tile_mma<bf, bf, float, kEpiFold, kTileBar>(
          ti, t, kk, L, kk, U, t, b == 0 ? &d00 : nullptr, 0, nullptr, 0, m0, n0);
      // thread 0 (lane 0 of warp 0) wrote d00 itself
      if (b == 0 && threadIdx.x == 0) acc = __fadd_rn(acc, d00);
    }
    keep[(i64)b * kThreads + threadIdx.x] = kept;
    if (b == 0 && threadIdx.x == 0) out[0] = acc;
    return;
  }
  // warp 8, one thread: pieces b, b + grid, b + 2 grid, ... of each step's
  // xrows chunks of g rows, piece p being piece p % per_chunk of chunk
  // p / per_chunk
  if (threadIdx.x != kThreads) return;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ov_smem);
  unsigned char* ring = ov_smem + 128;
  const i64 chunk_bytes = (i64)g * row_bytes;
  const int per_chunk = (int)((chunk_bytes + kPiece - 1) / kPiece);
  const int pieces = xrows * per_chunk;  // a step's
  const i64 span = arows - g;
  for (int s = 0; s < kSlots; ++s) tma::mbar_init(&bars[s], 1);
  tma::fence_barrier_init();
  unsigned fold = 0;
  i64 k = 0;  // pieces issued
  for (int s = 0; s < steps && b < pieces; ++s) {
    while (step_at < s) __nanosleep(256);
    for (int p = b; p < pieces; p += gridDim.x) {
      const int j = p / per_chunk;
      const i64 off = (i64)(p - j * per_chunk) * kPiece;
      const i64 row0 = (((i64)s * xrows + j) * g) % span;
      const int slot = (int)(k % kSlots);
      if (k >= kSlots) {  // the slot's previous piece has landed: fold it, reuse the slot
        tma::mbar_wait(&bars[slot], (uint32_t)(k / kSlots - 1) & 1);
        fold ^= *reinterpret_cast<const unsigned*>(ring + (i64)slot * kPiece);
        tma::fence_proxy_async();
      }
      tma::load_async(ring + (i64)slot * kPiece, xsrc + row0 * row_bytes + off,
                      (uint32_t)min((i64)kPiece, chunk_bytes - off), &bars[slot]);
      ++k;
    }
  }
  for (i64 q = k > kSlots ? k - kSlots : 0; q < k; ++q) {
    const int slot = (int)(q % kSlots);
    tma::mbar_wait(&bars[slot], (uint32_t)(q / kSlots) & 1);
    fold ^= *reinterpret_cast<const unsigned*>(ring + (i64)slot * kPiece);
  }
  sink[b] = fold;
}

}  // namespace

}  // namespace gemm

// C (M x N, row stride ldc) = bf16(A @ B) for bf16 A (M x K) and B (K x N),
// fp32 accumulation on the tensor cores.
MPF_API int mpf_probe_dot(int M, int N, int K, const void* A, i64 lda, const void* B, i64 ldb,
                          void* C, i64 ldc, void* stream) {
  using namespace gemm;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dot_kernel<bf><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      M, N, K, (const bf*)A, lda, (const bf*)B, ldb, (bf*)C, ldc);
  return (int)cudaGetLastError();
}

// steps repeats of d (ti x t) = L (ti x kk) @ U (kk x t) on the tensor
// cores, d kept in registers; out[0] = the in-order fp32 sum of d[0, 0] over
// the steps; keep (blocks x 256 fp32) = each thread's sum of its accumulators
// over the steps.  Step s also reads xrows chunks of g rows of the (arows,
// row_bytes / 2) bf16 array xsrc (row_bytes a multiple of 16), chunk j at
// row ((s * xrows + j) * g) mod (arows - g), in 16 KB pieces dealt
// round-robin over the ceil(ti/128) * ceil(t/128) blocks; sink[b] = the XOR
// of the first 32-bit word of every piece block b read.
MPF_API int mpf_probe_overlap(int ti, int t, int kk, const void* L, const void* U, void* keep,
                              int steps, const void* xsrc, int arows, i64 row_bytes,
                              int g, int xrows, void* sink, void* out, void* stream) {
  using namespace gemm;
  const int blocks = ((ti + kBM - 1) / kBM) * ((t + kBN - 1) / kBN);
  const size_t smem = 128 + (size_t)kSlots * kPiece;
  cudaError_t err = dyn_smem((const void*)overlap_kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  overlap_kernel<<<blocks, kOverlapThreads, smem, (cudaStream_t)stream>>>(
      ti, t, kk, (const bf*)L, (const bf*)U, (float*)keep, steps, (const unsigned char*)xsrc,
      arows, row_bytes, g, xrows, (unsigned*)sink, (float*)out);
  return (int)cudaGetLastError();
}
