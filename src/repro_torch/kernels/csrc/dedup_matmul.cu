// x[M, K] @ W_virtual[K, N], where W is never materialised: tile (k, j) of W is
// block bmap[k, j] of the deduplicated block pool.
//
// Replaces: src/repro/kernels/dedup_matmul.py::dedup_matmul (the Pallas TPU
// kernel, whose scalar-prefetched block map drove the BlockSpec index_map of
// the weight stream).
//
// What bounds it on the H100: at the paper's FFNN shape (x [64, 2048] against
// W1 [2048, 256] in 64x64 blocks) the work is 67 MFLOP over about 2.7 MB, so
// the bound is about 1 us either way; the product must stay in IEEE fp32 (no
// TF32) to keep the 1e-4 fp32 tolerance of the reference tests.
//
// What the design does about it: a simple, right first kernel.  One block of
// 256 threads owns a 32 x 64 output tile inside one storage-block column j and
// walks the contraction dimension itself (the TPU's sequential k grid axis
// becomes a loop inside the block: blocks run in no order on Hopper).  At each
// storage row-block k it reads bmap[k, j] once and offsets the pool pointer by
// it, so shared blocks are simply read again from L2.  The x tile (transposed)
// and the W sub-tile go through shared memory 16 rows of K at a time; every
// thread keeps a 2 x 4 accumulator in registers and adds with fmaf in fp32.
// bf16 inputs are widened with __bfloat162float as they are staged, and the
// result is narrowed with __float2bfloat16.  Ragged M, a storage block depth
// that is not a multiple of 16 and a block width that is not a multiple of 64
// are masked inside the kernel.  It runs on CUDA cores, far from the bound: the
// tensor-core (wgmma) version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, each 2 rows x 4 columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dedup_matmul_kernel(const T* __restrict__ x, const T* __restrict__ pool,
                    const int32_t* __restrict__ bmap, T* __restrict__ out,
                    int64_t M, int64_t nkb, int64_t nnb, int64_t bk, int64_t bn,
                    int64_t chunks) {
  __shared__ float xs[BK][BM];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN];  // W sub-tile:         ws[k][n]

  const int64_t K = nkb * bk;
  const int64_t N = nnb * bn;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t j = (int64_t)blockIdx.y / chunks;         // storage-block column
  const int64_t c0 = ((int64_t)blockIdx.y % chunks) * BN;  // column inside block j
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int64_t kb = 0; kb < nkb; ++kb) {
    const T* blk = pool + (int64_t)bmap[kb * nnb + j] * bk * bn;
    for (int64_t k0 = 0; k0 < bk; k0 += BK) {
      // stage x[m0 : m0+BM, kb*bk + k0 : +BK] -> xs (2 elements a thread)
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int mm = e / BK, kk = e % BK;
        const int64_t m = m0 + mm, k = k0 + kk;
        xs[kk][mm] = (m < M && k < bk) ? to_f32(x[m * K + kb * bk + k]) : 0.f;
      }
      // stage block rows k0 : k0+BK, columns c0 : c0+BN -> ws (4 a thread)
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int kk = e / BN, nn = e % BN;
        const int64_t k = k0 + kk, c = c0 + nn;
        ws[kk][nn] = (k < bk && c < bn) ? to_f32(blk[k * bn + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float a0 = xs[kk][ty * 2], a1 = xs[kk][ty * 2 + 1];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float w = ws[kk][tx * 4 + b];
          acc[0][b] = fmaf(a0, w, acc[0][b]);
          acc[1][b] = fmaf(a1, w, acc[1][b]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int64_t m = m0 + ty * 2 + a;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t c = c0 + tx * 4 + b;
      if (c < bn) from_f32(out + m * N + j * bn + c, acc[a][b]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* pool, const int32_t* bmap, void* out,
            int64_t M, int64_t nkb, int64_t nnb, int64_t bk, int64_t bn,
            cudaStream_t stream) {
  const int64_t chunks = (bn + BN - 1) / BN;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(nnb * chunks));
  dedup_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pool), bmap,
      static_cast<T*>(out), M, nkb, nnb, bk, bn, chunks);
}

}  // namespace

// x: [M, nkb*bk]; pool: [n_blocks, bk, bn]; bmap: [nkb, nnb] int32;
// out: [M, nnb*bn].  dtype: 0 = float32, 1 = bfloat16 (x, pool and out alike).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dedup_matmul(const void* x, const void* pool, const void* bmap,
                            void* out, int64_t M, int64_t nkb, int64_t nnb,
                            int64_t bk, int64_t bn, int64_t dtype, void* stream) {
  if (M <= 0 || nnb <= 0) return (int)cudaGetLastError();
  const int32_t* m = static_cast<const int32_t*>(bmap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, pool, m, out, M, nkb, nnb, bk, bn, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, pool, m, out, M, nkb, nnb, bk, bn, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
