// L2-LSH signatures of flattened tensor blocks: the signature step of the
// dedup index build (paper Sec. 4.2.2, Alg. 1).
//
// Replaces: src/repro/kernels/lsh_signature.py:40 lsh_signature (the Pallas
// TPU kernel, a grid over (row tile, hash tile, k tile) that carries an fp32
// accumulator in VMEM across the sequential k axis and floors it at the last
// k step).
//
// Computes, for every block i < n and hash h < nh:
//   out[i, h] = (int32) floorf((sum_k x[i, k] * P[k, h] + b[h]) / r)
// x [n, dim] fp32, P [dim, nh] fp32, b [nh] fp32, out [n, nh] int32; all
// row-major and contiguous.
//
// Numerics: IEEE fp32 on the CUDA cores -- one fmaf a term, k ascending, no
// TF32 -- then the bias added in fp32 and an IEEE division by r (not a
// multiply by 1/r), as numpy's float32 arithmetic in core/lsh.py does.  The
// floor turns a last-bit difference of summation order into a different
// bucket when the exact value sits at a bucket edge, so the kernel is held
// against its plain version except at such edges (ref.lsh_edges).
//
// What bounds it on the H100: fp32 operations.  At the LM store's full
// variant ([303,621, 4096] @ [4096, 64]) the work is 159.2 GFLOP, 2.38 ms at
// 67 TFLOP/s, against 5.05 GB of bytes, 1.51 ms at 3.35 TB/s: 32 FLOP a byte
// against a ridge of 20.
//
// What the design does about it: the TPU grid's sequential k axis becomes a
// loop inside the block.  One block of 256 threads computes a 64-row x
// 64-hash output tile (every hash of the repo's stores: 64, or 16 for the
// CLI's LM store), staging 32-deep x and P tiles in shared memory; each
// thread keeps a 4 x 4 micro-tile of sums in registers (16 FMAs for 8
// shared-memory loads a k step) and writes the floored int32 from registers.
// Ragged n, dim and nh are masked in the kernel (no padding pass): masked
// loads read 0, which adds exactly 0 to a sum.  A faster kernel (3xTF32 or a
// split on wgmma, TMA staging) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // blocks (rows of x) a CUDA block computes
constexpr int kHashes = 64;    // hashes a CUDA block computes
constexpr int kDepth = 32;     // k step staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kMicro = 4;

__global__ void __launch_bounds__(kThreads)
lsh_signature_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                     const float* __restrict__ bias, int32_t* __restrict__ out,
                     int64_t n, int64_t dim, int64_t nh, float r) {
  // xs is stored transposed, one column of padding: the threads of a warp
  // store 32 consecutive k of one row into 32 different banks
  __shared__ float xs[kDepth][kRows + 1];
  __shared__ float ps[kDepth][kHashes];
  const int t = threadIdx.x;
  const int tx = t % 16;         // hashes tx, tx + 16, tx + 32, tx + 48
  const int ty = t / 16;         // rows ty, ty + 16, ty + 32, ty + 48
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t hash0 = (int64_t)blockIdx.y * kHashes;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < dim; k0 += kDepth) {
#pragma unroll
    for (int i = 0; i < kRows * kDepth / kThreads; ++i) {
      const int idx = t + i * kThreads;
      const int rr = idx / kDepth, kk = idx % kDepth;   // 128-byte row reads
      const int64_t gr = row0 + rr, gk = k0 + kk;
      xs[kk][rr] = (gr < n && gk < dim) ? x[gr * dim + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kHashes * kDepth / kThreads; ++i) {
      const int idx = t + i * kThreads;
      const int kk = idx / kHashes, hh = idx % kHashes;
      const int64_t gk = k0 + kk, gh = hash0 + hh;
      ps[kk][hh] = (gk < dim && gh < nh) ? proj[gk * nh + gh] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = ps[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int64_t gr = row0 + ty + 16 * i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int64_t gh = hash0 + tx + 16 * j;
      if (gh >= nh) continue;
      // explicit round-to-nearest add and division: never contracted into
      // an FMA, never turned into a multiply by 1/r
      const float q = __fdiv_rn(__fadd_rn(acc[i][j], bias[gh]), r);
      out[gr * nh + gh] = (int32_t)floorf(q);
    }
  }
}

}  // namespace

// x: [n, dim] fp32; proj: [dim, nh] fp32; bias: [nh] fp32; out: [n, nh]
// int32.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lsh_signature(const void* x, const void* proj, const void* bias,
                             void* out, int64_t n, int64_t dim, int64_t nh,
                             float r, void* stream) {
  if (n <= 0 || nh <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + kRows - 1) / kRows),
                  (unsigned)((nh + kHashes - 1) / kHashes));
  lsh_signature_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(proj),
      static_cast<const float*>(bias), static_cast<int32_t*>(out), n, dim, nh, r);
  return (int)cudaGetLastError();
}
