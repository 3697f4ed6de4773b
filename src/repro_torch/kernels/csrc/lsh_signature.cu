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
// row-major and contiguous.  The bias is added in fp32 and the sum divided
// by r in IEEE fp32 (not multiplied by 1/r), as numpy's float32 arithmetic
// in core/lsh.py does.  The floor turns a last-bit difference of summation
// order into a different bucket when the exact value sits at a bucket edge,
// so the kernel is held against its plain version except at such edges
// (ref.lsh_edges).
//
// What bounds it on the H100: bytes, once the products run on the tensor
// cores.  At one chunk of the index build ([65,536, 4096] @ [4096, 64]) x is
// 1.07 GB, 0.32 ms at 3.35 TB/s; the 34.4 GFLOP take 0.51 ms on the fp32
// CUDA cores (67 TFLOP/s), so no CUDA-core body reaches the byte bound.
// Three tf32 products (below) are 103 GFLOP, 0.21 ms at 495 TFLOP/s.
//
// Two bodies, chosen by the wrapper (ops.lsh_variant):
//
//  * tf32x3 (dim % 4 == 0, nh % 2 == 0): fp32-level products on
//    the tf32 tensor cores.  A value v splits into hi = v with its low 13
//    mantissa bits cleared (exact in tf32) and lo = v - hi (exact in fp32,
//    then rounded to tf32), and x P = x_hi P_hi + x_hi P_lo + x_lo P_hi
//    drops only x_lo P_lo and lo's rounding: about 2^-22 of each term.  A
//    first small kernel splits P once a call into [2, nh, dim] (K-major, as
//    wgmma's tf32 B must be) in a workspace the wrapper allocates.  The main
//    kernel is persistent (one CTA an SM, walking 128-row x 64-hash tiles)
//    with one TMA producer warp and two consumer warpgroups of 64 rows.  The
//    producer streams [128, 32] boxes of x and [64, 32] boxes of P_hi and
//    P_lo through a ring of kStages stages (128-byte rows, 128-byte
//    swizzle; full / empty mbarriers); ragged n, dim and nh arrive as zeros.
//    A consumer loads its x fragments from the swizzled stage
//    (conflict-free), splits them in registers, then issues the three
//    wgmma m64n64k8 a k8 step (A from registers, B by descriptor) into a
//    stage accumulator.  The tensor cores' fp32 adder need not round to
//    nearest, so each 32-deep stage's sum is added to the running total
//    with an IEEE fp32 add: a biased rounding error stays relative to one
//    stage's partial sum instead of growing with dim.  The epilogue adds the bias,
//    divides and floors on the accumulator registers and writes int32
//    pairs straight to global memory, so it overlaps the producer's loads
//    of the next tile.
//  * fma (every other shape): IEEE fp32 on the CUDA cores, one fmaf a term,
//    k ascending (the port's first kernel, unchanged).  One block of 256
//    threads computes a 64-row x 64-hash tile, staging 32-deep x and P
//    tiles in shared memory; each thread keeps a 4 x 4 micro-tile of sums
//    in registers.  Ragged n, dim and nh are masked in the kernel: masked
//    loads read 0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// round-to-nearest add and division: never contracted into an FMA, never
// turned into a multiply by 1/r
__device__ __forceinline__ int32_t bucket(float sum, float b, float r) {
  return (int32_t)floorf(__fdiv_rn(__fadd_rn(sum, b), r));
}

// ----------------------------------------------------------------- fma --
constexpr int kRows = 64;      // blocks (rows of x) a CUDA block computes
constexpr int kHashes = 64;    // hashes a CUDA block computes
constexpr int kDepth = 32;     // k step staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kMicro = 4;

__global__ void __launch_bounds__(kThreads)
lsh_fma_kernel(const float* __restrict__ x, const float* __restrict__ proj,
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
      out[gr * nh + gh] = bucket(acc[i][j], bias[gh], r);
    }
  }
}

// -------------------------------------------------------------- tf32x3 --
constexpr uint32_t kHiMask = 0xffffe000u;   // clears the low 13 mantissa bits
constexpr int kStages = 6;
constexpr int TM = 128;                      // rows of x a tile (2 warpgroups)
constexpr int TN = 64;                       // hashes a tile (wgmma N)
constexpr int TK = 32;                       // k a stage: one 128-byte row
constexpr int kXBytes = TM * TK * 4;         // 16 KB
constexpr int kPBytes = TN * TK * 4;         // 8 KB each of P_hi, P_lo
constexpr int kStageBytes = kXBytes + 2 * kPBytes;
constexpr int kWgThreads = 2 * 128 + 32;     // two consumer warpgroups + producer warp
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;

// ws[0][h][k] = hi(P[k][h]), ws[1][h][k] = tf32(P[k][h] - hi): P transposed
// through a 32 x 32 shared tile, so reads and writes are both coalesced
__global__ void __launch_bounds__(256)
split_proj_kernel(const float* __restrict__ proj, float* __restrict__ ws,
                  int64_t dim, int64_t nh) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t k0 = (int64_t)blockIdx.x * 32, h0 = (int64_t)blockIdx.y * 32;
  for (int i = ty; i < 32; i += 8) {
    const int64_t k = k0 + i, h = h0 + tx;
    tile[i][tx] = (k < dim && h < nh) ? proj[k * nh + h] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int64_t h = h0 + i, k = k0 + tx;
    if (h >= nh || k >= dim) continue;
    const float v = tile[tx][i];
    const float hi = __uint_as_float(__float_as_uint(v) & kHiMask);
    ws[h * dim + k] = hi;
    ws[nh * dim + h * dim + k] = __uint_as_float(to_tf32(v - hi));
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
lsh_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap pmap,
                  const float* __restrict__ bias, int32_t* __restrict__ out,
                  int64_t n, int64_t dim, int64_t nh, float r) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int nk = (int)((dim + TK - 1) / TK);
  const int nht = (int)((nh + TN - 1) / TN);
  const int ntiles = (int)((n + TM - 1) / TM) * nht;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {                                 // producer warp
    if (tid == 256) {
      tma_prefetch(&xmap);
      tma_prefetch(&pmap);
      int step = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row0 = (tile / nht) * TM, hash0 = (tile % nht) * TN;
        for (int kt = 0; kt < nk; ++kt, ++step) {
          const int s = step % kStages;
          if (step >= kStages)
            mbar_wait(&empty[s], (uint32_t)((step / kStages - 1) & 1));
          uint8_t* st = smem + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &xmap, &full[s], kt * TK, row0);
          tma_load_3d(st + kXBytes, &pmap, &full[s], kt * TK, hash0, 0);
          tma_load_3d(st + kXBytes + kPBytes, &pmap, &full[s], kt * TK, hash0, 1);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % 32, warp = t / 32;
  // this thread's A-fragment rows (v = 0, 1) and k column (v = 0; + 4 for v = 2)
  const int ra = 16 * warp + lane / 4;              // and ra + 8
  const int ka = lane % 4;
  float acc[32], total[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = (tile / nht) * TM, hash0 = (tile % nht) * TN;
#pragma unroll
    for (int i = 0; i < 32; ++i) total[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++step) {
      const int s = step % kStages;
      mbar_wait(&full[s], (uint32_t)((step / kStages) & 1));
      const uint8_t* xs = smem + s * kStageBytes + wg * 64 * 128;
      const uint8_t* ph = smem + s * kStageBytes + kXBytes;
      const uint8_t* pl = ph + kPBytes;
      // every A fragment of the stage first (x_hi, x_lo), then the wgmmas:
      // no register copy defines an operand between two of them.  Row r's
      // 16-byte chunk c sits at chunk c ^ (r % 8) (128-byte swizzle).
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = ra + 8 * (v & 1);
          const int chunk = 2 * kk + (v >> 1);
          const float xv = *reinterpret_cast<const float*>(
              xs + row * 128 + ((chunk ^ (row & 7)) << 4) + ka * 4);
          const uint32_t hi = __float_as_uint(xv) & kHiMask;
          ah[kk][v] = hi;
          al[kk][v] = to_tf32(xv - __uint_as_float(hi));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // k8 step kk: 32 bytes along the 128-byte rows of P's boxes
        const uint64_t dh = make_desc(ph + kk * 32, 16, 1024, kSwizzle128);
        const uint64_t dl = make_desc(pl + kk * 32, 16, 1024, kSwizzle128);
        wgmma_rs_tf32_n64(acc, al[kk], dh, kk > 0);   // small terms first
        wgmma_rs_tf32_n64(acc, ah[kk], dl, 1);
        wgmma_rs_tf32_n64(acc, ah[kk], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ah);
      fence_regs(al);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 32; ++i) total[i] = __fadd_rn(total[i], acc[i]);
    }
    // columns 2c, 2c + 1 of a row: nh is even, so both exist or neither
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int64_t row = row0 + 64 * wg + acc_row(t, i);
      const int64_t col = hash0 + acc_col(t, i);
      if (row < n && col < nh) {
        const int2 v = make_int2(bucket(total[i], __ldg(bias + col), r),
                                 bucket(total[i + 1], __ldg(bias + col + 1), r));
        *reinterpret_cast<int2*>(out + row * nh + col) = v;
      }
    }
  }
}

int launch_tf32x3(const float* x, const float* proj, const float* bias,
                  int32_t* out, float* ws, int64_t n, int64_t dim, int64_t nh,
                  float r, cudaStream_t stream) {
  const dim3 sgrid((unsigned)((dim + 31) / 32), (unsigned)((nh + 31) / 32));
  split_proj_kernel<<<sgrid, 256, 0, stream>>>(proj, ws, dim, nh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap xmap, pmap;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t xdims[2] = {(cuuint64_t)dim, (cuuint64_t)n};
  const cuuint64_t xstr[1] = {(cuuint64_t)dim * 4};
  const cuuint32_t xbox[2] = {TK, TM};
  int err = encode_map(&xmap, f32, 2, x, xdims, xstr, xbox, sw);
  if (err) return err;
  // the workspace [2, nh, dim]: hi at coordinate 0, lo at 1
  const cuuint64_t pdims[3] = {(cuuint64_t)dim, (cuuint64_t)nh, 2};
  const cuuint64_t pstr[2] = {(cuuint64_t)dim * 4, (cuuint64_t)(nh * dim * 4)};
  const cuuint32_t pbox[3] = {TK, TN, 1};
  err = encode_map(&pmap, f32, 3, ws, pdims, pstr, pbox, sw);
  if (err) return err;
  static bool opted_in = false;
  err = opt_in_smem(lsh_tf32x3_kernel, kSmem, &opted_in);
  if (err) return err;

  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = ((n + TM - 1) / TM) * ((nh + TN - 1) / TN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  lsh_tf32x3_kernel<<<grid, kWgThreads, kSmem, stream>>>(xmap, pmap, bias, out,
                                                         n, dim, nh, r);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, dim] fp32; proj: [dim, nh] fp32; bias: [nh] fp32; out: [n, nh]
// int32.  variant: 0 = the fma body; 1 = the tf32x3 body, which needs
// dim % 4 == 0 (TMA's 16-byte strides of x and ws), nh % 2 == 0 (int32
// pairs), x 16-byte aligned and ws, an fp32
// workspace of 2 * nh * dim elements, 16-byte aligned (ws is unused by the
// fma body).  Returns cudaGetLastError() after the launches (0 on success)
// or cudaErrorInvalidValue for a shape the body does not take.
extern "C" int lsh_signature(const void* x, const void* proj, const void* bias,
                             void* out, void* ws, int64_t n, int64_t dim,
                             int64_t nh, float r, int64_t variant,
                             void* stream) {
  if (n <= 0 || nh <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* pf = static_cast<const float*>(proj);
  const float* bf = static_cast<const float*>(bias);
  int32_t* o = static_cast<int32_t*>(out);
  if (variant == 1) {
    if (dim <= 0 || dim % 4 != 0 || nh % 2 != 0 || ws == nullptr ||
        n > 0x7fffffff || dim > 0x7fffffff ||
        ((n + TM - 1) / TM) * ((nh + TN - 1) / TN) > 0x7fffffff ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(ws) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_tf32x3(xf, pf, bf, o, static_cast<float*>(ws), n, dim, nh, r, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kRows - 1) / kRows),
                  (unsigned)((nh + kHashes - 1) / kHashes));
  lsh_fma_kernel<<<grid, kThreads, 0, s>>>(xf, pf, bf, o, n, dim, nh, r);
  return (int)cudaGetLastError();
}
