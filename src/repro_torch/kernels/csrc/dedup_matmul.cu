// x[M, K] @ W_virtual[K, N], where W is never materialised: tile (k, j) of W is
// block bmap[k, j] of the deduplicated block pool.
//
// Replaces: src/repro/kernels/dedup_matmul.py::dedup_matmul (the Pallas TPU
// kernel, whose scalar-prefetched block map drove the BlockSpec index_map of
// the weight stream).
//
// What bounds it on the H100: at the paper's FFNN shape (x [64, 2048] against
// W1 [2048, 256] in 64x64 blocks) the work is 67 MFLOP over about 2.7 MB, so
// the bound is about 1 us either way; what a launch takes in practice is
// latency, since one block per output tile would be 8 blocks on 132 SMs,
// each walking all of K alone.  An fp32 product must stay in IEEE fp32 (no
// TF32) to keep the 1e-4 tolerance of the reference tests.
//
// What the design does about it:
//  * Split-K over the storage row-blocks: the grid is (M tiles, N tiles,
//    splits) and a block sums a contiguous run of storage blocks kb for one
//    output tile.  The wrapper picks the split count so the grid holds at
//    least 2 x 132 blocks where K allows (256 at the FFNN shape).  Partial
//    sums go in fp32 to a workspace [splits, M, N]; a second small kernel
//    adds them in split order, so the result is bit-identical from call to
//    call (no floating-point atomics).
//  * The block map drives TMA, as it drove the TPU kernel's BlockSpec: the
//    pool is a 3-D tensor map [n_blocks, bk, bn] and a W tile is the box at
//    (column, row, bmap[kb, j]).  A box running past a block's bk rows or bn
//    columns is zero-filled (a 2-D view would read the next block's rows).
//    x is a 3-D map [M, nkb, bk] the same way, so a ragged M or bk is
//    zero-filled on load and masked on store.  A ring of kStages stages with
//    one mbarrier each lets the next storage block's copy overlap the
//    current product.
//  * bf16 with bk a multiple of 16: one warpgroup runs wgmma m64n32k16 with
//    an fp32 accumulator; A is the x tile (K-major, 128-byte swizzle), B the
//    W tile [bk, bn] row-major, i.e. MN-major (64-byte swizzle, transpose
//    bit set).  fp32, and bf16 at other depths: IEEE fp32 fmaf on CUDA cores
//    from the staged tiles, with 16-byte (8-byte for bf16) shared-memory
//    reads; TF32 would break the 1e-4 tolerance, and tf32 wgmma needs a
//    K-major B that the pool does not store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 3;
constexpr int BKT = 64;          // storage-block rows a stage holds (box depth)
// CUDA-core body: 32 x 64 output tile, 256 threads of 2 x 4 outputs
constexpr int FM = 32, FN = 64, kFmaThreads = 256;
// tensor-core body: 64 x 32 output tile, one warpgroup
constexpr int WM = 64, WN = 32, kWgThreads = 128;

__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, bool kWgmma>
struct Tile {
  static constexpr int M = kWgmma ? WM : FM;
  static constexpr int N = kWgmma ? WN : FN;
  static constexpr int kThreads = kWgmma ? kWgThreads : kFmaThreads;
  static constexpr int XB = M * BKT * (int)sizeof(T);   // x stage bytes
  static constexpr int WB = BKT * N * (int)sizeof(T);   // W stage bytes
  static constexpr size_t smem = 1024 + (size_t)kStages * (XB + WB) + 64;
};

// One output tile's partial sum over storage blocks [kb0, kb1).  blockIdx:
// x = M tile, y = (storage column j, column chunk), z = split.
template <typename T, bool kWgmma>
__global__ void __launch_bounds__(Tile<T, kWgmma>::kThreads)
dedup_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const int32_t* __restrict__ bmap, T* __restrict__ out,
                    float* __restrict__ ws, int64_t M, int64_t nkb, int64_t nnb,
                    int64_t bk, int64_t bn, int64_t chunks, int64_t per) {
  using TL = Tile<T, kWgmma>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* xs = smem;                                  // [kStages][M][BKT]
  uint8_t* wsm = smem + kStages * TL::XB;              // [kStages][BKT][N]
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + kStages * TL::WB);

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * TL::M;
  const int64_t j = blockIdx.y / chunks;
  const int64_t c0 = (blockIdx.y % chunks) * TL::N;
  const int64_t kb0 = (int64_t)blockIdx.z * per;
  const int64_t kb1 = kb0 + per < nkb ? kb0 + per : nkb;
  const int64_t kchunks = (bk + BKT - 1) / BKT;
  const int64_t nsteps = (kb1 - kb0) * kchunks;

  if (tid == 0) {
    tma_prefetch(&xmap);
    tma_prefetch(&wmap);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  // the split reduction may be scheduled now; it waits for this grid's end
  grid_launch_dependents();
  __syncthreads();

  // step -> (storage block kb, rows k0 .. k0 + BKT of it), into stage step % kStages
  auto issue = [&](int64_t step) {
    const int s = (int)(step % kStages);
    const int64_t kb = kb0 + step / kchunks;
    const int k0 = (int)((step % kchunks) * BKT);
    const int blk = bmap[kb * nnb + j];
    mbar_expect_tx(&full[s], TL::XB + TL::WB);
    tma_load_3d(xs + s * TL::XB, &xmap, &full[s], k0, (int)kb, (int)m0);
    tma_load_3d(wsm + s * TL::WB, &wmap, &full[s], (int)c0, k0, blk);
  };
  if (tid == 0)
    for (int64_t step = 0; step < nsteps && step < kStages; ++step) issue(step);

  const bool direct = gridDim.z == 1;   // one split: no workspace
  const int64_t N = nnb * bn;
  float* part = ws + (int64_t)blockIdx.z * M * N;

  if constexpr (kWgmma) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int64_t step = 0; step < nsteps; ++step) {
      const int s = (int)(step % kStages);
      mbar_wait(&full[s], (uint32_t)((step / kStages) & 1));
      const uint8_t* xa = xs + s * TL::XB;
      const uint8_t* wb = wsm + s * TL::WB;
      wgmma_fence();
      // rows past bk are zeros in both tiles (TMA's fill): all 4 steps run
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        // A: 64 rows of 128 bytes, 16 k a step = 32 bytes along the row;
        // B: 16 rows of 64 bytes a step
        const uint64_t da = make_desc(xa + kk * 32, 16, 1024, kSwizzle128);
        const uint64_t db = make_desc(wb + kk * 16 * WN * 2, TL::WB, 512,
                                      kSwizzle64);
        wgmma_ss_n32<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncthreads();                        // every warp is past stage s
      if (tid == 0 && step + kStages < nsteps) {
        fence_proxy_async();
        issue(step + kStages);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int64_t m = m0 + acc_row(tid, i);
      const int64_t c = c0 + acc_col(tid, i);
      if (m < M && c < bn) {
        const int64_t o = m * N + j * bn + c;
        if (direct) from_f32(out + o, acc[i]);
        else part[o] = acc[i];
      }
    }
  } else {
    const int ty = tid / 16, tx = tid % 16;
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int64_t step = 0; step < nsteps; ++step) {
      const int s = (int)(step % kStages);
      const int k0 = (int)((step % kchunks) * BKT);
      const int rows = (int)(bk - k0 < BKT ? bk - k0 : BKT);
      const int rows4 = (rows + 3) & ~3;        // rows past bk are zero-filled
      mbar_wait(&full[s], (uint32_t)((step / kStages) & 1));
      const T* xt = reinterpret_cast<const T*>(xs + s * TL::XB);   // [FM][BKT]
      const T* wt = reinterpret_cast<const T*>(wsm + s * TL::WB);  // [BKT][FN]
#pragma unroll 2
      for (int k = 0; k < rows4; k += 4) {
        const float4 a0 = load4(xt + (ty * 2) * BKT + k);
        const float4 a1 = load4(xt + (ty * 2 + 1) * BKT + k);
        const float xa[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w = load4(wt + (k + kk) * FN + tx * 4);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            acc[a][0] = fmaf(xa[a][kk], w.x, acc[a][0]);
            acc[a][1] = fmaf(xa[a][kk], w.y, acc[a][1]);
            acc[a][2] = fmaf(xa[a][kk], w.z, acc[a][2]);
            acc[a][3] = fmaf(xa[a][kk], w.w, acc[a][3]);
          }
        }
      }
      __syncthreads();                        // every thread is past stage s
      if (tid == 0 && step + kStages < nsteps) {
        fence_proxy_async();
        issue(step + kStages);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int64_t m = m0 + ty * 2 + a;
      if (m >= M) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t c = c0 + tx * 4 + b;
        if (c >= bn) continue;
        const int64_t o = m * N + j * bn + c;
        if (direct) from_f32(out + o, acc[a][b]);
        else part[o] = acc[a][b];
      }
    }
  }
}

// out[i] = sum over splits, in split order, of ws[split][i].  The loads
// of 16 splits are issued before their sums, so a thread waits on memory
// once per 16 partials, not once per partial.
template <typename T>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                    int64_t MN, int64_t splits) {
  constexpr int U = 16;
  grid_dependency_wait();           // every partial of the product is written
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    int64_t z = 0;
    for (; z + U <= splits; z += U) {
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] = __ldg(ws + (z + u) * MN + i);
#pragma unroll
      for (int u = 0; u < U; ++u) s += p[u];
    }
    for (; z < splits; ++z) s += __ldg(ws + z * MN + i);
    from_f32(out + i, s);
  }
}

template <typename T, bool kWgmma>
int launch(const void* x, const void* pool, const int32_t* bmap, void* out,
           float* ws, int64_t M, int64_t nblocks, int64_t nkb, int64_t nnb,
           int64_t bk, int64_t bn, int64_t splits, cudaStream_t stream) {
  using TL = Tile<T, kWgmma>;
  const CUtensorMapDataType type = sizeof(T) == 4
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t es = sizeof(T);
  // x [M, K] seen as [M, nkb, bk]; a box is BKT deep, one storage block, M rows
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {(cuuint64_t)bk, (cuuint64_t)nkb, (cuuint64_t)M};
  const cuuint64_t xstr[2] = {bk * es, nkb * bk * es};
  const cuuint32_t xbox[3] = {BKT, 1, TL::M};
  int err = encode_map(&xmap, type, 3, x, xdims, xstr, xbox,
                       kWgmma ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  // pool [n_blocks, bk, bn]; a box is N columns by BKT rows of one block
  const cuuint64_t wdims[3] = {(cuuint64_t)bn, (cuuint64_t)bk, (cuuint64_t)nblocks};
  const cuuint64_t wstr[2] = {bn * es, bk * bn * es};
  const cuuint32_t wbox[3] = {TL::N, BKT, 1};
  err = encode_map(&wmap, type, 3, pool, wdims, wstr, wbox,
                   kWgmma ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;

  static bool opted_in = false;
  err = opt_in_smem(dedup_matmul_kernel<T, kWgmma>, TL::smem, &opted_in);
  if (err) return err;
  const int64_t chunks = (bn + TL::N - 1) / TL::N;
  const int64_t per = (nkb + splits - 1) / splits;
  const dim3 grid((unsigned)((M + TL::M - 1) / TL::M), (unsigned)(nnb * chunks),
                  (unsigned)splits);
  dedup_matmul_kernel<T, kWgmma><<<grid, TL::kThreads, TL::smem, stream>>>(
      xmap, wmap, bmap, static_cast<T*>(out), ws, M, nkb, nnb, bk, bn, chunks,
      per);
  if (splits > 1) {
    // launched as a programmatic dependent of the product, so its launch
    // overlaps the product's run (it waits at griddepcontrol.wait)
    const int64_t MN = M * nnb * bn;
    int64_t blocks = (MN + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, split_reduce_kernel<T>,
                                             (const float*)ws,
                                             static_cast<T*>(out), MN, splits);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [M, nkb*bk]; pool: [nblocks, bk, bn]; bmap: [nkb, nnb] int32;
// out: [M, nnb*bn]; ws: fp32 [splits, M, nnb*bn] when splits > 1 (else
// unused).  dtype: 0 = float32, 1 = bfloat16 (x, pool and out alike).
// variant: 0 = CUDA-core fmaf body, 1 = wgmma body (bfloat16, bk % 16 == 0).
// splits must divide nkb into runs of ceil(nkb / splits) blocks with none
// empty.  Base pointers and the byte strides bk*es, K*es, bn*es must be
// multiples of 16 (TMA).  Returns 0 or a cudaError_t.
extern "C" int dedup_matmul(const void* x, const void* pool, const void* bmap,
                            void* out, void* ws, int64_t M, int64_t nblocks,
                            int64_t nkb, int64_t nnb, int64_t bk, int64_t bn,
                            int64_t dtype, int64_t variant, int64_t splits,
                            void* stream) {
  if (M <= 0 || nnb <= 0) return (int)cudaGetLastError();
  if (nkb <= 0 || splits < 1 || splits > nkb ||
      ((nkb + splits - 1) / splits) * (splits - 1) >= nkb ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int32_t* m = static_cast<const int32_t*>(bmap);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && variant == 0)
    return launch<float, false>(x, pool, m, out, w, M, nblocks, nkb, nnb, bk, bn, splits, s);
  if (dtype == 1 && variant == 0)
    return launch<__nv_bfloat16, false>(x, pool, m, out, w, M, nblocks, nkb, nnb, bk, bn, splits, s);
  if (dtype == 1 && variant == 1 && bk % 16 == 0)
    return launch<__nv_bfloat16, true>(x, pool, m, out, w, M, nblocks, nkb, nnb, bk, bn, splits, s);
  return (int)cudaErrorInvalidValue;
}
