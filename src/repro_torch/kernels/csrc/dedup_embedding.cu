// Row gather from the deduplicated page slab: every column stripe in one launch.
//
// Replaces: src/repro/kernels/dedup_embedding.py::dedup_embedding (the Pallas
// TPU kernel) together with its per-stripe adapter
// src/repro/kernels/ops.py::dedup_embedding_striped, which launched the TPU
// kernel once per column stripe, concatenated the stripes and trimmed the
// ragged last one.
//
// Computes, for every requested row r = ids[t] and output column c < width:
//   j   = c / bw                     (column stripe)
//   src = bmap[(r / bh) * gw + j] * bh + r % bh   (row of the slab viewed [S*l*bh, bw])
//   out[t, c] = pool[src, c % bw]
//
// What bounds it on the H100: latency at the serving shape, bytes beyond it.
// Each output element is one element read and one written, with no
// arithmetic: at 512 rows x 300 fp32 that is 1.2 MB, about 0.37 us at
// 3.35 TB/s, well under one chain of dependent memory loads (ids[t], then the
// row's block ids, then the slab) and the launch.  The sources are scattered
// 256-byte stripe rows, which TMA boxes do not fit, and there is nothing for
// the tensor cores.
//
// What the design does about it: memory-level parallelism.  One warp serves
// one output row, with no block walking rows in sequence (4 warps a block:
// a 512-id batch is 128 blocks, one wave on 132 SMs).  Every lane loads
// ids[t]; lane j < gw loads the row's block id of stripe j, and the lanes
// share them by __shfl_sync, so a row pays its chain of dependent loads once,
// and all rows pay it at the same time.  A lane then issues all of its
// vector loads (up to kRegs, 3 at width 300) into registers before its first
// store.  The unit a lane moves is tracked stripe-major (stripe j, vector k
// within the stripe) and advanced by 32 vectors with a compare, so no unit
// pays a division; the index math is 32-bit when the slab and the output
// hold fewer than 2^31 elements (a 64-bit instance covers larger ones).
// Rows longer than 32 x kRegs vectors, and more than 32 stripes, loop.  Each
// lane moves 16-byte vectors when the stripe width, the output width and
// both base pointers allow it (else 8, 4, 2 or 1 bytes).  Holes (-1 in the
// map) are never touched: the caller refuses a batch whose rows reach one.
// The kernel is a pure copy, so it is bit-exact against the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // output rows a block (one a warp)
constexpr int kRegs = 4;      // vectors a lane loads before it stores
constexpr unsigned kFull = 0xffffffffu;

// pool: [n_blocks * bh, ups] vectors; out: [n_ids, units] vectors.  ups =
// vectors a stripe row; units = vectors an output row.  I is the type of
// the vector offsets (uint32_t or uint64_t).
template <typename V, typename I>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const V* __restrict__ pool, const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ bmap, V* __restrict__ out,
                   int n_ids, int bh, int gw, int ups, int units) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  if (t >= n_ids) return;                          // the whole warp
  const int row = __ldg(ids + t);
  const int rb = row / bh;
  const int off = row - rb * bh;
  const int32_t* brow = bmap + (I)rb * (I)gw;
  V* dst = out + (I)t * (I)units;
  // 32 vectors on is q32 stripes and r32 vectors further
  const int q32 = 32 / ups, r32 = 32 - q32 * ups;
  for (int c0 = 0; c0 < gw; c0 += 32) {            // stripes c0 .. c0 + 31
    const int blk = c0 + lane < gw ? __ldg(brow + c0 + lane) : 0;
    const int u_lo = c0 * ups;
    const int u_hi = units < u_lo + 32 * ups ? units : u_lo + 32 * ups;
    // this lane's vector u = base + lane + 32 i is vector k of stripe c0 + j
    int j = lane / ups;
    int k = lane - j * ups;
    for (int base = u_lo; base < u_hi; base += 32 * kRegs) {   // warp-uniform
      V v[kRegs];
#pragma unroll
      for (int i = 0; i < kRegs; ++i) {
        const int src = __shfl_sync(kFull, blk, j & 31);   // every lane takes part
        if (base + lane + 32 * i < u_hi)
          v[i] = __ldg(pool + ((I)src * (I)bh + (I)off) * (I)ups + (I)k);
        k += r32;
        j += q32;
        if (k >= ups) {
          k -= ups;
          ++j;
        }
      }
#pragma unroll
      for (int i = 0; i < kRegs; ++i) {
        const int u = base + lane + 32 * i;
        if (u < u_hi) dst[u] = v[i];
      }
    }
  }
}

template <typename V>
int launch(const void* pool, const int32_t* ids, const int32_t* bmap, void* out,
           int64_t n_ids, int64_t n_blocks, int64_t bh, int64_t gw,
           int64_t stripe_bytes, int64_t row_bytes, int64_t wide,
           cudaStream_t stream) {
  const int64_t ups = stripe_bytes / (int64_t)sizeof(V);
  const int64_t units = row_bytes / (int64_t)sizeof(V);
  // the 32-bit instance: every vector offset of the slab and the output
  // below 2^31 (the wrapper's element count bounds them)
  if (!wide && (n_blocks * bh * ups >= (1ll << 31) || n_ids * units >= (1ll << 31)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_ids + kWarps - 1) / kWarps);
  const V* p = static_cast<const V*>(pool);
  V* o = static_cast<V*>(out);
  if (wide)
    gather_rows_kernel<V, uint64_t><<<blocks, kWarps * 32, 0, stream>>>(
        p, ids, bmap, o, (int)n_ids, (int)bh, (int)gw, (int)ups, (int)units);
  else
    gather_rows_kernel<V, uint32_t><<<blocks, kWarps * 32, 0, stream>>>(
        p, ids, bmap, o, (int)n_ids, (int)bh, (int)gw, (int)ups, (int)units);
  return (int)cudaGetLastError();
}

bool fits(int64_t v, const void* a, const void* b, int64_t stripe_bytes,
          int64_t row_bytes) {
  return stripe_bytes % v == 0 && row_bytes % v == 0 &&
         reinterpret_cast<uintptr_t>(a) % v == 0 &&
         reinterpret_cast<uintptr_t>(b) % v == 0;
}

}  // namespace

// pool: [n_blocks * bh, bw] elements of elem_bytes each; ids: [n_ids] int32;
// bmap: [gh, gw] int32 (slab block ids); out: [n_ids, width].  index_bits:
// 32 or 64, the width of the kernel's offsets (32 needs the slab and the
// output below 2^31 vectors).  Returns cudaGetLastError() after the launch
// (0 on success) or cudaErrorInvalidValue for arguments it does not take.
extern "C" int dedup_embedding_striped(const void* pool, const void* ids,
                                       const void* bmap, void* out,
                                       int64_t n_ids, int64_t n_blocks,
                                       int64_t bh, int64_t bw, int64_t gw,
                                       int64_t width, int64_t elem_bytes,
                                       int64_t index_bits, void* stream) {
  if (n_ids <= 0 || width <= 0) return (int)cudaGetLastError();
  const int64_t stripe_bytes = bw * elem_bytes;
  const int64_t row_bytes = width * elem_bytes;
  if ((index_bits != 32 && index_bits != 64) || n_ids >= (1ll << 31) ||
      bh <= 0 || bh >= (1ll << 31) || gw <= 0 || gw >= (1ll << 31) ||
      row_bytes >= (1ll << 31) || width > gw * bw)
    return (int)cudaErrorInvalidValue;
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int32_t* m = static_cast<const int32_t*>(bmap);
  const int64_t w = index_bits == 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(16, pool, out, stripe_bytes, row_bytes))
    return launch<uint4>(pool, i, m, out, n_ids, n_blocks, bh, gw, stripe_bytes, row_bytes, w, s);
  if (fits(8, pool, out, stripe_bytes, row_bytes))
    return launch<uint2>(pool, i, m, out, n_ids, n_blocks, bh, gw, stripe_bytes, row_bytes, w, s);
  if (fits(4, pool, out, stripe_bytes, row_bytes))
    return launch<uint32_t>(pool, i, m, out, n_ids, n_blocks, bh, gw, stripe_bytes, row_bytes, w, s);
  if (fits(2, pool, out, stripe_bytes, row_bytes))
    return launch<uint16_t>(pool, i, m, out, n_ids, n_blocks, bh, gw, stripe_bytes, row_bytes, w, s);
  return launch<uint8_t>(pool, i, m, out, n_ids, n_blocks, bh, gw, stripe_bytes, row_bytes, w, s);
}
