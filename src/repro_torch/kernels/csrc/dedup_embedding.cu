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
// What bounds it on the H100: bytes.  Each output element is one element read
// and one written, with no arithmetic: at 512 rows x 300 fp32 that is 1.2 MB,
// about 0.4 us at 3.35 TB/s, far below the launch cost, so in serving it is
// launch-bound.
//
// What the design does about it: one launch covers every stripe (no per-stripe
// launches, no concatenation pass, no trim copy); each thread moves 16-byte
// vectors when the stripe width, the output width and both base pointers allow
// it, so a warp reads whole 128-byte lines of a slab row; offsets are 64-bit
// because the slab can hold more than 2^31 elements.  Holes (-1 in the map) are
// never touched: the caller refuses a batch whose rows reach one.  The kernel
// is a pure copy, so it is bit-exact against the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;

template <typename V>
__global__ void gather_rows_kernel(const char* __restrict__ pool,
                                   const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ bmap,
                                   char* __restrict__ out,
                                   int64_t n_ids, int64_t bh, int64_t gw,
                                   int64_t stripe_bytes, int64_t row_bytes) {
  // row_bytes = width * elem_bytes (one output row); stripe_bytes = bw * elem_bytes
  const int64_t units = row_bytes / (int64_t)sizeof(V);
  const int64_t first = (int64_t)blockIdx.x * kRowsPerBlock;
  for (int rr = 0; rr < kRowsPerBlock; ++rr) {
    const int64_t t = first + rr;
    if (t >= n_ids) return;
    const int64_t r = ids[t];
    const int64_t rb = r / bh;
    const int64_t off = r - rb * bh;
    const int32_t* brow = bmap + rb * gw;
    V* dst = reinterpret_cast<V*>(out + t * row_bytes);
    for (int64_t u = threadIdx.x; u < units; u += kThreads) {
      const int64_t b = u * (int64_t)sizeof(V);   // byte offset in the output row
      const int64_t j = b / stripe_bytes;          // a vector never spans two stripes
      const int64_t in_stripe = b - j * stripe_bytes;
      const int64_t src_row = (int64_t)brow[j] * bh + off;
      dst[u] = *reinterpret_cast<const V*>(pool + src_row * stripe_bytes + in_stripe);
    }
  }
}

template <typename V>
void launch(const void* pool, const int32_t* ids, const int32_t* bmap, void* out,
            int64_t n_ids, int64_t bh, int64_t gw, int64_t stripe_bytes,
            int64_t row_bytes, cudaStream_t stream) {
  const int64_t blocks = (n_ids + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const char*>(pool), ids, bmap, static_cast<char*>(out),
      n_ids, bh, gw, stripe_bytes, row_bytes);
}

bool fits(int64_t v, const void* a, const void* b, int64_t stripe_bytes,
          int64_t row_bytes) {
  return stripe_bytes % v == 0 && row_bytes % v == 0 &&
         reinterpret_cast<uintptr_t>(a) % v == 0 &&
         reinterpret_cast<uintptr_t>(b) % v == 0;
}

}  // namespace

// pool: [n_blocks * bh, bw] elements of elem_bytes each; ids: [n_ids] int32;
// bmap: [gh, gw] int32 (slab block ids); out: [n_ids, width].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dedup_embedding_striped(const void* pool, const void* ids,
                                       const void* bmap, void* out,
                                       int64_t n_ids, int64_t bh, int64_t bw,
                                       int64_t gw, int64_t width,
                                       int64_t elem_bytes, void* stream) {
  if (n_ids <= 0 || width <= 0) return (int)cudaGetLastError();
  const int64_t stripe_bytes = bw * elem_bytes;
  const int64_t row_bytes = width * elem_bytes;
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int32_t* m = static_cast<const int32_t*>(bmap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(16, pool, out, stripe_bytes, row_bytes))
    launch<uint4>(pool, i, m, out, n_ids, bh, gw, stripe_bytes, row_bytes, s);
  else if (fits(8, pool, out, stripe_bytes, row_bytes))
    launch<uint2>(pool, i, m, out, n_ids, bh, gw, stripe_bytes, row_bytes, s);
  else if (fits(4, pool, out, stripe_bytes, row_bytes))
    launch<uint32_t>(pool, i, m, out, n_ids, bh, gw, stripe_bytes, row_bytes, s);
  else if (fits(2, pool, out, stripe_bytes, row_bytes))
    launch<uint16_t>(pool, i, m, out, n_ids, bh, gw, stripe_bytes, row_bytes, s);
  else
    launch<uint8_t>(pool, i, m, out, n_ids, bh, gw, stripe_bytes, row_bytes, s);
  return (int)cudaGetLastError();
}
