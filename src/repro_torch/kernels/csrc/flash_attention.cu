// Prefill attention, online softmax over key tiles: out = softmax(q k^T) v
// per head, with grouped-query heads (head h reads kv head h / (H / K)),
// causal and sliding-window masks and the tanh logit softcap.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel: grid (B*H, Sq/bq, Skv/bkv) with the key axis sequential and the
// m / l / acc accumulators in VMEM scratch across key steps).
//
// Numerics, as the TPU kernel: scores, the running max m, the running sum l
// and the accumulator stay in fp32; the softcap (softcap * tanh(s / softcap))
// is applied before the mask; masked scores are the finite -2e38, so a row
// whose every key is masked ends with p = 1 for each key, i.e. the mean of v
// (no NaN); the result is acc / max(l, 1e-30), written in fp32 or bf16 as
// the caller asks (the model's prefill asks fp32: the reference's attend
// returns its fp32 accumulator and feeds it to an fp32 wo product).  Keys
// past Skv in the ragged last tile do not exist for the plain version: they
// get -inf (p = 0), so Skv needs no padding.  Rows past Sq are computed and
// not stored.  A block skips key tiles that the causal or window mask hides
// from every row of its q tile (the TPU kernel visits and masks them): for a
// row with at least one visible key this is the same math bit for bit,
// because masked contributions before the first visible key are wiped by
// corr = exp(-2e38 - m) = 0 and those after it add exp(-2e38 - m) = 0.  When
// the call can produce a row with no visible key (window > 0 and
// Sq >= Skv + window), the wrapper passes skip = 0 and every tile is visited,
// so such rows keep the mean of v.
//
// What bounds it on the H100: at the slice's prefill shape (q, k, v
// [4, 512, 32, 128] bf16, causal) the work is about 8.6 GFLOP against about
// 67 MB moved, so the card's floor is the bytes, about 20 us.  fp32 FMAs on
// CUDA cores (67 TFLOP/s) need about 130 us for the same work, so only the
// bf16 tensor cores get near the bound.
//
// Two bodies, chosen by the wrapper (ops.flash_variant):
//
//  * wgmma (bf16, head_dim a multiple of 16 in [64, 256]).  A CTA owns
//    one 64-row q tile of one (batch, head) per consumer warpgroup (two at
//    head_dim 64, one at 128 and 256) and a producer warp that issues TMA
//    loads: q once, 64-key tiles of k and of v into two 2-stage rings, each
//    stage with a "full" mbarrier that TMA completes and an "empty" one that
//    the consumers release.  A consumer warpgroup runs S = Q K^T with wgmma
//    m64n64k16 (bf16 in, fp32 accumulator; q and k K-major from shared
//    memory), the online softmax in registers on the accumulator's own
//    layout (each thread owns two rows; row max and sum reduce over the 4
//    lanes that share a row; a row's visible keys are one range a tile; the
//    exponentials are ex2 of log2-scaled scores; a warp whose rows see the
//    whole tile skips the mask), and O += P V with P rounded to bf16 in
//    registers as the A operand and the v tile as an MN-major B (transpose
//    bit) of wgmma m64nHDk16.  O is normalised; a bf16 O is staged in the q
//    buffer and written by TMA, an fp32 O (twice the bytes of that buffer)
//    is stored straight from the accumulator registers, each thread two
//    adjacent fp32 of a row at a time (8-byte stores, a quad of threads
//    covering 32 contiguous bytes).  Two CTAs share an SM up to head_dim 128, so one's
//    softmax overlaps the other's products.  Measured slower on the H100
//    and not kept: a software pipeline inside one warpgroup (S_i issued
//    before P_{i-1} V), persistent CTAs that prefetch the next tile's q, a
//    branch around the mask per element.  Launch order: heads in groups
//    whose k and v fit in L2, and in a group the last q tiles (the longest
//    causal rows) first.  q, k and v keep the JAX package's layout: TMA
//    reads them
//    through 4-D maps (head_dim, heads, positions, batch) in boxes of 64
//    head_dim columns by 64 positions with the 128-byte swizzle that the
//    wgmma descriptors name; head_dim 128 and 256 take 2 and 4 boxes a tile,
//    and widths between are padded with zeros by TMA.  GQA is the head
//    coordinate h / (H / K); positions past Sq or Skv arrive as zeros.
//    The scale multiplies the fp32 scores ((q k) scale); the model's
//    prefill passes q already scaled in fp32 and rounded to bf16 with
//    scale = 1, which is the reference's (q scale) k.  P is rounded to bf16
//    before the second product, as the reference's attend does.  A
//    consumer thread needs at most about 200 registers (O is 128 of them at
//    head_dim 256), which a CTA of 160 or 288 threads has without
//    setmaxnreg.
//
//  * fma (fp32, and bf16 at other head dims): one block of 256 threads owns
//    one 64-row q tile of one (batch, head); the TPU's sequential key grid
//    axis becomes a loop inside the block.  The scaled q tile ((q scale) k)
//    and each 64-key tile of k and v are staged in shared memory as fp32
//    (about 115 KB at head_dim 128, opt-in dynamic shared memory).  Thread
//    (ty, tx) owns q rows 4 ty .. 4 ty + 3: it computes their scores against
//    keys tx + 16 c, reduces the row max and sum with shuffles across the 16
//    lanes that share the rows, writes p to shared memory, and accumulates
//    output columns tx + 16 c in registers, so m, l and the accumulator
//    never leave registers.  This body runs the reference's fp32 cases at
//    their 1e-4 tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // q rows a block
constexpr int BKV = 64;         // keys a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int RPT = BQ / 16;    // q rows a thread
constexpr int CPT = BKV / 16;   // score columns a thread
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// reductions over the 16 lanes (tx = 0..15) that hold one row's columns
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HDP>
constexpr size_t smem_bytes() {
  // q and k tiles padded by one column (rows land on different banks)
  return sizeof(float) * ((size_t)BQ * (HDP + 1) + (size_t)BKV * (HDP + 1) +
                          (size_t)BKV * HDP + (size_t)BQ * (BKV + 1));
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, void* __restrict__ out,
                       int out_f32, int64_t Sq, int64_t Skv, int64_t H,
                       int64_t K, int64_t hd, int causal, int64_t window,
                       float softcap, float scale, int skip) {
  constexpr int QK = HDP + 1;
  constexpr int PS = BKV + 1;
  constexpr int OPT = HDP / 16;             // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][QK]  q * scale
  float* Ks = Qs + BQ * QK;                 // [BKV][QK]
  float* Vs = Ks + BKV * QK;                // [BKV][HDP]
  float* Ps = Vs + BKV * HDP;               // [BQ][PS]  probabilities

  const int64_t b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t kh = h / (H / K);
  const int64_t q0 = (int64_t)blockIdx.y * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t qstride = H * hd, kvstride = K * hd;
  const T* qb = q + b * Sq * qstride + h * hd;
  const T* kb = k + b * Skv * kvstride + kh * hd;
  const T* vb = v + b * Skv * kvstride + kh * hd;

  for (int e = tid; e < BQ * HDP; e += kThreads) {
    const int i = e / HDP, d = e % HDP;
    const int64_t qp = q0 + i;
    Qs[i * QK + d] = (qp < Sq && d < hd) ? to_f32(qb[qp * qstride + d]) * scale : 0.f;
  }

  float m[RPT], l[RPT], o[RPT][OPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < OPT; ++c) o[r][c] = 0.f;
  }

  const int64_t q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  const int64_t nkv = (Skv + BKV - 1) / BKV;
  int64_t t_begin = 0, t_end = nkv;
  if (skip) {
    if (causal && q_last / BKV + 1 < t_end) t_end = q_last / BKV + 1;
    if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / BKV;
  }

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t k0 = t * BKV;
    __syncthreads();                        // last tile's Ps / Vs reads done
    for (int e = tid; e < BKV * HDP; e += kThreads) {
      const int j = e / HDP, d = e % HDP;
      const int64_t kp = k0 + j;
      const bool in = kp < Skv && d < hd;
      Ks[j * QK + d] = in ? to_f32(kb[kp * kvstride + d]) : 0.f;
      Vs[j * HDP + d] = in ? to_f32(vb[kp * kvstride + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = Qs[(ty * RPT + r) * QK + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[(tx + 16 * c) * QK + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int64_t qp = q0 + ty * RPT + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int64_t kp = k0 + tx + 16 * c;
        float x = s[r][c];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool visible = true;
        if (causal) visible = visible && qp >= kp;
        if (window > 0) visible = visible && (qp - kp) < window;
        x = visible ? x : kNegInf;
        if (kp >= Skv) x = -INFINITY;       // no such key: p = 0
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty * RPT + r) * PS + tx + 16 * c] = p;
        psum += p;
      }
      l[r] = l[r] * corr + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < OPT; ++c) o[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = Ps[(ty * RPT + r) * PS + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float vv = Vs[j * HDP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RPT; ++r) o[r][c] = fmaf(pv[r], vv, o[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int64_t qp = q0 + ty * RPT + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const int64_t ob = (b * Sq + qp) * qstride + h * hd;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int d = tx + 16 * c;
      if (d >= hd) continue;
      if (out_f32)
        from_f32(static_cast<float*>(out) + ob + d, o[r][c] / denom);
      else
        from_f32(static_cast<__nv_bfloat16*>(out) + ob + d, o[r][c] / denom);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* out,
           int out_f32, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
           int64_t K, int64_t hd, int causal, int64_t window, float softcap,
           float scale, int skip, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  // opt in once per instantiation (not again inside a CUDA graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_attention_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, out_f32, Sq, Skv, H, K, hd, causal,
      window, softcap, scale, skip);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                int out_f32, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                int64_t K, int64_t hd, int causal, int64_t window,
                float softcap, float scale, int skip, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  return launch<T, 256>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
}

// ------------------------------------------------- tensor-core body --
constexpr int kBox = 64 * 128;           // one TMA box: 64 rows of 64 bf16
constexpr int kStagesKV = 2;             // depth of the k ring and of the v ring

// k and v of the heads that run together should stay in L2 (50 MB)
constexpr int64_t kL2Budget = 32ll << 20;

// Consumer warpgroups of 64 q rows each: two share every k / v tile at
// head_dim 64, one at 128 and 256 (measured fastest on the H100: two CTAs
// of one warpgroup share an SM at 128, and two warpgroups would spill the
// 128-register O at 256).
template <int HDP>
struct WgTile {
  static constexpr int NWG = HDP == 64 ? 2 : 1;
  static constexpr int BQC = 64 * NWG;     // q rows a CTA
  static constexpr int NBOX = HDP / 64;
  static constexpr int TB = NBOX * kBox;   // one [64, HDP] bf16 tile
  static constexpr int THREADS = 128 * NWG + 32;   // + one producer warp
  static constexpr int MIN_BLOCKS = HDP <= 128 ? 2 : 1;
  static constexpr size_t smem =
      1024 + (size_t)(NWG + 2 * kStagesKV) * TB + 8 * (1 + 4 * kStagesKV);
};

// O [64, HDP] += P [64, 16] V [16, HDP], by the accumulator's width
__device__ __forceinline__ void pv_step(float (&o)[32], const uint32_t (&a)[4],
                                        uint64_t d) { hopper::wgmma_rs_n64(o, a, d); }
__device__ __forceinline__ void pv_step(float (&o)[64], const uint32_t (&a)[4],
                                        uint64_t d) { hopper::wgmma_rs_n128(o, a, d); }
__device__ __forceinline__ void pv_step(float (&o)[128], const uint32_t (&a)[4],
                                        uint64_t d) { hopper::wgmma_rs_n256(o, a, d); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx: 2 ulp; -inf and -2e38 give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T for one 64-key tile: 16 head_dim columns a step, 32 bytes along
// a swizzled row (committed, not waited for)
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* qt,
                                         const uint8_t* kt) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64<0>(sc, make_desc(qt + off, 16, 1024, kSwizzle128),
                    make_desc(kt + off, 16, 1024, kSwizzle128), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one 64-key tile: 16 keys a step, 16 rows of 128 bytes in
// every box (committed, not waited for)
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N], const uint32_t (&pa)[4][4],
                                         const uint8_t* vt) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    pv_step(o, pa[kk], make_desc(vt + kk * 16 * 128, kBox, 1024, kSwizzle128));
  wgmma_commit();
}

// The online softmax of one tile of scores, on the accumulator's layout:
// thread t holds rows r_lo and r_lo + 8 and 16 keys of each.  Works in
// log2 units (scale2 = scale * log2(e), so p = 2^(s scale2 - m) is one FFMA
// and one ex2), which moves only roundings.  The mask is each row's range
// of visible keys, found once a tile.  Updates the row max m and this
// thread's share of the row sum l, writes p in bf16 pairs (the A fragment
// of P V) and the factor that rescales O.
__device__ __forceinline__ void softmax_tile(
    const float (&sc)[32], float (&m)[2], float (&l)[2], uint32_t (&pa)[4][4],
    float (&corr)[2], int t, int64_t q0, int64_t k0, int64_t Skv, int causal,
    int64_t window, float softcap, float scale2) {
  const float cap2 = softcap * kLog2e, tscale = scale2 / cap2;
  const int r_lo = hopper::acc_row(t, 0);
  const int c0 = 2 * (t & 3);                      // this thread's first column
  int lo[2], hi[2];        // visible keys of each row: lo <= column < hi
  float mx[2] = {-INFINITY, -INFINITY}, xs[32];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t qp = q0 + r_lo + 8 * rr;
    int64_t a = 0, z = BKV;
    if (causal && qp + 1 - k0 < z) z = qp + 1 - k0;
    if (window > 0 && qp - window + 1 - k0 > a) a = qp - window + 1 - k0;
    lo[rr] = (int)(a < BKV ? a : BKV);
    hi[rr] = (int)(z > 0 ? z : 0);
  }
  const int end = (int)(Skv - k0 < BKV ? Skv - k0 : BKV);   // keys that exist
  // a warp whose rows see every key of the tile (no softcap) takes a
  // loop without the mask
  const bool clear = lo[0] == 0 && lo[1] == 0 && hi[0] == BKV &&
                     hi[1] == BKV && end == BKV;
  if (__all_sync(0xffffffffu, clear) && softcap == 0.f) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      xs[e] = sc[e] * scale2;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], xs[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int rr = (e >> 1) & 1;
      const int c = c0 + 8 * (e >> 2) + (e & 1);
      float x = softcap != 0.f ? cap2 * tanhf(sc[e] * tscale) : sc[e] * scale2;
      x = (c >= lo[rr] && c < hi[rr]) ? x : kNegInf;
      x = c < end ? x : -INFINITY;                   // no such key: p = 0
      xs[e] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m[rr], mx[rr]);
    corr[rr] = fast_exp2(m[rr] - m_new);
    m[rr] = m_new;
    l[rr] *= corr[rr];
  }
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int rr = (e >> 1) & 1;
    const float p0 = fast_exp2(xs[e] - m[rr]), p1 = fast_exp2(xs[e + 1] - m[rr]);
    l[rr] += p0 + p1;
    pa[e / 8][(e % 8) / 2] = pack_bf16(p0, p1);
  }
}

template <int HDP>
__global__ void __launch_bounds__(WgTile<HDP>::THREADS, WgTile<HDP>::MIN_BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   float* __restrict__ out32, int64_t Sq, int64_t Skv,
                   int64_t H, int64_t K, int64_t hd, int causal,
                   int64_t window, float softcap, float scale2, int skip,
                   int64_t group) {
  using namespace hopper;
  using TL = WgTile<HDP>;
  constexpr int S = kStagesKV, kWG = TL::NWG, BQC = TL::BQC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;                              // [kWG] swizzled q tiles
  uint8_t* Ks = Qs + kWG * TL::TB;                 // [S] k tiles
  uint8_t* Vs = Ks + S * TL::TB;                   // [S] v tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + S * TL::TB);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + S;
  uint64_t* v_full = k_empty + S;
  uint64_t* v_empty = v_full + S;

  const int tid = threadIdx.x;
  // Launch order: heads in groups of `group` whose k and v fit in L2; in a
  // group, the last q tiles of every head (the longest causal rows) first,
  // so the short ones fill the tail
  const int64_t ntq = (Sq + BQC - 1) / BQC;
  const int64_t BH = (int64_t)gridDim.x / ntq;
  const int64_t gi = blockIdx.x / (group * ntq), within = blockIdx.x % (group * ntq);
  const int64_t gh = BH - gi * group < group ? BH - gi * group : group;
  const int64_t bh = gi * group + within % gh;
  const int64_t b = bh / H, h = bh % H;
  const int64_t kh = h / (H / K);
  const int64_t q0 = (ntq - 1 - within / gh) * BQC;
  const int64_t q_last = (q0 + BQC < Sq ? q0 + BQC : Sq) - 1;
  const int64_t nkv = (Skv + BKV - 1) / BKV;
  int64_t t_begin = 0, t_end = nkv;
  if (skip) {
    if (causal && q_last / BKV + 1 < t_end) t_end = q_last / BKV + 1;
    if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / BKV;
  }
  const int n = (int)(t_end - t_begin);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 128 * kWG);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 128 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * kWG) {                          // producer warp
    if (tid == 128 * kWG) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      mbar_expect_tx(q_full, kWG * TL::TB);
      for (int w = 0; w < kWG; ++w)
        for (int x = 0; x < TL::NBOX; ++x)
          tma_load_4d(Qs + w * TL::TB + x * kBox, &qmap, q_full, x * 64,
                      (int)h, (int)q0 + 64 * w, (int)b);
      // k runs one tile ahead of v: the consumers need k_j with v_{j-1}
      auto load_k = [&](int j) {
        const int s = j % S;
        if (j >= S) mbar_wait(&k_empty[s], (uint32_t)((j / S - 1) & 1));
        mbar_expect_tx(&k_full[s], TL::TB);
        for (int x = 0; x < TL::NBOX; ++x)
          tma_load_4d(Ks + s * TL::TB + x * kBox, &kmap, &k_full[s], x * 64,
                      (int)kh, (int)((t_begin + j) * BKV), (int)b);
      };
      auto load_v = [&](int jv) {
        const int s = jv % S;
        if (jv >= S) mbar_wait(&v_empty[s], (uint32_t)((jv / S - 1) & 1));
        mbar_expect_tx(&v_full[s], TL::TB);
        for (int x = 0; x < TL::NBOX; ++x)
          tma_load_4d(Vs + s * TL::TB + x * kBox, &vmap, &v_full[s], x * 64,
                      (int)kh, (int)((t_begin + jv) * BKV), (int)b);
      };
      // v_{j-1} before k_j: the consumers free a v stage (after P V)
      // before a k stage (after the next Q K^T) in each iteration
      for (int j = 0; j <= n; ++j) {
        if (j >= 1) load_v(j - 1);
        if (j < n) load_k(j);
      }
    }
    return;
  }

  // Consumer warpgroup wg owns q rows wq0 .. wq0 + 63; every warpgroup
  // walks every key tile of the CTA (a tile the mask hides from all of one
  // warpgroup's rows adds exactly 0 to them), so none runs ahead of the
  // rings.  Iteration i adds P_{i-1} V_{i-1} to O, computes S_i = Q K_i and
  // its softmax, and rescales O; the other CTA on the SM (or the other
  // warpgroup) keeps the tensor cores busy meanwhile.
  const int wg = tid / 128, t = tid % 128;
  const int64_t wq0 = q0 + 64 * wg;
  const uint8_t* Qw = Qs + wg * TL::TB;
  float o[HDP / 2], sc[32];
#pragma unroll
  for (int e = 0; e < HDP / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's share
  float corr[2];
  uint32_t pa[BKV / 16][4];
  mbar_wait(q_full, 0);
  if (n > 0) {
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    issue_qk<HDP>(sc, Qw, Ks);
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(&k_empty[0]);
    softmax_tile(sc, m, l, pa, corr, t, wq0, t_begin * BKV, Skv, causal,
                 window, softcap, scale2);
  }
  for (int i = 1; i < n; ++i) {
    const int s = i % S, sp = (i - 1) % S;
    mbar_wait(&v_full[sp], (uint32_t)(((i - 1) / S) & 1));
    wgmma_fence();
    issue_pv(o, pa, Vs + sp * TL::TB);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&v_empty[sp]);
    mbar_wait(&k_full[s], (uint32_t)((i / S) & 1));
    wgmma_fence();
    issue_qk<HDP>(sc, Qw, Ks + s * TL::TB);
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(&k_empty[s]);
    softmax_tile(sc, m, l, pa, corr, t, wq0, (t_begin + i) * BKV, Skv,
                 causal, window, softcap, scale2);
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) o[e] *= corr[(e >> 1) & 1];
  }
  if (n > 0) {                                     // O += P_{n-1} V_{n-1}
    const int sp = (n - 1) % S;
    mbar_wait(&v_full[sp], (uint32_t)(((n - 1) / S) & 1));
    wgmma_fence();
    issue_pv(o, pa, Vs + sp * TL::TB);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&v_empty[sp]);
  }

  // out = O / max(l, 1e-30), one reciprocal a row (a last-bit rounding
  // against a division)
  const int r_lo = acc_row(t, 0);
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float u = l[rr];
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    inv[rr] = 1.f / fmaxf(u, 1e-30f);
  }
  if (out32 != nullptr) {
    // fp32 O: from the registers to device memory, two adjacent columns a
    // store (hd % 16 == 0, so a pair never straddles hd); rows past Sq and
    // columns past hd are not stored
#pragma unroll
    for (int e = 0; e < HDP / 2; e += 2) {
      const int rr = (e >> 1) & 1;
      const int64_t qp = wq0 + r_lo + 8 * rr;
      const int col = acc_col(t, e);
      if (qp < Sq && col < hd)
        *reinterpret_cast<float2*>(out32 + ((b * Sq + qp) * H + h) * hd + col) =
            make_float2(o[e] * inv[rr], o[e + 1] * inv[rr]);
    }
    return;
  }
  // bf16 O: staged in this warpgroup's q buffer (free after its last
  // S = Q K^T) in the layout TMA reads and writes (128-byte swizzle: the
  // 16-byte chunk j of row r sits at chunk j ^ (r % 8)), then written by
  // TMA, which drops the rows past Sq and the columns past hd
  uint8_t* Ow = Qs + wg * TL::TB;
#pragma unroll
  for (int e = 0; e < HDP / 2; e += 2) {
    const int r = r_lo + 8 * ((e >> 1) & 1), col = acc_col(t, e);
    const int c = col % 64;
    const int off = (col / 64) * kBox + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                    (c & 7) * 2;
    *reinterpret_cast<uint32_t*>(Ow + off) =
        pack_bf16(o[e] * inv[(e >> 1) & 1], o[e + 1] * inv[(e >> 1) & 1]);
  }
  fence_proxy_async();                             // visible to TMA
  named_barrier(1 + wg, 128);
  if (t == 0) {
    for (int x = 0; x < TL::NBOX; ++x)
      tma_store_4d(&omap, Ow + x * kBox, x * 64, (int)h, (int)wq0, (int)b);
    tma_store_wait();
  }
}

template <int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int out_f32, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                 int64_t K, int64_t hd, int causal, int64_t window,
                 float softcap, float scale, int skip, cudaStream_t stream) {
  using TL = WgTile<HDP>;
  const cuuint64_t es = 2, D = (cuuint64_t)hd;
  const cuuint64_t qdims[4] = {D, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[3] = {D * es, H * D * es, Sq * H * D * es};
  const cuuint64_t kdims[4] = {D, (cuuint64_t)K, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {D * es, K * D * es, Skv * K * D * es};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  CUtensorMap qmap, kmap, vmap, omap;
  memset(&omap, 0, sizeof(omap));          // unused by an fp32 O
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = hopper::encode_map(&qmap, bf, 4, q, qdims, qstr, box, sw);
  if (!err) err = hopper::encode_map(&kmap, bf, 4, k, kdims, kstr, box, sw);
  if (!err) err = hopper::encode_map(&vmap, bf, 4, v, kdims, kstr, box, sw);
  if (!err && !out_f32)
    err = hopper::encode_map(&omap, bf, 4, out, qdims, qstr, box, sw);
  if (err) return err;
  static bool opted_in = false;
  err = hopper::opt_in_smem(flash_wgmma_kernel<HDP>, TL::smem, &opted_in);
  if (err) return err;
  // heads a launch group: as many q heads as share k and v that fit in
  // kL2Budget (whole GQA groups)
  const int64_t G = H / K, kv_bytes = 2 * Skv * hd * 2;
  int64_t group = (kL2Budget / kv_bytes) * G;
  if (group < G) group = G;
  if (group > B * H) group = B * H;
  const int64_t ntq = (Sq + TL::BQC - 1) / TL::BQC;
  flash_wgmma_kernel<HDP><<<(unsigned)(ntq * B * H), TL::THREADS, TL::smem,
                            stream>>>(
      qmap, kmap, vmap, omap, out_f32 ? static_cast<float*>(out) : nullptr,
      Sq, Skv, H, K, hd, causal, window, softcap, scale * kLog2e, skip,
      group);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   int out_f32, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                   int64_t K, int64_t hd, int causal, int64_t window,
                   float softcap, float scale, int skip, cudaStream_t s) {
  if (hd <= 64)
    return launch_wgmma<64>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  if (hd <= 128)
    return launch_wgmma<128>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  return launch_wgmma<256>(q, k, v, out, out_f32, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
}

}  // namespace

// q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd]; out: [B, Sq, H, hd]; all
// contiguous.  q, k and v share `dtype` and out has `out_dtype`: 0 =
// float32, 1 = bfloat16 (either for either).  H % K == 0,
// 0 < hd <= 256.  window = 0 means global; softcap = 0 means none.
// skip = 1 lets a block skip key tiles its mask hides entirely (exact when
// every row has a visible key).  variant: 0 = the CUDA-core body, 1 = the
// wgmma body (bfloat16, hd % 16 == 0, 64 <= hd <= 256, 16-byte aligned
// bases).  Returns 0 or a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t B, int64_t Sq, int64_t Skv,
                               int64_t H, int64_t K, int64_t hd,
                               int64_t causal, int64_t window, float softcap,
                               float scale, int64_t skip, int64_t dtype,
                               int64_t out_dtype, int64_t variant,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0, sk = skip != 0;
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  const int of32 = out_dtype == 0;
  if (variant == 1) {
    if (dtype != 1 || hd % 16 != 0 || hd < 64 ||
        B * H * ((Sq + 63) / 64) > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    return dispatch_wgmma(q, k, v, out, of32, B, Sq, Skv, H, K, hd, c, window, softcap, scale, sk, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, of32, B, Sq, Skv, H, K, hd, c, window, softcap, scale, sk, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, of32, B, Sq, Skv, H, K, hd, c, window, softcap, scale, sk, s);
  return (int)cudaErrorInvalidValue;
}
