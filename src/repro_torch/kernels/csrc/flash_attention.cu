// Prefill attention, online softmax over key tiles: out = softmax(q k^T) v
// per head, with grouped-query heads (head h reads kv head h / (H / K)),
// causal and sliding-window masks and the tanh logit softcap.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel: grid (B*H, Sq/bq, Skv/bkv) with the key axis sequential and the
// m / l / acc accumulators in VMEM scratch across key steps).
//
// Numerics, as the TPU kernel: q is scaled in fp32 (q * scale), scores, the
// running max m, the running sum l and the accumulator stay in fp32; the
// softcap (softcap * tanh(s / softcap)) is applied before the mask; masked
// scores are the finite -2e38, so a row whose every key is masked ends with
// p = 1 for each key, i.e. the mean of v (no NaN); the result is
// acc / max(l, 1e-30), written in q's dtype.  Keys past Skv in the ragged
// last tile do not exist for the plain version: they get -inf (p = 0), so
// Skv needs no padding.  Rows past Sq are computed and not stored.
//
// What bounds it on the H100: at the slice's prefill shape (q, k, v
// [4, 512, 32, 128] bf16, causal) the work is about 8.6 GFLOP against about
// 67 MB moved, so the card's floor is the bytes, about 20 us; in fp32 on CUDA
// cores (67 TFLOP/s) the same work needs about 130 us, and this kernel runs on
// CUDA cores.
//
// What the design does about it: a simple, right first kernel.  One block of
// 256 threads owns one 64-row q tile of one (batch, head); the TPU's
// sequential key grid axis becomes a loop inside the block.  The scaled q tile
// and each 64-key tile of k and v are staged in shared memory as fp32 (about
// 115 KB at head_dim 128, above the 48 KB default, so the launch opts in to
// more dynamic shared memory).  Thread (ty, tx) owns q rows 4 ty .. 4 ty + 3:
// it computes their scores against keys tx + 16 c, reduces the row max and
// sum with shuffles across the 16 lanes that share the rows, writes p to
// shared memory, and accumulates output columns tx + 16 c in registers, so m,
// l and the accumulator never leave registers.  The block skips key tiles
// that the causal or window mask hides from every row of its q tile (the TPU
// kernel visits and masks them): for a row with at least one visible key this
// is the same math bit for bit, because masked contributions before the first
// visible key are wiped by corr = exp(-2e38 - m) = 0 and those after it add
// exp(-2e38 - m) = 0.  When the call can produce a row with no visible key
// (window > 0 and Sq >= Skv + window), the wrapper passes skip = 0 and every
// tile is visited, so such rows keep the mean of v.  Tensor cores (wgmma),
// TMA and bf16 staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
                       const T* __restrict__ v, T* __restrict__ out,
                       int64_t Sq, int64_t Skv, int64_t H, int64_t K,
                       int64_t hd, int causal, int64_t window, float softcap,
                       float scale, int skip) {
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
    T* ob = out + (b * Sq + qp) * qstride + h * hd;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) from_f32(ob + d, o[r][c] / denom);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t Sq, int64_t Skv, int64_t H, int64_t K, int64_t hd,
           int causal, int64_t window, float softcap, float scale, int skip,
           cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, K, hd,
      causal, window, softcap, scale, skip);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t K,
                int64_t hd, int causal, int64_t window, float softcap,
                float scale, int skip, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
  return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, K, hd, causal, window, softcap, scale, skip, s);
}

}  // namespace

// q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd]; out: [B, Sq, H, hd]; all
// contiguous and of one dtype: 0 = float32, 1 = bfloat16.  H % K == 0,
// 0 < hd <= 256.  window = 0 means global; softcap = 0 means none.
// skip = 1 lets a block skip key tiles its mask hides entirely (exact when
// every row has a visible key).  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t B, int64_t Sq, int64_t Skv,
                               int64_t H, int64_t K, int64_t hd,
                               int64_t causal, int64_t window, float softcap,
                               float scale, int64_t skip, int64_t dtype,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0, sk = skip != 0;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, B, Sq, Skv, H, K, hd, c, window, softcap, scale, sk, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, K, hd, c, window, softcap, scale, sk, s);
  return (int)cudaErrorInvalidValue;
}
