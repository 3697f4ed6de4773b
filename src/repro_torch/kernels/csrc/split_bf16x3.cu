// Exact three-way bf16 split of an fp32 tensor, for a bf16 GEMM against a
// bf16 operand.
//
// Replaces no TPU kernel.  The reference multiplies the attention output
// (fp32) by its bf16 projection with jnp.matmul in fp32; on the H100 that
// product is an FFMA GEMM on CUDA cores.  Every fp32 value x is the exact
// sum of three bf16 values x0 + x1 + x2, and a product of two bf16 values
// is exact in fp32, so sum_k x[m,k] w[k,n] is the sum of the exact products
// x0 w, x1 w, x2 w: one bf16 GEMM over the three parts laid along K
// (K tripled) against w stacked three times, summed in fp32 on the tensor
// cores.  This kernel writes the parts in the layout that GEMM reads: y is
// [R, 3C], each row [x2 | x1 | x0], smallest first.  The tensor cores'
// fp32 accumulation cuts what falls below the running sum's last bits (on
// the H100 a GEMM over [x0 | x1 | x2] reads as far from float64 as one
// that drops x2); with the small parts first, the sum is still small while
// they go in, and only the K steps of x0 add at the result's scale.
//
// The split (per value, on its bits): x0 is x with its low 16 bits cut
// (rounded toward zero), r1 = x - x0 is exact in fp32, x1 is r1 cut the same
// way, r2 = r1 - x1 exact, and r2 has at most 8 significant bits, so x2 =
// r2's high half is r2 itself.  Each part keeps x's sign (a zero part takes
// it too, so -0 splits into three -0), and x0 + x1 + x2 == x bit for bit for
// every finite x of magnitude 2^-110 or more and every zero; below that r2
// can need fp32 subnormal bits that a bf16 subnormal lacks.  Cutting instead
// of rounding never overflows: x0 of the largest fp32 is finite.  An inf or a
// NaN goes whole into x0 (a NaN whose payload lay in the cut bits stays a
// NaN) with x1 = x2 = signed zero, so the product propagates it as the fp32
// GEMM does.  The plain version (kernels/ref.py::split_bf16x3) computes the
// same bits.
//
// What bounds it on the H100: bytes.  Each value is 4 bytes read and 6
// written, no arithmetic to speak of: at the deepseek-7b attention output
// [16,384 x 4,096] that is 671 MB, 0.200 ms at 3.35 TB/s.  What the design
// does about it: one pass, 16-byte vectors (a thread takes 8 consecutive
// values and stores 16 bytes to each of the three parts) where the row
// length is a multiple of 8 and the base pointers allow it, else one value
// a thread; a grid-stride loop over flat vector indices, with 32-bit index
// math where the output holds fewer than 2^31 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

template <int V>
struct alignas(V == 1 ? 4 : 16) FVec {
  float v[V];
};

template <int V>
struct alignas(2 * V) HVec {
  uint16_t h[V];
};

__device__ __forceinline__ void split3(float x, uint16_t& h0, uint16_t& h1,
                                       uint16_t& h2) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign = (u >> 16) & 0x8000u;
  if ((u & 0x7f800000u) == 0x7f800000u) {          // inf or NaN
    h0 = (uint16_t)((u >> 16) | ((u & 0xffffu) ? 0x40u : 0u));
    h1 = h2 = (uint16_t)sign;
    return;
  }
  const float r1 = x - __uint_as_float(u & 0xffff0000u);
  const uint32_t v = __float_as_uint(r1);
  const float r2 = r1 - __uint_as_float(v & 0xffff0000u);
  h0 = (uint16_t)(u >> 16);
  h1 = (uint16_t)((v >> 16) | sign);
  h2 = (uint16_t)((__float_as_uint(r2) >> 16) | sign);
}

// x: rows x cols floats, contiguous; units = cols / V vectors a row.
template <int V, typename I>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ x, uint16_t* __restrict__ y, I n,
             I units, I cols) {
  const I stride = (I)gridDim.x * (I)kThreads;
  for (I i = (I)blockIdx.x * (I)kThreads + (I)threadIdx.x; i < n;
       i += stride) {
    const I r = i / units;
    const I c = (i - r * units) * (I)V;
    const FVec<V> in = *reinterpret_cast<const FVec<V>*>(x + r * cols + c);
    HVec<V> p0, p1, p2;
#pragma unroll
    for (int k = 0; k < V; ++k) split3(in.v[k], p0.h[k], p1.h[k], p2.h[k]);
    uint16_t* dst = y + 3 * r * cols + c;
    *reinterpret_cast<HVec<V>*>(dst) = p2;
    *reinterpret_cast<HVec<V>*>(dst + cols) = p1;
    *reinterpret_cast<HVec<V>*>(dst + 2 * cols) = p0;
  }
}

template <int V>
int launch(const float* x, uint16_t* y, int64_t rows, int64_t cols,
           cudaStream_t stream) {
  const int64_t units = cols / V;
  const int64_t n = rows * units;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (3 * rows * cols < (1ll << 31))        // every offset of y in 32 bits
    split_kernel<V, uint32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, (uint32_t)n, (uint32_t)units, (uint32_t)cols);
  else
    split_kernel<V, uint64_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, (uint64_t)n, (uint64_t)units, (uint64_t)cols);
  return (int)cudaGetLastError();
}

// 8 values a thread: the row and both bases allow 16-byte loads and stores
bool fits8(const void* x, const void* y, int64_t cols) {
  return cols % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

}  // namespace

// x: [rows, cols] float32, contiguous; y: [rows, 3 * cols] bfloat16 (as
// uint16 bits), each row [x2 | x1 | x0].  Returns cudaGetLastError() after
// the launch (0 on success) or cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int split_bf16x3(const void* x, void* y, int64_t rows,
                            int64_t cols, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaGetLastError();
  const float* xf = static_cast<const float*>(x);
  uint16_t* yh = static_cast<uint16_t*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits8(x, y, cols)) return launch<8>(xf, yh, rows, cols, s);
  return launch<1>(xf, yh, rows, cols, s);
}
