// K8: the matmul NTT's lazy Montgomery reduction, T * 2^-320 mod r, plain
// or followed by a Montgomery product with a twiddle.
//
// Replaces keyless_zk_tpu/ops/pallas_redc.py `redc_pallas` (bodies
// `_redc_kernel` and `_redc_tw_kernel`). The int8 product of a DFT pass
// leaves each output element as 63 byte-weighted int32 columns,
// T = sum_k col_k * 2^(8k), col_k < 2^28. The TPU kernel resolves T into
// bytes and runs a byte-wise REDC on (64, 2048) VMEM tiles, because its
// vector unit has no wide multiply. Here one thread owns one element: it
// reads its 63 columns straight from the product's output (column k of
// element e at wide[k * n + e], so a warp reads 128 contiguous bytes per
// column), resolves T into 32-bit words, and runs a word-wise Montgomery
// reduction by 2^320 (ten rounds of m = w_i * -r^-1 mod 2^32, w += m * r
// << 32i) and one conditional subtract. The m with T + m*r == 0 mod 2^320
// and m < 2^320 is unique, so the result equals the byte-wise one bit for
// bit. The fused body then multiplies by the element's twiddle (CIOS,
// field.cuh), which saves the separate pass the JAX package makes.
//
// Bound on the H100: 252 bytes of columns in and 64 bytes out per element
// (+64 bytes of twiddle for the fused body) against ~200 (plain) or ~330
// (fused) 32-bit multiply-adds: memory-bound, as the TPU kernel was. The
// design reads every column once, coalesced, and keeps T in registers.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzk;

namespace {

constexpr int WIDE_COLS = 63;  // byte columns of T
constexpr int RED_WORDS = 10;  // 2^320 = 2^(32 * 10)
constexpr int T_WORDS = 18;    // T + m*r < 2^575

__device__ __forceinline__ Fp<FrMod> redc320(const int32_t* __restrict__ wide, long long n, long long e) {
  // 1. T as 32-bit words: column k lands at bit 8k, i.e. word k / 4 with an
  // offset of 8 * (k % 4); each shifted column is < 2^52 and a word gathers
  // four, so the 64-bit sums cannot overflow before the carry pass.
  uint64_t acc[T_WORDS];
#pragma unroll
  for (int i = 0; i < T_WORDS; i++) acc[i] = 0;
#pragma unroll
  for (int k = 0; k < WIDE_COLS; k++) {
    uint32_t col = (uint32_t)__ldg(wide + k * n + e);
    acc[k >> 2] += (uint64_t)col << (8 * (k & 3));
  }
  uint32_t w[T_WORDS];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < T_WORDS; i++) {
    c += acc[i];
    w[i] = (uint32_t)c;
    c >>= 32;
  }
  // 2. word-wise REDC by 2^320: after round i the low i + 1 words are zero
#pragma unroll
  for (int i = 0; i < RED_WORDS; i++) {
    uint32_t m = w[i] * FrMod::n0;
    c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)m * FrMod::p(j) + w[i + j];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
#pragma unroll
    for (int j = i + 8; j < T_WORDS; j++) {
      c += w[j];
      w[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  // 3. (T + m*r) / 2^320 < 2^204 + r < 2r: one conditional subtract
  return fp_csub<FrMod>(w + RED_WORDS, 0);
}

template <bool TWIDDLE>
__global__ void redc_kernel(const int32_t* __restrict__ wide, const int4* __restrict__ tw,
                            int4* __restrict__ out, long long n) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fp<FrMod> r = redc320(wide, n, e);
  if (TWIDDLE) r = mul(r, load_row<FrMod>(tw + 4 * e));
  store_row(out + 4 * e, r);
}

}  // namespace

// wide: (63, n) int32, row k = byte column k of each element's T; tw: null
// or (n, 16) int32 Montgomery twiddle rows; out: (n, 16) int32.
extern "C" int kzk_redc(const void* wide, const void* tw, void* out, long long n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (tw == nullptr)
    redc_kernel<false><<<blocks, threads, 0, s>>>((const int32_t*)wide, nullptr, (int4*)out, n);
  else
    redc_kernel<true><<<blocks, threads, 0, s>>>((const int32_t*)wide, (const int4*)tw, (int4*)out, n);
  return (int)cudaGetLastError();
}
