// K10: the number-theoretic transform over BN254 Fr as shared-memory
// butterfly passes, and the h scalars' iNTT -> coset shift -> NTT chain
// fused around them.
//
// Replaces, on the prover's path, the matmul NTT of
// keyless_zk_tpu/ops/mxu_ntt.py (ported as ops/mxu_ntt.py: per radix-128
// pass a byte-plane split, an int8 product into a 1.6 GB int32
// accumulator, two offset adds, a twiddle gather and K8's
// `_redc_tw_kernel` / `_redc_kernel` of keyless_zk_tpu/ops/pallas_redc.py,
// then a digit-reverse gather). That design answers a TPU, whose matrix
// unit is its only fast multiplier; a CUDA core multiplies 32 x 32 -> 64
// bits, so here a butterfly is one Montgomery product in registers
// (field.cuh `mul`).
//
// Split (ops/cuda_ntt.py `split`): n = N_0 * ... * N_(P-1), each N_p =
// 2^L_p at most 2^11 (P = 2 at the keyless 2^21 = 2^11 * 2^10). With
// S_p = N_(p+1) * ... * N_(P-1), pass p runs an N_p-point DFT over every
// line of points S_p apart, then (all but the last pass) multiplies output
// k of the line whose offset is `suf` by w_M^(suf * k), M = N_p * S_p (the
// four-step twiddle), and writes it where it read (k in place of the input
// digit). The last pass (S = 1: contiguous lines) writes output k of the
// line whose digit-reversed prefix is t to t + (n / N) * k, so the result
// is in natural order with no gather. Within a pass a block holds `cols`
// adjacent lines of `vecs` vectors in shared memory, word w of each element
// in a plane of its own (so a warp's accesses hit 32 banks), runs the
// L_p radix-2 decimation-in-frequency stages there (twiddle w_N^(j << s) of
// one table per pass), and reads the outputs in bit-reversed positions on
// the way out. Each pass reads and writes each element once.
//
// On the way in and out a pass may also: take the batch (a, b, a * b) from
// the a|b vectors (the h chain's first pass); multiply by n^-1 (the
// public iNTT) or by a table indexed by the natural output index (the
// coset powers times n^-1: the h chain's iNTT); write h = A * B - C out of
// Montgomery form from three vectors held in one block (the h chain's last
// pass). Elements are 8 little-endian 32-bit words between passes and 16
// 16-bit limbs in int32 at the public boundary. Every output is canonical,
// and the NTT is linear mod r, so every result equals the JAX package's
// bit for bit.
//
// Bound on the H100: the h chain's six 2^21-point transforms make
// ~6 * 2^21 * 11.5 Montgomery products (the butterflies, the four-step
// twiddle as a product of two table entries), ~157 M with the fusions',
// 264 32-bit multiply-adds each: ~2.5 ms at 16.7 T multiply-adds/s,
// against ~0.4 GB of device memory a pass (~0.5 ms in all). So the
// products bound it. What the
// design does about it: no byte planes, no accumulator and no reduction
// pass; the stages' data stays in shared memory; the twiddle tables are a
// few KB (L1/L2-resident); the last stage of each pass (twiddle 1)
// multiplies nothing.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzk;

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kMaxSmem = 227 * 1024;       // shared memory a block may take on the H100
constexpr int kMaxDevices = 64;

using Fr = Fp<FrMod>;

enum InFormat { kInWords = 0, kInLimbs = 1, kInAb = 2 };
enum OutFormat { kOutWords = 0, kOutLimbs = 1, kOutH = 2 };
enum ScaleMode { kScaleNone = 0, kScaleConst = 1, kScaleTable = 2 };

struct PassArgs {
  const void* src;
  void* dst;
  long long n;            // points per vector
  int batch;              // vectors
  int vecs;               // vectors a block holds (3 with kOutH, else 1)
  int log_line;           // L: N = 2^L points per line
  int log_stride;         // log2 S (0 in the last pass)
  int final_pass;
  int la, lb;             // the last pass's prefix digits: line = ((t mod 2^la) << lb) | (t >> la)
  int log_cols;           // lines of a vector a block holds
  const uint4* tw_line;   // N / 2 entries: w_N^i
  const uint4* tw_lo;     // 2^lo_bits entries: w_M^i
  const uint4* tw_hi;     // M / 2^lo_bits entries: w_M^(i << lo_bits)
  int lo_bits;
  const uint4* scale;     // 1 entry (kScaleConst) or n entries (kScaleTable)
  int scale_mode;
  int in_format, out_format;
};

__device__ __forceinline__ Fr ld_words(const uint4* p) {
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void st_words(uint4* p, const Fr& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ Fr sm_get(const uint32_t* sm, int tile, int i) {
  Fr x;
#pragma unroll
  for (int w = 0; w < 8; w++) x.v[w] = sm[w * tile + i];
  return x;
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int tile, int i, const Fr& x) {
#pragma unroll
  for (int w = 0; w < 8; w++) sm[w * tile + i] = x.v[w];
}

__device__ __forceinline__ int bitrev(int k, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)k) >> (32 - bits));
}

// element `pos` of vector `vec` of the pass's input
__device__ __forceinline__ Fr load_in(const PassArgs& a, int vec, long long pos) {
  if (a.in_format == kInWords) return ld_words((const uint4*)a.src + 2 * (vec * a.n + pos));
  if (a.in_format == kInLimbs) return load_row<FrMod>((const int4*)a.src + 4 * (vec * a.n + pos));
  // kInAb: vectors a, b (the two halves of the a|b vectors) and a * b
  const int4* ab = (const int4*)a.src;
  if (vec < 2) return load_row<FrMod>(ab + 4 * (vec * a.n + pos));
  return mul(load_row<FrMod>(ab + 4 * pos), load_row<FrMod>(ab + 4 * (a.n + pos)));
}

__device__ __forceinline__ void store_out(const PassArgs& a, int vec, long long pos, const Fr& x) {
  if (a.out_format == kOutWords)
    st_words((uint4*)a.dst + 2 * (vec * a.n + pos), x);
  else
    store_row<FrMod>((int4*)a.dst + 4 * (vec * a.n + pos), x);
}

__device__ __forceinline__ Fr scaled(const PassArgs& a, long long idx, const Fr& x) {
  if (a.scale_mode == kScaleConst) return mul(x, ld_words(a.scale));
  if (a.scale_mode == kScaleTable) return mul(x, ld_words(a.scale + 2 * idx));
  return x;
}

__global__ void __launch_bounds__(kThreads) ntt_pass_kernel(const PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int L = a.log_line, N = 1 << L;
  const int cols = 1 << a.log_cols;
  const int tile = a.vecs * cols * N;  // elements held
  const int groups = a.batch / a.vecs;  // vector groups; a block's group varies fastest
  const int vg = (int)(blockIdx.x % groups);
  const long long q = blockIdx.x / groups;  // the block's line group within its vectors
  const long long S = 1LL << a.log_stride;
  // a middle pass: lines pre * N * S + suf0 + c (c < cols), points S apart;
  // the last pass: the lines whose digit-reversed prefix is t0 + c
  long long pre = 0, suf0 = 0, t0 = 0;
  if (a.final_pass) {
    t0 = q << a.log_cols;
  } else {
    const long long per_pre = S >> a.log_cols;
    pre = q / per_pre;
    suf0 = (q % per_pre) << a.log_cols;
  }
  const long long lines = a.n >> L;  // lines per vector
  const long long la_mask = (1LL << a.la) - 1;

  // 1. load: in a middle pass adjacent threads take adjacent lines (their
  // points are adjacent in memory), in the last pass adjacent points
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    int g, c, k;
    long long pos;
    if (a.final_pass) {
      k = e & (N - 1);
      c = (e >> L) & (cols - 1);
      g = e >> (L + a.log_cols);
      const long long t = t0 + c;
      pos = (((t & la_mask) << a.lb) | (t >> a.la)) * N + k;
    } else {
      c = e & (cols - 1);
      k = (e >> a.log_cols) & (N - 1);
      g = e >> (L + a.log_cols);
      pos = pre * N * S + k * S + suf0 + c;
    }
    sm_put(sm, tile, (g * cols + c) * N + k, load_in(a, vg * a.vecs + g, pos));
  }
  __syncthreads();

  // 2. the DIF stages: stage s pairs points half = N >> (s + 1) apart, the
  // difference times w_N^(j << s) (j the pair's offset in its group), but
  // in the last stage, whose twiddle is 1
  const int half_tile = tile >> 1;
  for (int s = 0; s < L; s++) {
    const int lh = L - 1 - s;
    const int half = 1 << lh;
    for (int b = threadIdx.x; b < half_tile; b += kThreads) {
      const int line = b >> (L - 1);
      const int u = b & ((N >> 1) - 1);
      const int j = u & (half - 1);
      const int i0 = line * N + ((u >> lh) << (lh + 1)) + j;
      const int i1 = i0 + half;
      const Fr x0 = sm_get(sm, tile, i0), x1 = sm_get(sm, tile, i1);
      Fr y1 = sub(x0, x1);
      if (lh > 0) y1 = mul(y1, ld_words(a.tw_line + 2 * (j << s)));
      sm_put(sm, tile, i0, add(x0, x1));
      sm_put(sm, tile, i1, y1);
    }
    __syncthreads();
  }

  // 3. store: output k of a line sits at position bitrev(k); adjacent
  // threads take adjacent lines (adjacent addresses in both kinds of pass)
  const int out_tile = a.out_format == kOutH ? cols * N : tile;
  for (int e = threadIdx.x; e < out_tile; e += kThreads) {
    const int c = e & (cols - 1);
    const int k = (e >> a.log_cols) & (N - 1);
    const int g = e >> (L + a.log_cols);
    const int i = (g * cols + c) * N + bitrev(k, L);
    if (a.final_pass) {
      const long long idx = t0 + c + lines * k;
      if (a.out_format == kOutH) {  // h = A * B - C, out of Montgomery form
        const int line_elems = cols * N;
        const Fr x0 = scaled(a, idx, sm_get(sm, tile, i));
        const Fr x1 = scaled(a, idx, sm_get(sm, tile, i + line_elems));
        const Fr x2 = scaled(a, idx, sm_get(sm, tile, i + 2 * line_elems));
        Fr one = fp_zero<FrMod>();
        one.v[0] = 1;
        store_row<FrMod>((int4*)a.dst + 4 * (vg * a.n + idx), mul(sub(mul(x0, x1), x2), one));
      } else {
        store_out(a, vg * a.vecs + g, idx, scaled(a, idx, sm_get(sm, tile, i)));
      }
    } else {
      const long long col = suf0 + c;
      const unsigned ex = (unsigned)(col * k);  // < M <= 2^28
      const Fr tw =
          mul(ld_words(a.tw_lo + 2 * (ex & ((1u << a.lo_bits) - 1))), ld_words(a.tw_hi + 2 * (ex >> a.lo_bits)));
      store_out(a, vg * a.vecs + g, pre * N * S + k * S + col, mul(sm_get(sm, tile, i), tw));
    }
  }
}

}  // namespace

// One pass of K10 (see the note at the top). src / dst by format: words
// (batch, n, 8) int32; limbs (batch, n, 16) int32; the a|b input (2n, 16)
// int32 with batch 3; the h output (n, 16) int32 with batch 3 and vecs 3.
// Tables are (m, 8) int32 words; tw_lo / tw_hi in all but the last pass;
// scale null, one entry or n entries. Returns a CUDA error code.
extern "C" int kzk_ntt_pass(const void* src, void* dst, long long n, int batch, int vecs, int log_line,
                            int log_stride, int final_pass, int la, int lb, int log_cols, const void* tw_line,
                            const void* tw_lo, const void* tw_hi, int lo_bits, const void* scale, int scale_mode,
                            int in_format, int out_format, void* stream) {
  if (n <= 0 || batch <= 0 || vecs <= 0 || batch % vecs || log_line < 0 || log_cols < 0 ||
      (n >> log_line) << log_line != n || (out_format == kOutH && (vecs != 3 || !final_pass)) ||
      (in_format == kInAb && batch != 3))
    return (int)cudaErrorInvalidValue;
  const long long lines = n >> log_line;
  const long long per_block = final_pass ? lines : (1LL << log_stride);
  if ((1LL << log_cols) > per_block) return (int)cudaErrorInvalidValue;
  const long long tile = (long long)vecs << (log_cols + log_line);
  const size_t smem = (size_t)tile * 8 * sizeof(uint32_t);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  PassArgs a{src, dst, n, batch, vecs, log_line, log_stride, final_pass, la, lb, log_cols,
             (const uint4*)tw_line, (const uint4*)tw_lo, (const uint4*)tw_hi, lo_bits, (const uint4*)scale,
             scale_mode, in_format, out_format};
  // the kernel may take up to kMaxSmem of dynamic shared memory: set once per
  // device, not at every launch
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const long long blocks = (batch / vecs) * (lines >> log_cols);
  ntt_pass_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
