// K1: batched BN254 Montgomery multiply, out = a * b * 2^-256 mod p; and
// its chain, a batched Montgomery power out = a^e (mont_pow).
//
// Replaces keyless_zk_tpu/ops/pallas_field.py `mont_mul_pallas` (its
// `_build_call` pallas_call and `_make_kernel` body). The TPU kernel
// transposes to limb-major (16, N) tiles so that every VPU op runs on full
// vector registers; on Hopper one thread owns one element, so the
// row-major (N, 16) layout is kept and each thread reads its 64-byte row
// with four 16-byte loads (a warp reads 2 KB contiguous).
//
// Bound on the H100: 192 bytes of HBM traffic per product (two 16-limb
// int32 rows in, one out) against ~300 integer instructions of CIOS, so at
// this width the kernel is near the memory roof rather than the ALU roof.
// What the design does about it: loads and stores are 16-byte vectors, the
// broadcast operand b (row i mod nb) is a small table that stays in L2,
// and nothing else touches memory. Packing the limbs into 8 x 32-bit words
// in the tables themselves would halve the bytes; that is left for later.
//
// mont_pow: the JAX package raises to a power by a `lax.fori_loop` of
// `mont_mul` under `jit` (keyless_zk_tpu/fields/jax_field.py `mont_pow`),
// which on a TPU runs K1's product at every step. Launched once per
// product, the chain of an Fq inversion (p - 2: 254 squarings and 110
// products) was 364 launches of a few elements each, bound by launch
// latency: the proof's decode inverts 4 z's and one Fq2 norm that way. Here
// one thread owns one element for the whole chain: it reads its row once,
// keeps the accumulator in registers through every squaring and product
// (field.cuh's `mul`), and writes once. The exponent is a kernel argument,
// the same for every thread, so every branch on it is uniform across a
// warp. At a few elements the chain's latency bounds it (its dependent
// products); at the setup's 2^21 elements per ladder pass, the products
// (128 bytes per element against ~330 x 264 multiply-adds). By fixed
// 4-bit windows the chain is 11% shorter than bit by bit
// (tools/kernel_variants.py `pow_bits`), and on the H100 it ran 23-26% (n
// = 4) and 9-12% (2^21) faster despite its table in local memory (PERF.md).

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzk;

template <class M>
__global__ void mont_mul_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                                int4* __restrict__ out, long long n, long long nb) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long ib = nb == 1 ? 0 : i % nb;
  store_row(out + 4 * i, mul(load_row<M>(a + 4 * i), load_row<M>(b + 4 * ib)));
}

// The exponent, little-endian 32-bit words, and its bit length
struct Exponent {
  uint32_t w[8];
  int nbits;
};

// window `win` of e, bits 4 win .. 4 win + 3; the word is picked by
// selects, so the argument is read from registers and never indexed
__device__ __forceinline__ uint32_t exp_digit(const uint32_t w[8], int win) {
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) word = (win >> 3) == k ? w[k] : word;
  return (word >> ((win & 7) * 4)) & 15u;
}

// out[i] = a[i]^e, Montgomery form in and out, by fixed 4-bit windows from
// the top: a table of x^0 .. x^15 (14 products), then per window four
// squarings and one product by the window's entry (none for a zero
// window). For p - 2 that is 252 squarings and 14 + 59 products where the
// bit-by-bit square-and-multiply makes 254 and 110. The window is the same
// in every thread, so the table index is uniform across a warp; the
// table, indexed at run time, lives in local memory (L1).
template <class M>
__global__ void mont_pow_kernel(const int4* __restrict__ a, int4* __restrict__ out, long long n, Exponent e) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = e.w[k];
  Fp<M> t[16];
  t[0] = fp_one<M>();
  t[1] = load_row<M>(a + 4 * i);
#pragma unroll 1
  for (int k = 2; k < 16; k++) t[k] = mul(t[k - 1], t[1]);
  int win = (e.nbits - 1) >> 2;
  Fp<M> acc = t[exp_digit(w, win)];
#pragma unroll 1
  for (win--; win >= 0; win--) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) acc = mul(acc, acc);
    const uint32_t d = exp_digit(w, win);
    if (d) acc = mul(acc, t[d]);
  }
  store_row(out + 4 * i, acc);
}

// a: (n, 16) int32 rows; b: (nb, 16) int32 rows, row i of a pairs with row
// i mod nb of b; out: (n, 16). field 0 = Fr, 1 = Fq.
extern "C" int kzk_mont_mul(const void* a, const void* b, void* out, long long n, long long nb,
                            int field, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    mont_mul_kernel<FrMod><<<blocks, threads, 0, s>>>((const int4*)a, (const int4*)b, (int4*)out, n, nb);
  else
    mont_mul_kernel<FqMod><<<blocks, threads, 0, s>>>((const int4*)a, (const int4*)b, (int4*)out, n, nb);
  return (int)cudaGetLastError();
}

// a, out: (n, 16) int32 rows; exp: 8 little-endian words of e (host
// memory), nbits its bit length (at least 1); field 0 = Fr, 1 = Fq.
extern "C" int kzk_mont_pow(const void* a, void* out, long long n, const uint32_t* exp, int nbits, int field,
                            void* stream) {
  if (n == 0) return 0;
  Exponent e;
  for (int k = 0; k < 8; k++) e.w[k] = exp[k];
  e.nbits = nbits;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    mont_pow_kernel<FrMod><<<blocks, threads, 0, s>>>((const int4*)a, (int4*)out, n, e);
  else
    mont_pow_kernel<FqMod><<<blocks, threads, 0, s>>>((const int4*)a, (int4*)out, n, e);
  return (int)cudaGetLastError();
}
