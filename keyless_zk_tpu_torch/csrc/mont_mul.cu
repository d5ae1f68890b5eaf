// K1: batched BN254 Montgomery multiply, out = a * b * 2^-256 mod p.
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
