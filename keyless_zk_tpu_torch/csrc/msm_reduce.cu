// K6 and K7: the MSM's weighted bucket reduction and the Horner sum over
// windows.
//
// K6 replaces keyless_zk_tpu/ops/pallas_msm.py `weighted_bucket_total`
// (`_build_accum` + `_build_combine` pallas_calls): per window w,
// sum_b b * B[w, b]. The TPU walks the table in 1024-bucket register tiles
// on a sequential grid, then combines its 1024 lanes with suffix scans and
// ten doublings. Here one block of T threads takes one window (T scales with
// the bucket count, about NB / 32, up to 256 for G1 and 128 for G2, the
// shared-memory tree's room): thread t walks its own
// contiguous bucket range [lo, hi) from the top, keeping the running sum
// Rs and its integral W (W = sum (b - lo) B_b), so the range contributes
// W + lo * Rs; each thread forms that with a short double-and-add, and a
// shared-memory tree sums the threads. ops/cuda_msm.py's plain version
// runs the same schedule (bit-equal results); the contract
// (msm_sim.weighted_bucket_total) sums in another order, so against it the
// results agree as affine points, not as Jacobian coordinates.
//
// K7 replaces `horner_total` (`_build_horner`): sum_w 2^(c*w) * W_w over at
// most a few dozen windows. It is one thread doing c doublings and one add
// per window from the top (the order of msm._horner_windows, so it matches
// msm_sim.horner_total bit for bit).
//
// Bound on the H100: both are latency chains of complete adds. K6 does
// about 2 * NB / T dependent adds per thread with only Wn blocks in flight
// (16 blocks for the dense MSM), so it uses a sliver of the card; K7 is a
// single thread. Splitting each window over several blocks is left for a
// later change.

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

template <class F>
__device__ __forceinline__ Jac<F> scalar_mul_small(const Jac<F>& p, unsigned long long k) {
  Jac<F> acc = jac_infinity<F>();
  if (k == 0) return acc;
  for (int bit = 63 - __clzll(k); bit >= 0; bit--) {
    acc = dbl_core(acc);
    if ((k >> bit) & 1ull) acc = add_core(acc, p);
  }
  return acc;
}

template <class F, int TMAX>
__global__ void __launch_bounds__(TMAX)
bucket_total_kernel(const int32_t* __restrict__ tbl, int32_t* __restrict__ out, long long Wn, long long NB) {
  __shared__ Jac<F> part[TMAX];
  const int T = blockDim.x;  // a power of two <= TMAX, chosen by the wrapper
  const long long w = blockIdx.x;
  const int t = threadIdx.x;
  const long long seg = (NB + T - 1) / T;
  const long long lo = t * seg;
  const long long hi = lo + seg < NB ? lo + seg : NB;
  const long long stride = Wn * NB;
  Jac<F> rs = jac_infinity<F>(), wsum = jac_infinity<F>();
  for (long long b = hi - 1; b >= lo; b--) {
    wsum = add_core(wsum, rs);
    rs = add_core(rs, load_jac<F>(tbl, stride, w * NB + b));
  }
  part[t] = add_core(wsum, scalar_mul_small(rs, (unsigned long long)(lo < NB ? lo : 0)));
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) part[t] = add_core(part[t], part[t + s]);
    __syncthreads();
  }
  if (t == 0) store_jac(out, Wn, w, part[0]);
}

template <class F>
__global__ void horner_kernel(const int32_t* __restrict__ wins, int32_t* __restrict__ out, long long Wn, int c) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  Jac<F> acc = load_jac<F>(wins, Wn, Wn - 1);
  for (long long w = Wn - 2; w >= 0; w--) {
    for (int i = 0; i < c; i++) acc = dbl_core(acc);
    acc = add_core(acc, load_jac<F>(wins, Wn, w));
  }
  store_jac(out, 1, 0, acc);
}

// tbl: (3R, Wn, NB) int32 bucket planes; out: (3R, Wn); T threads per
// window (a power of two, at most 256 for G1 and 128 for G2).
extern "C" int kzk_weighted_bucket_total(const void* tbl, void* out, long long Wn, long long NB, int T, int g2,
                                         void* stream) {
  if (Wn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    bucket_total_kernel<Fq2, 128><<<Wn, T, 0, s>>>((const int32_t*)tbl, (int32_t*)out, Wn, NB);
  else
    bucket_total_kernel<Fp<FqMod>, 256><<<Wn, T, 0, s>>>((const int32_t*)tbl, (int32_t*)out, Wn, NB);
  return (int)cudaGetLastError();
}

// wins: (3R, Wn) int32 window totals; out: (3R,) = sum_w 2^(c*w) W_w.
extern "C" int kzk_horner_total(const void* wins, void* out, long long Wn, int c, int g2, void* stream) {
  if (Wn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    horner_kernel<Fq2><<<1, 32, 0, s>>>((const int32_t*)wins, (int32_t*)out, Wn, c);
  else
    horner_kernel<Fp<FqMod>><<<1, 32, 0, s>>>((const int32_t*)wins, (int32_t*)out, Wn, c);
  return (int)cudaGetLastError();
}
