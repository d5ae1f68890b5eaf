// K4: the MSM bucket-accumulation scan over one chunk of the digit-sorted
// point stream.
//
// Replaces keyless_zk_tpu/ops/pallas_msm.py `window_scan` (`_build_scan`
// pallas_call, body `_scan_kernel_body`); its contract is
// keyless_zk_tpu/ops/msm_sim.py `window_scan`. V lanes each walk L
// consecutive stream entries (slab t of lane l is entry t*V + l of the
// slab-major stream). Each step is one complete mixed add; each slab emits
// the lane's pre-add accumulator; each lane reports its first (head) and
// last (tail) run.
//
// The TPU kernel carries the accumulator in VMEM scratch across a grid that
// runs in order, one slab per grid step. Hopper blocks run in no order, so
// here the walk over the L slabs is a loop inside each lane's thread and the
// accumulator lives in registers. The kernel also gathers each entry's
// affine point from the (n+1, 2R) point table itself (the JAX orchestrator
// gathers into a slab-major copy first), and writes the head point to
// memory when the head run ends instead of carrying it in registers.
//
// Bound on the H100: the mixed add (11 Montgomery products for G1, 33 Fq
// products for G2) is integer-multiply bound; the emit stream (3R int32 per
// entry) and the random row gather are the memory side. Neighbouring lanes
// are neighbouring threads and neighbouring addresses in every key, payload
// and emit access, so those are coalesced; the row gather is not.

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

template <class F>
__global__ void __launch_bounds__(128)
window_scan_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                   const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                   int32_t* __restrict__ emit, int32_t* __restrict__ hk, int32_t* __restrict__ hpt,
                   int32_t* __restrict__ tk, int32_t* __restrict__ tpt, long long L, long long V) {
  long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= V) return;
  constexpr int R = Field<F>::rows;
  const long long es = L * V;
  Jac<F> acc = jac_infinity<F>();
  int cur_key = 0, head_key = -2;
  bool is_head = false;
  store_jac(hpt, V, l, jac_infinity<F>());
  for (long long t = 0; t < L; t++) {
    const long long e = t * V + l;
    const int k = keys[e];
    const int pw = pay[e];
    const long long idx = pw & ((1 << 30) - 1);
    const int32_t* row = table + idx * 2 * R;
    F x2 = Field<F>::load(row, 1);
    F y2 = Field<F>::load(row + R, 1);
    const bool q_inf = tinf[idx] != 0;
    if ((pw >> 30) & 1) y2 = neg(y2);

    store_jac(emit, es, e, acc);  // pre-add state; infinity at t == 0
    const bool same = t > 0 && k == cur_key;
    if (t > 0 && !same && is_head) {  // the lane's first run ends: park it
      head_key = cur_key;
      store_jac(hpt, V, l, acc);
    }
    is_head = t == 0 || (is_head && same);
    if (same)
      acc = madd_core(acc, x2, y2, q_inf);
    else
      acc = {x2, y2, q_inf ? Field<F>::zero() : Field<F>::one()};
    cur_key = k;
  }
  if (is_head) {  // one run spans the whole lane: it is the head
    hk[l] = cur_key;
    store_jac(hpt, V, l, acc);
    tk[l] = -1;
    store_jac(tpt, V, l, jac_infinity<F>());
  } else {
    hk[l] = head_key;
    tk[l] = cur_key;
    store_jac(tpt, V, l, acc);
  }
}

template <class F>
static void launch(const void* keys, const void* pay, const void* table, const void* tinf,
                   void* emit, void* hk, void* hpt, void* tk, void* tpt, long long L, long long V,
                   cudaStream_t s) {
  const int threads = 128;
  long long blocks = (V + threads - 1) / threads;
  window_scan_kernel<F><<<blocks, threads, 0, s>>>(
      (const int32_t*)keys, (const int32_t*)pay, (const int32_t*)table, (const uint8_t*)tinf, (int32_t*)emit,
      (int32_t*)hk, (int32_t*)hpt, (int32_t*)tk, (int32_t*)tpt, L, V);
}

// keys, pay: (L, V) int32 slab-major (pay = table row | negate << 30);
// table: (n+1, 2R) int32 affine x||y limb rows; tinf: (n+1,) uint8.
// emit: (3R, L, V); hk, tk: (V,); hpt, tpt: (3R, V).
extern "C" int kzk_window_scan(const void* keys, const void* pay, const void* table, const void* tinf,
                               void* emit, void* hk, void* hpt, void* tk, void* tpt, long long L,
                               long long V, int g2, void* stream) {
  if (L == 0 || V == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    launch<Fq2>(keys, pay, table, tinf, emit, hk, hpt, tk, tpt, L, V, s);
  else
    launch<Fp<FqMod>>(keys, pay, table, tinf, emit, hk, hpt, tk, tpt, L, V, s);
  return (int)cudaGetLastError();
}
