// K4: the MSM bucket-accumulation scan over the digit-sorted point stream.
//
// Replaces keyless_zk_tpu/ops/pallas_msm.py `window_scan` (`_build_scan`
// pallas_call, body `_scan_kernel_body`); its contract is
// keyless_zk_tpu/ops/msm_sim.py `window_scan`. V lanes each walk L
// consecutive stream entries (slab t of lane l is entry t*V + l of the
// slab-major stream), one mixed add per step, and each lane reports its
// first (head) and last (tail) run. The Pallas kernel has two bodies, with
// and without the P == Q doubling (`assume_distinct`); so does this one
// (`scan_lane`), as two kernels.
//
// The TPU kernel streams every slab's pre-add accumulator to an emit buffer,
// and the orchestrator gathers the interior bucket totals from it. Here a
// run that ends inside the lane and is not the lane's head is an interior
// bucket: its key is its flat bucket id, this lane is the bucket's only
// writer (the bucket lies inside the lane), so the kernel writes the run's
// total straight into that column of the (3R, n_seg) bucket table, an
// in-place update. Ids >= n_seg (the compaction sentinel, the dense tail
// past the last window) are skipped. Nothing else leaves the lane but its
// head and tail.
//
// The TPU kernel carries the accumulator in VMEM scratch across a grid that
// runs in order, one slab per grid step. Hopper blocks run in no order, so
// here the walk over the L slabs is a loop inside each lane's thread and the
// accumulator lives in registers (the G1 mixed add is inlined, ec.cuh). The
// kernel gathers each entry's affine point from the (n+1, 2R) point table
// itself (the JAX orchestrator gathers into a slab-major copy first).
//
// Bound on the H100: integer multiply-adds, the mixed add's 11 Montgomery
// products per entry for G1 (33 Fq products for G2), in carry chains
// (field.cuh). The memory side is 8 bytes of key and payload per entry
// (coalesced: neighbouring lanes are neighbouring threads and addresses),
// the random 128-byte (G1) or 256-byte (G2) row gather, and one bucket
// write per interior bucket. The orchestrator (ops/msm.py) launches one
// wave of lanes for the whole stream. The complete body adds the affine
// doubling (6 Fq products for G1) only in the lanes where P == Q, behind
// madd_complete's branch: on distinct points it costs what the distinct
// body does; where doublings crowd into a few lanes, those lanes set the
// wave's length (PERF.md).

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

// the affine x, y of one table row (2R int32 limbs, 16-byte aligned) in
// 16-byte loads: a random row costs each thread 8 (G1) or 16 (G2) vector
// loads instead of 32 or 64 scalar ones
__device__ __forceinline__ void load_affine(const int4* row, Fp<FqMod>& x, Fp<FqMod>& y) {
  x = load_row<FqMod>(row);
  y = load_row<FqMod>(row + 4);
}

__device__ __forceinline__ void load_affine(const int4* row, Fq2& x, Fq2& y) {
  x = {load_row<FqMod>(row), load_row<FqMod>(row + 4)};
  y = {load_row<FqMod>(row + 8), load_row<FqMod>(row + 12)};
}

// One lane's walk. `Complete` picks the group law: madd_core (no P == Q
// doubling, the body of pallas_msm `_scan_kernel_body(F, assume_distinct=
// True)`) or madd_complete (its `assume_distinct=False` body: a partial sum
// equal to the incoming point takes the affine doubling, behind a branch
// that only the lanes it fires in pay for).
template <class F, bool Complete>
__device__ __forceinline__ void scan_lane(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                                          const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                                          int32_t* __restrict__ tbl, long long n_seg, int32_t* __restrict__ hk,
                                          int32_t* __restrict__ hpt, int32_t* __restrict__ tk,
                                          int32_t* __restrict__ tpt, long long L, long long V, long long l) {
  constexpr int R = Field<F>::rows;
  Jac<F> acc = jac_infinity<F>();
  int cur_key = 0, head_key = -2;
  bool is_head = false;
  store_jac(hpt, V, l, jac_infinity<F>());
  for (long long t = 0; t < L; t++) {
    const long long e = t * V + l;
    const int k = keys[e];
    const int pw = pay[e];
    const long long idx = pw & ((1 << 30) - 1);
    F x2, y2;
    load_affine(reinterpret_cast<const int4*>(table + idx * 2 * R), x2, y2);
    const bool q_inf = tinf[idx] != 0;
    if ((pw >> 30) & 1) y2 = neg(y2);

    const bool same = t > 0 && k == cur_key;
    if (t > 0 && !same) {  // the run of cur_key ends at slab t - 1
      if (is_head) {       // the lane's first run: park it
        head_key = cur_key;
        store_jac(hpt, V, l, acc);
      } else if (cur_key >= 0 && cur_key < n_seg) {  // interior: its bucket's total
        store_jac(tbl, n_seg, cur_key, acc);
      }
    }
    is_head = t == 0 || (is_head && same);
    if (same) {
      if constexpr (Complete)
        acc = madd_complete(acc, x2, y2, q_inf);
      else
        acc = madd_core(acc, x2, y2, q_inf);
    } else {
      acc = {x2, y2, q_inf ? Field<F>::zero() : Field<F>::one()};
    }
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

// the two bodies are two kernels, so that ptxas reports each on its own
template <class F>
__global__ void __launch_bounds__(128)
window_scan_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                   const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                   int32_t* __restrict__ tbl, long long n_seg, int32_t* __restrict__ hk,
                   int32_t* __restrict__ hpt, int32_t* __restrict__ tk, int32_t* __restrict__ tpt, long long L,
                   long long V) {
  long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= V) return;
  scan_lane<F, false>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, l);
}

template <class F>
__global__ void __launch_bounds__(128)
window_scan_complete_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                            const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                            int32_t* __restrict__ tbl, long long n_seg, int32_t* __restrict__ hk,
                            int32_t* __restrict__ hpt, int32_t* __restrict__ tk, int32_t* __restrict__ tpt,
                            long long L, long long V) {
  long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= V) return;
  scan_lane<F, true>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, l);
}

template <class F>
static void launch(const void* keys, const void* pay, const void* table, const void* tinf, void* tbl,
                   long long n_seg, void* hk, void* hpt, void* tk, void* tpt, long long L, long long V,
                   bool complete, cudaStream_t s) {
  const int threads = 128;
  long long blocks = (V + threads - 1) / threads;
  auto kernel = complete ? window_scan_complete_kernel<F> : window_scan_kernel<F>;
  kernel<<<blocks, threads, 0, s>>>((const int32_t*)keys, (const int32_t*)pay, (const int32_t*)table,
                                    (const uint8_t*)tinf, (int32_t*)tbl, n_seg, (int32_t*)hk, (int32_t*)hpt,
                                    (int32_t*)tk, (int32_t*)tpt, L, V);
}

// keys, pay: (L, V) int32 slab-major (pay = table row | negate << 30);
// table: (n+1, 2R) int32 affine x||y limb rows; tinf: (n+1,) uint8.
// tbl: (3R, n_seg) bucket table, updated in place at the interior buckets;
// hk, tk: (V,); hpt, tpt: (3R, V). complete: the body with the P == Q
// doubling (madd_complete) instead of madd_core's.
extern "C" int kzk_window_scan(const void* keys, const void* pay, const void* table, const void* tinf, void* tbl,
                               long long n_seg, void* hk, void* hpt, void* tk, void* tpt, long long L,
                               long long V, int g2, int complete, void* stream) {
  if (L == 0 || V == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    launch<Fq2>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, complete != 0, s);
  else
    launch<Fp<FqMod>>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, complete != 0, s);
  return (int)cudaGetLastError();
}
