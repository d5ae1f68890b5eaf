// K4: the MSM bucket-accumulation scan over the digit-sorted point stream.
//
// Replaces keyless_zk_tpu/ops/pallas_msm.py `window_scan` (`_build_scan`
// pallas_call, body `_scan_kernel_body`); its contract is
// keyless_zk_tpu/ops/msm_sim.py `window_scan`. V lanes each walk L
// consecutive stream entries (slab t of lane l is entry t*V + l of the
// slab-major stream), one mixed add per step, and each lane reports its
// first (head) and last (tail) run. The Pallas kernel has two bodies, with
// and without the P == Q doubling (`assume_distinct`); so does this one, as
// two kernels: `window_scan_kernel` (the distinct body, `scan_lane`) and
// `window_scan_complete_kernel` (the complete body, `scan_ring`).
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
// products per entry for G1 (29 Fq products for G2), in carry chains
// (field.cuh; G2's complete body in 64-bit C). The memory side is 8 bytes
// of key and payload per entry (coalesced: neighbouring lanes are
// neighbouring threads and addresses),
// the random 128-byte (G1) or 256-byte (G2) row gather, and one bucket
// write per interior bucket. The orchestrator (ops/msm.py) launches one
// wave of lanes for the whole stream, so the slowest warps set its time.
//
// The complete body (`scan_law`, redesigned for Hopper; the first one ran
// madd_complete in the distinct body's loop, PERF.md's kernel table):
// - G1 carries its accumulator in homogeneous projective coordinates and
//   adds by ec.cuh `madd_proj`, a complete law with no branch, so a lane
//   where P == Q costs what every other lane costs: in the first body the
//   affine doubling behind madd_complete's branch cost each warp that held
//   such a lane 6 more products, and planted streams crowd those lanes into
//   a few warps, which set the wave's length. A run's total leaves the lane
//   in Jacobian coordinates (the form K5 and K6 read), converted inside the
//   products of the step after the run ends (madd_proj's `fold`).
// - G2 keeps madd_complete and its branch: the projective law over Fq2
//   costs 39 Fq products a step against 29 (its two multiplications by 3b'
//   are full Fq2 products), and ran slower (`g2_proj`). Its Fq product is
//   field.cuh `mul_wide`, by value (`Fq2S` below).
// - Keys and payloads are read two steps ahead and infinity flags one step
//   ahead; the row is read where it is used. A ring that copied each next
//   row into shared memory with cp.async a step ahead ran 2-3x slower on
//   the planted streams (`ring`, PERF.md), so there is none.

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

// One lane's walk of the distinct body: madd_core, no P == Q doubling (the
// body of pallas_msm `_scan_kernel_body(F, assume_distinct=True)`).
template <class F>
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
  scan_lane<F>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, l);
}

// ---- the complete body ---------------------------------------------------------

namespace {

// K4's complete body's G2 coordinates: field.cuh's Fq2 (Karatsuba, 3 Fq
// products; squares 2) on an Fq product in 64-bit C arithmetic (field.cuh
// `mul_wide`) that takes its operands by value, as K3's `k3_mul` does
// (csrc/curve_ops.cu), where `gmul` passes references through the
// local-memory stack
__device__ __noinline__ Fp<FqMod> scan_mul(Fp<FqMod> a, Fp<FqMod> b) { return mul_wide(a, b); }

struct Fq2S {
  Fp<FqMod> c0, c1;
};

__device__ __forceinline__ Fq2S add(const Fq2S& a, const Fq2S& b) {
  return {kzk::add(a.c0, b.c0), kzk::add(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2S sub(const Fq2S& a, const Fq2S& b) {
  return {kzk::sub(a.c0, b.c0), kzk::sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2S neg(const Fq2S& a) { return {kzk::neg(a.c0), kzk::neg(a.c1)}; }
__device__ __forceinline__ bool is_zero(const Fq2S& a) { return kzk::is_zero(a.c0) && kzk::is_zero(a.c1); }
__device__ __forceinline__ Fq2S select(bool c, const Fq2S& a, const Fq2S& b) {
  return {kzk::select(c, a.c0, b.c0), kzk::select(c, a.c1, b.c1)};
}
__device__ __forceinline__ Fq2S gmul(const Fq2S& a, const Fq2S& b) {
  const Fp<FqMod> t0 = scan_mul(a.c0, b.c0);
  const Fp<FqMod> t1 = scan_mul(a.c1, b.c1);
  const Fp<FqMod> t2 = scan_mul(kzk::add(a.c0, a.c1), kzk::add(b.c0, b.c1));
  return {kzk::sub(t0, t1), kzk::sub(kzk::sub(t2, t0), t1)};
}
__device__ __forceinline__ Fq2S gsqr(const Fq2S& a) {
  const Fp<FqMod> re = scan_mul(kzk::add(a.c0, a.c1), kzk::sub(a.c0, a.c1));
  const Fp<FqMod> t = scan_mul(a.c0, a.c1);
  return {re, kzk::add(t, t)};
}

}  // namespace

namespace kzk {
template <>
struct Field<Fq2S> {
  static constexpr int rows = 32;
  __device__ __forceinline__ static Fq2S zero() { return {fp_zero<FqMod>(), fp_zero<FqMod>()}; }
  __device__ __forceinline__ static Fq2S one() { return {fp_one<FqMod>(), fp_zero<FqMod>()}; }
  __device__ __forceinline__ static void store(int32_t* p, long long stride, const Fq2S& a) {
    Field<Fq2>::store(p, stride, Fq2{a.c0, a.c1});
  }
};
}  // namespace kzk

namespace {

// a call, as ec.cuh's G2 group law is (its loop builds in seconds)
__device__ __noinline__ Jac<Fq2S> madd_complete(const Jac<Fq2S>& p, const Fq2S& x2, const Fq2S& y2, bool q_inf) {
  return kzk::madd_complete<Fq2S>(p, x2, y2, q_inf);
}

__device__ __forceinline__ void load_affine(const int4* row, Fq2S& x, Fq2S& y) {
  x = {kzk::load_row<FqMod>(row), kzk::load_row<FqMod>(row + 4)};
  y = {kzk::load_row<FqMod>(row + 8), kzk::load_row<FqMod>(row + 12)};
}

}  // namespace

// The complete body's group laws, as the accumulator a lane carries:
// `start` a run at an affine point, `step` add the next one where the run
// goes on (`same`), `to_jac` give a run's total in Jacobian coordinates.
// A law that `folds` gives, in the lanes where the run ended at the step
// before (`ended`), that total as `done` from inside its step; the others
// leave `done` alone, and the scan writes the total out before the step.
template <class F>
struct JacLaw {  // madd-2007-bl, the affine doubling behind a branch (G2)
  using Acc = Jac<F>;
  static constexpr bool folds = false;
  static __device__ __forceinline__ Acc start(const F& x2, const F& y2, bool q_inf) {
    return {x2, y2, q_inf ? Field<F>::zero() : Field<F>::one()};
  }
  static __device__ __forceinline__ Acc step(const Acc& acc, const F& x2, const F& y2, bool q_inf, bool same,
                                             bool ended, Jac<F>& done) {
    return same ? madd_complete(acc, x2, y2, q_inf) : acc;
  }
  static __device__ __forceinline__ Jac<F> to_jac(const Acc& acc) { return acc; }
};

template <class F>
struct ProjLaw {  // Renes-Costello-Batina Algorithm 8, branch-free (G1)
  using Acc = Proj<F>;
  static constexpr bool folds = true;
  static __device__ __forceinline__ Acc start(const F& x2, const F& y2, bool q_inf) {
    return {q_inf ? Field<F>::zero() : x2, q_inf ? Field<F>::one() : y2,
            q_inf ? Field<F>::zero() : Field<F>::one()};
  }
  // every lane's step is same or ended (t > 0), so the warp takes the 11
  // products whenever one of its lanes goes on, and the lanes that ended
  // convert inside them; a warp in which every run ended converts alone
  static __device__ __forceinline__ Acc step(const Acc& acc, const F& x2, const F& y2, bool q_inf, bool same,
                                             bool ended, Jac<F>& done) {
    if (__any_sync(__activemask(), same)) return madd_proj(acc, x2, y2, q_inf, ended, done);
    if (ended) done = proj_to_jac(acc);
    return acc;
  }
  static __device__ __forceinline__ Jac<F> to_jac(const Acc& acc) { return proj_to_jac(acc); }
};

// the complete body's coordinates and law per group
template <class F>
struct Complete;

template <>
struct Complete<Fp<FqMod>> {
  using Coord = Fp<FqMod>;
  using Law = ProjLaw<Coord>;
};

template <>
struct Complete<Fq2> {
  using Coord = Fq2S;
  using Law = JacLaw<Coord>;
};

constexpr long long kRowMask = (1 << 30) - 1;

// One lane's walk with the law `Law`: `scan_lane`'s contract. Each step's
// key and payload are read two steps ahead and its infinity flag one step
// ahead, so that no step waits on them; its row is read where it is used.
template <class F, class Law>
__device__ __forceinline__ void scan_law(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                                         const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                                         int32_t* __restrict__ tbl, long long n_seg, int32_t* __restrict__ hk,
                                         int32_t* __restrict__ hpt, int32_t* __restrict__ tk,
                                         int32_t* __restrict__ tpt, long long L, long long V, long long l) {
  typename Law::Acc acc = Law::start(Field<F>::zero(), Field<F>::zero(), true);
  int cur_key = 0, head_key = -2;
  bool is_head = false;
  store_jac(hpt, V, l, jac_infinity<F>());
  int k_now = keys[l], pw_now = pay[l];  // entry t; L >= 1
  int k_next = 0, pw_next = 0;           // entry t + 1
  if (L > 1) {
    k_next = keys[V + l];
    pw_next = pay[V + l];
  }
  bool inf_now = tinf[pw_now & kRowMask] != 0, inf_next = false;
  for (long long t = 0; t < L; t++) {
    if (t + 1 < L) inf_next = tinf[pw_next & kRowMask] != 0;
    int k_after = 0, pw_after = 0;
    if (t + 2 < L) {
      k_after = keys[(t + 2) * V + l];
      pw_after = pay[(t + 2) * V + l];
    }
    F x2, y2;
    load_affine(reinterpret_cast<const int4*>(table + (pw_now & kRowMask) * 2 * Field<F>::rows), x2, y2);
    if ((pw_now >> 30) & 1) y2 = neg(y2);

    const bool same = t > 0 && k_now == cur_key;
    const bool ended = t > 0 && !same;  // the run of cur_key ended at slab t - 1
    auto end_run = [&](const Jac<F>& total) {
      if (is_head) {  // the lane's first run: park it
        head_key = cur_key;
        store_jac(hpt, V, l, total);
      } else if (cur_key >= 0 && cur_key < n_seg) {  // interior: its bucket's total
        store_jac(tbl, n_seg, cur_key, total);
      }
    };
    if constexpr (!Law::folds) {
      if (ended) end_run(Law::to_jac(acc));
    }
    Jac<F> done;
    const typename Law::Acc grown = Law::step(acc, x2, y2, inf_now, same, ended, done);
    if constexpr (Law::folds) {
      if (ended) end_run(done);
    }
    is_head = t == 0 || (is_head && same);
    acc = same ? grown : Law::start(x2, y2, inf_now);
    cur_key = k_now;
    k_now = k_next;
    pw_now = pw_next;
    inf_now = inf_next;
    k_next = k_after;
    pw_next = pw_after;
  }
  const Jac<F> last = Law::to_jac(acc);
  if (is_head) {  // one run spans the whole lane: it is the head
    hk[l] = cur_key;
    store_jac(hpt, V, l, last);
    tk[l] = -1;
    store_jac(tpt, V, l, jac_infinity<F>());
  } else {
    hk[l] = head_key;
    tk[l] = cur_key;
    store_jac(tpt, V, l, last);
  }
}

// F: the group's coordinate field (Fp<FqMod> or Fq2)
template <class F>
__global__ void __launch_bounds__(128)
window_scan_complete_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                            const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                            int32_t* __restrict__ tbl, long long n_seg, int32_t* __restrict__ hk,
                            int32_t* __restrict__ hpt, int32_t* __restrict__ tk, int32_t* __restrict__ tpt,
                            long long L, long long V) {
  long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= V) return;
  using C = Complete<F>;
  scan_law<typename C::Coord, typename C::Law>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, l);
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
// hk, tk: (V,); hpt, tpt: (3R, V). complete: the complete body (no
// precondition) instead of the distinct one.
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
