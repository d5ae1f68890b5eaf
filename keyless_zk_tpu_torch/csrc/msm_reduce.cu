// K6 and K7: the MSM's weighted bucket reduction and the Horner sum over
// windows.
//
// K6 replaces keyless_zk_tpu/ops/pallas_msm.py `weighted_bucket_total`
// (`_build_accum` + `_build_combine` pallas_calls): per window w,
// sum_b b * B[w, b]. The TPU kernel walks the table in 1024-bucket register
// tiles on a sequential grid, then combines its 1024 lanes with suffix
// scans and ten doublings. Here, as there, lanes interleave: window w is
// split over T lanes (a power of two, ops/cuda_msm.py `bucket_threads`),
// bucket b = s * T + l goes to lane l at slab s, and
//   sum_b b * B_b = sum_l (T * W_l + l * R_l),
//   R_l = sum_s B[s T + l],  W_l = sum_s s * B[s T + l].
// `bucket_walk_kernel` gives every lane one thread, Wn * T threads over the
// card: each walks its slabs from the top, adding the running sum R into W
// before adding the bucket (so W ends as sum_s s B, the TPU's W - R), then
// forms its own T * W_l + l * R_l by a joint double-and-add (log2 T
// doublings, an add of R_l per set bit of l). Neighbouring lanes are
// neighbouring threads and read neighbouring columns; buckets past NB read
// as infinity; bucket 0 (lane 0, slab 0) keeps weight 0. The window total
// is then a plain sum over its T lanes: `point_sum_kernel` sums groups of J
// points by a shared-memory halving tree, once per factor J (one or two
// more launches at the main path's sizes).
//
// ops/cuda_msm.py's plain version runs the same schedule (bit-equal
// results); the contract (msm_sim.weighted_bucket_total) sums in another
// order, so against it the results agree as affine points, not as Jacobian
// coordinates.
//
// K7 replaces `horner_total` (`_build_horner`): sum_w 2^(c*w) * W_w over at
// most a few dozen windows, by Horner's chain from the top window: c
// doublings and one complete add per window (the order of
// msm._horner_windows). A batch of B MSMs (ops/msm.py `msm_batch`) gives B
// independent chains over (3R, B, Wn) window totals; they run in one launch
// of B one-warp blocks, block b on element b's Wn windows (limb rows at
// stride B * Wn), where the JAX package launches its kernel once per
// element: B chains in a row would cost B times the chain's latency. The chain is serial, so one thread ran it before,
// each group op's 7 (doubling) or 16 (add) products one after another
// (~5.5 us per G1 op, ~14.9 us per G2 op on the H100, PERF.md). The products
// of one op are not a chain: a doubling's fall into 3 levels (3, 3, 1), an
// add's into 5, and at G2 each Fq2 product is 3 independent Fq products. So
// here one warp runs the chain, and each op is a program of steps of
// independent Fq operations (ops/warp_program.py, passed in as data), one
// operation per lane: lane l loads its operands from a shared slot file,
// multiplies, adds or subtracts, and stores its result in a fresh slot;
// __syncwarp() separates the steps. add_core's edge cases keep
// their order (P == Q doubles, p at infinity gives q, q at infinity gives
// p), on flags that every lane reads alike. Every field result is
// canonical, so the output equals the sequential chain
// (msm_sim.horner_total) bit for bit.
//
// Bound on the H100: K6 is integer multiply-adds, two complete adds per
// bucket, and a latency chain per thread: a group add is 16 Montgomery
// products whose carry chains run one dependent instruction after another.
// The first Hopper design gave one block to a window (16-22 blocks on 132
// SMs), each thread a contiguous bucket range (uncoalesced reads) and a
// chain of ~2 NB / 256 dependent adds (12 ms at 16 x 32769 buckets,
// PERF.md). A running-sum combine of the lanes inside one block per window,
// as the TPU kernel combines, would still run a chain of ~80 dependent
// group ops on 16-22 blocks. Here the longest chain is the walk's
// 2 * ceil(NB / T) adds plus log2 T doublings and their adds, on ~2^15
// threads, and log2 J adds per sum launch; the field products are calls
// (field.cuh `gmul`), which keeps the walk's loop small (inlined, it took
// 2.3-2.8x as long). K7 is a latency chain: its bound is one op's product
// depth per op, not the card's multiply rate.

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

// tbl: (3R, Wn, NB); g: (3R, Wn, T) = T * W_l + l * R_l per window and lane
template <class F>
__global__ void __launch_bounds__(128)
bucket_walk_kernel(const int32_t* __restrict__ tbl, int32_t* __restrict__ g, long long Wn, long long NB,
                   long long T, int log2T) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long lanes = Wn * T;
  if (i >= lanes) return;
  const long long w = i / T, l = i % T;
  const long long S = (NB + T - 1) / T;
  Jac<F> rs = jac_infinity<F>(), ws = jac_infinity<F>();
  for (long long s = S - 1; s >= 0; s--) {
    ws = add_core(ws, rs);
    const long long b = s * T + l;
    if (b < NB) rs = add_core(rs, load_jac<F>(tbl, Wn * NB, w * NB + b));
  }
  // T * ws + l * rs: ws stands for the bit of T, then one doubling per
  // lower bit, adding rs where l has the bit
  for (int bit = log2T - 1; bit >= 0; bit--) {
    ws = dbl_core(ws);
    if ((l >> bit) & 1) ws = add_core(ws, rs);
  }
  store_jac(g, lanes, i, ws);
}

// in: (3R, Wn, n) points; out: (3R, Wn, Q), Q = ceil(n / J): block (w, q)
// sums in[w, q*J : q*J + J) (infinity past n) by a halving tree.
template <class F, int JMAX>
__global__ void __launch_bounds__(JMAX)
point_sum_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long Wn, long long n) {
  __shared__ Jac<F> part[JMAX];
  const int J = blockDim.x;
  const long long Q = (n + J - 1) / J;
  const long long w = blockIdx.x / Q, q = blockIdx.x % Q;
  const int j = threadIdx.x;
  const long long i = q * J + j;
  part[j] = i < n ? load_jac<F>(in, Wn * n, w * n + i) : jac_infinity<F>();
  __syncthreads();
  for (int s = J / 2; s > 0; s >>= 1) {
    if (j < s) part[j] = add_core(part[j], part[j + s]);
    __syncthreads();
  }
  if (j == 0) store_jac(out, Wn * Q, w * Q + q, part[0]);
}

namespace {

using Fq = Fp<FqMod>;
constexpr int kLanes = 32;
constexpr int kSlots = 256;     // shared slot file (ops/warp_program.py SLOTS)
constexpr int kCodeMax = 4096;  // program words (CODE_MAX)
// program header (ops/warp_program.py H_*)
constexpr int kDblSteps = 0, kAddSteps = 1, kDblOut = 2, kAddOut = 8, kH = 14, kRr = 16, kHeader = 18;

// x, or q - x (q for x == 0, which the add that takes it reduces): a sub is
// an add of this, so the lanes of an add or sub step run one path
__device__ __forceinline__ Fq negate_if(const Fq& x, bool neg) {
  uint32_t p[8], d[8];
  modulus_words<FqMod>(p);
  sub8(d, p, x.v);
  Fq r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = neg ? d[i] : x.v[i];
  return r;
}

// One program's steps: lane l runs word l of each step (kind << 30 | dst
// << 20 | a << 10 | b; kind 0 idle, 1 product, 2 add, 3 sub).
__device__ __forceinline__ void run_steps(Fq* slot, const uint32_t* code, int n_steps, int lane) {
  for (int s = 0; s < n_steps; s++) {
    const uint32_t op = code[s * kLanes + lane];
    const uint32_t kind = op >> 30;
    if (kind) {
      const Fq x = slot[(op >> 10) & 1023u], y = slot[op & 1023u];
      slot[(op >> 20) & 1023u] = kind == 1 ? mul(x, y) : add(x, negate_if(y, kind == 3));
    }
    __syncwarp();
  }
}

// slot[i] = slot[src[i]] for the point's 3E elements (src outside [0, 3E))
template <int E>
__device__ __forceinline__ void take_point(Fq* slot, const uint32_t* src, int lane) {
  if (lane < 3 * E) {
    const Fq v = slot[src[lane]];
    slot[lane] = v;
  }
  __syncwarp();
}

__device__ __forceinline__ bool slots_zero(const Fq* slot, const uint32_t* idx, int n) {
  bool z = true;
  for (int i = 0; i < n; i++) z = z && is_zero(slot[idx[i]]);
  return z;
}

}  // namespace

// F: the coordinate field, E = 1 (G1) or 2 (G2) Fq elements per coordinate.
// Element i of a point is limb rows [16 i, 16 i + 16) of its planes and
// slot i (p) or 3E + i (q). Block b runs batch element b: its windows are
// wins[:, b, :] of the (3R, B, Wn) planes, its total out[:, b] of (3R, B).
template <class F>
__global__ void __launch_bounds__(kLanes) horner_kernel(const int32_t* __restrict__ wins, int32_t* __restrict__ out,
                                                        long long B, long long Wn, int c,
                                                        const int32_t* __restrict__ prog, int prog_len) {
  constexpr int E = Field<F>::rows / 16;
  __shared__ Fq slot[kSlots];
  __shared__ uint32_t code[kCodeMax];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x, stride = B * Wn;  // limb rows of the planes
  wins += b * Wn;
  for (int i = lane; i < prog_len; i += kLanes) code[i] = (uint32_t)prog[i];
  if (lane < 3 * E) slot[lane] = Field<Fq>::load(wins + 16LL * lane * stride + (Wn - 1), stride);
  __syncwarp();
  const int n_dbl = (int)code[kDblSteps], n_add = (int)code[kAddSteps];
  const uint32_t* dbl = code + kHeader;
  const uint32_t* add_prog = dbl + n_dbl * kLanes;
  const uint32_t q_z[2] = {5 * E, 5 * E + 1}, p_z[2] = {2 * E, 2 * E + 1};
  for (long long w = Wn - 2; w >= 0; w--) {
    for (int i = 0; i < c; i++) {
      run_steps(slot, dbl, n_dbl, lane);
      take_point<E>(slot, code + kDblOut, lane);
    }
    if (lane < 3 * E) slot[3 * E + lane] = Field<Fq>::load(wins + 16LL * lane * stride + w, stride);
    __syncwarp();
    run_steps(slot, add_prog, n_add, lane);
    // add_core's selects, in its order: q at infinity keeps p
    if (slots_zero(slot, q_z, E)) continue;
    if (slots_zero(slot, p_z, E)) {
      if (lane < 3 * E) slot[lane] = slot[3 * E + lane];
      __syncwarp();
    } else if (slots_zero(slot, code + kH, E) && slots_zero(slot, code + kRr, E)) {
      run_steps(slot, dbl, n_dbl, lane);  // P == Q
      take_point<E>(slot, code + kDblOut, lane);
    } else {
      take_point<E>(slot, code + kAddOut, lane);
    }
  }
  if (lane < 3 * E) Field<Fq>::store(out + 16LL * lane * B + b, B, slot[lane]);
}

// tbl: (3R, Wn, NB) int32 bucket planes; g: (3R, Wn, T) int32, the lanes'
// weighted totals. T lanes per window, a power of two (2^log2T).
extern "C" int kzk_bucket_walk(const void* tbl, void* g, long long Wn, long long NB, long long T, int log2T,
                               int g2, void* stream) {
  if (Wn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  const long long blocks = (Wn * T + threads - 1) / threads;
  if (g2)
    bucket_walk_kernel<Fq2><<<blocks, threads, 0, s>>>((const int32_t*)tbl, (int32_t*)g, Wn, NB, T, log2T);
  else
    bucket_walk_kernel<Fp<FqMod>><<<blocks, threads, 0, s>>>((const int32_t*)tbl, (int32_t*)g, Wn, NB, T, log2T);
  return (int)cudaGetLastError();
}

// in: (3R, Wn, n); out: (3R, Wn, ceil(n / J)); J threads per block, a power
// of two, at most 256 (G1) or 128 (G2).
extern "C" int kzk_point_sum(const void* in, void* out, long long Wn, long long n, int J, int g2, void* stream) {
  if (Wn == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = Wn * ((n + J - 1) / J);
  if (g2)
    point_sum_kernel<Fq2, 128><<<blocks, J, 0, s>>>((const int32_t*)in, (int32_t*)out, Wn, n);
  else
    point_sum_kernel<Fp<FqMod>, 256><<<blocks, J, 0, s>>>((const int32_t*)in, (int32_t*)out, Wn, n);
  return (int)cudaGetLastError();
}

// wins: (3R, B, Wn) int32 window totals; out: (3R, B), out[:, b] =
// sum_w 2^(c*w) W[:, b, w]; prog: the group's program (ops/warp_program.py
// `encode`), prog_len words. One block of one warp per batch element.
extern "C" int kzk_horner_total(const void* wins, void* out, long long B, long long Wn, int c, const void* prog,
                                int prog_len, int g2, void* stream) {
  if (B == 0 || Wn == 0) return 0;
  if (prog_len > kCodeMax || B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* w = (const int32_t*)wins;
  const auto* p = (const int32_t*)prog;
  if (g2)
    horner_kernel<Fq2><<<(unsigned)B, kLanes, 0, s>>>(w, (int32_t*)out, B, Wn, c, p, prog_len);
  else
    horner_kernel<Fq><<<(unsigned)B, kLanes, 0, s>>>(w, (int32_t*)out, B, Wn, c, p, prog_len);
  return (int)cudaGetLastError();
}
