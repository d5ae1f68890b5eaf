// K3: batched complete group-law ops -- mixed add, doubling and full add --
// on G1 (Fq) and G2 (Fq2) point batches.
//
// Replaces keyless_zk_tpu/ops/pallas_curve.py `madd_pallas`, `dbl_pallas`
// and `add_pallas` (one `_build` pallas_call with three bodies). The callers
// are key setup's fixed-base ladder (circuits/setup.py: one doubling and one
// mixed add of the generator per scalar bit, over 2^21-point passes) and
// the small-n MSM (ops/msm.py `_msm_small`); the full add sums the sharded
// MSM's partials (parallel/sharded.py `sharded_msm`).
// The mixed add is the complete one (ec.cuh `madd_complete`: infinity on
// either side, P == Q by the affine doubling, P == -Q), unlike K4's scan,
// which skips P == Q. Its affine operand may be one point for the whole
// batch (nq == 1), as the setup's generator is.
//
// One thread owns one point: it reads its coordinates straight from the
// port's (n, 16) / (n, 2, 16) int32 rows (64 or 128 contiguous bytes) as
// 16-byte vectors and writes its result rows the same way. The TPU kernels
// relayout every coordinate to limb-major (R, tiles, 8, 128) blocks so that
// each vector load is one limb of 1024 points; here nothing is relaid.
// The first port's 4-byte accesses used 4 of every 32 bytes a warp moved;
// staging a block's rows through shared memory with coalesced cp.async
// copies was measured too and ran no faster than the 16-byte rows
// (tools/kernel_variants.py, PERF.md). With nq == 1 every thread reads the
// one generator, and its infinity flag is read once per block.
//
// The group law is ec.cuh's, in its order, so the outputs equal the JAX
// package's and the plain versions' in Jacobian coordinates, bit for bit.
// For K4-K7, ec.cuh puts every G2 group-law function and Fq2 product behind
// a call (their loops need that to build in seconds), and field.cuh's Fq
// product `gmul` takes its operands by reference, so every product passes
// them through the local-memory stack. K3's kernels have no loop: here both
// fields run on K3's own types (FqK3, Fq2K3), the same values with the group
// law and the Fq2 products inlined into the kernel and the Fq product a call
// that takes its operands by value (`k3_mul`). That left no stack frame in
// the doublings and G1's mixed add; inlining the Fq product as well made the
// kernels 4-10x larger and slower (tools/kernel_variants.py, PERF.md).
//
// Bound on the H100: 384 (G1) or 768 (G2) bytes of points in and out per
// doubling against 7 (G1) or 16 (G2) Fq products of 264 multiply-adds; a
// mixed add moves the same bytes for 11 or 29 products, a full add 576
// or 1152 bytes for 16 or 43. G1's doubling is bound by bytes, the rest by
// the products; each runs at 30-50% of its bound, held back by the
// latency of the products' carry chains at the occupancy their registers
// allow (one product is most of K1's 760 SASS instructions for its 264
// multiply-adds; PERF.md). The full add no longer branches to a doubling
// (`add_complete` below).

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

namespace {

// ---- K3's coordinate fields ---------------------------------------------------

// K3's Fq product: field.cuh's `mul` behind a call, as the group law's
// `gmul` is, but taking its operands by value (in registers) where `gmul`
// takes references, which pass each product's operands through the
// local-memory stack
__device__ __noinline__ Fp<FqMod> k3_mul(Fp<FqMod> a, Fp<FqMod> b) { return mul(a, b); }

// Fq (G1) and Fq2 (G2) values whose products are `k3_mul`; the Fq2 products
// and the group law are inlined into the kernels
struct FqK3 {
  Fp<FqMod> v;
};
struct Fq2K3 {
  Fp<FqMod> c0, c1;
};

__device__ __forceinline__ FqK3 add(const FqK3& a, const FqK3& b) { return {kzk::add(a.v, b.v)}; }
__device__ __forceinline__ FqK3 sub(const FqK3& a, const FqK3& b) { return {kzk::sub(a.v, b.v)}; }
__device__ __forceinline__ bool is_zero(const FqK3& a) { return kzk::is_zero(a.v); }
__device__ __forceinline__ FqK3 gmul(const FqK3& a, const FqK3& b) { return {k3_mul(a.v, b.v)}; }
__device__ __forceinline__ FqK3 gsqr(const FqK3& a) { return {k3_mul(a.v, a.v)}; }

__device__ __forceinline__ Fq2K3 add(const Fq2K3& a, const Fq2K3& b) {
  return {kzk::add(a.c0, b.c0), kzk::add(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2K3 sub(const Fq2K3& a, const Fq2K3& b) {
  return {kzk::sub(a.c0, b.c0), kzk::sub(a.c1, b.c1)};
}
__device__ __forceinline__ bool is_zero(const Fq2K3& a) { return kzk::is_zero(a.c0) && kzk::is_zero(a.c1); }
__device__ __forceinline__ FqK3 select(bool c, const FqK3& a, const FqK3& b) { return {kzk::select(c, a.v, b.v)}; }
__device__ __forceinline__ Fq2K3 select(bool c, const Fq2K3& a, const Fq2K3& b) {
  return {kzk::select(c, a.c0, b.c0), kzk::select(c, a.c1, b.c1)};
}

// field.cuh's Fq2 `mul` (Karatsuba, 3 Fq products) and `sqr` (2)
__device__ __forceinline__ Fq2K3 gmul(const Fq2K3& a, const Fq2K3& b) {
  const Fp<FqMod> t0 = k3_mul(a.c0, b.c0);
  const Fp<FqMod> t1 = k3_mul(a.c1, b.c1);
  const Fp<FqMod> t2 = k3_mul(kzk::add(a.c0, a.c1), kzk::add(b.c0, b.c1));
  return {kzk::sub(t0, t1), kzk::sub(kzk::sub(t2, t0), t1)};
}
__device__ __forceinline__ Fq2K3 gsqr(const Fq2K3& a) {
  const Fp<FqMod> re = k3_mul(kzk::add(a.c0, a.c1), kzk::sub(a.c0, a.c1));
  const Fp<FqMod> t = k3_mul(a.c0, a.c1);
  return {re, kzk::add(t, t)};
}

}  // namespace

namespace kzk {
template <>
struct Field<FqK3> {
  static constexpr int rows = 16;
  __device__ __forceinline__ static FqK3 zero() { return {fp_zero<FqMod>()}; }
  __device__ __forceinline__ static FqK3 one() { return {fp_one<FqMod>()}; }
};
template <>
struct Field<Fq2K3> {
  static constexpr int rows = 32;
  __device__ __forceinline__ static Fq2K3 zero() { return {fp_zero<FqMod>(), fp_zero<FqMod>()}; }
  __device__ __forceinline__ static Fq2K3 one() { return {fp_one<FqMod>(), fp_zero<FqMod>()}; }
};
}  // namespace kzk

namespace {

using G1 = FqK3;
using G2 = Fq2K3;

constexpr int THREADS = 128;

// Blocks of THREADS per SM that ptxas must fit, per kernel and field: a
// register budget of 65536 / (THREADS x blocks) per thread (2 blocks leave
// ptxas's cap of 255). From the measured sweep (tools/kernel_variants.py
// `k3_budget_*`, PERF.md): G1's mixed add runs faster unbound (146
// registers) than held to 128 with spills; G2's runs faster held to 128
// with spills (four blocks) than to 96 (five), 168 (three) or unbound at
// 255 (two); the doublings need no bound. The full add runs fastest at
// three blocks for both fields (G1 168 registers, G2 168 with spills),
// against two (G1 175, G2 255 and spills) and four (128, spills).
template <class F>
struct Budget {
  static constexpr int madd = 2, dbl = 4, add = 3;
};
template <>
struct Budget<G2> {
  static constexpr int madd = 4, dbl = 2, add = 3;
};

// ---- rows of 16-bit limbs held in int32, two limbs to a word ---------------------

// an element from its row (c0 limbs, then c1), read as 16-byte vectors
template <class F>
__device__ __forceinline__ F unpack(const int32_t* row) {
  F r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
  const int4* v = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int k = 0; k < (int)sizeof(F) / 8; k++) {
    const int4 q = v[k];
    w[2 * k] = ((uint32_t)q.x & 0xffffu) | ((uint32_t)q.y << 16);
    w[2 * k + 1] = ((uint32_t)q.z & 0xffffu) | ((uint32_t)q.w << 16);
  }
  return r;
}

template <class F>
__device__ __forceinline__ void pack(int32_t* row, const F& a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&a);
  int4* v = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int k = 0; k < (int)sizeof(F) / 8; k++) {
    const uint32_t lo = w[2 * k], hi = w[2 * k + 1];
    v[k] = make_int4((int)(lo & 0xffffu), (int)(lo >> 16), (int)(hi & 0xffffu), (int)(hi >> 16));
  }
}

template <class F>
__device__ __forceinline__ Jac<F> load_point(const int32_t* x, const int32_t* y, const int32_t* z, long long i) {
  constexpr int R = Field<F>::rows;
  return {unpack<F>(x + i * R), unpack<F>(y + i * R), unpack<F>(z + i * R)};
}

template <class F>
__device__ __forceinline__ void store_point(int32_t* x, int32_t* y, int32_t* z, long long i, const Jac<F>& p) {
  constexpr int R = Field<F>::rows;
  pack(x + i * R, p.x);
  pack(y + i * R, p.y);
  pack(z + i * R, p.z);
}

template <class F>
__global__ void __launch_bounds__(THREADS, Budget<F>::madd)
madd_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
            const int32_t* __restrict__ qx, const int32_t* __restrict__ qy, const uint8_t* __restrict__ qinf,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
            long long nq) {
  constexpr int R = Field<F>::rows;
  const bool bcast = nq == 1;
  __shared__ bool q_inf_once;  // the broadcast operand's flag
  if (bcast && threadIdx.x == 0) q_inf_once = qinf[0] != 0;
  __syncthreads();
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= n) return;
  const long long iq = bcast ? 0 : i;
  const bool q_inf = bcast ? q_inf_once : qinf[i] != 0;
  store_point<F>(ox, oy, oz, i,
                 madd_complete(load_point<F>(ax, ay, az, i), unpack<F>(qx + iq * R), unpack<F>(qy + iq * R), q_inf));
}

template <class F>
__global__ void __launch_bounds__(THREADS, Budget<F>::dbl)
dbl_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
           int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= n) return;
  store_point<F>(ox, oy, oz, i, dbl_core(load_point<F>(ax, ay, az, i)));
}

// The complete Jacobian add, P + Q: add-2007-bl, and dbl-2009-l of P in
// the lanes where P == Q, with ec.cuh `add_core`'s values and order of
// selects. `add_core` computes the add in every lane and then branches to
// `dbl_core`, so a warp with one doubling lane paid for both: 16 + 7 Fq
// products (G1), 43 + 16 (G2). Here the doubling runs inside the add's own
// products: once the first eight products have decided P == Q (h == 0 and
// r == 0), each of the last eight takes its operands per lane, the add's
// or the doubling's, so every lane makes the add's 16 products and no lane
// branches. The doubling's seven products fit those eight in the order of
// their dependencies (each squaring of the doubling in a squaring or a
// product of the add, so G2 makes no more Fq products either). Every
// value is canonical, so the doubling's result equals dbl_core's bit for bit.
template <class F>
__device__ __forceinline__ Jac<F> add_complete(const Jac<F>& p, const Jac<F>& q) {
  const F z1z1 = gsqr(p.z);
  const F z2z2 = gsqr(q.z);
  const F u1 = gmul(p.x, z2z2);
  const F u2 = gmul(q.x, z1z1);
  const F s1 = gmul(gmul(p.y, q.z), z2z2);
  const F s2 = gmul(gmul(q.y, p.z), z1z1);
  const F h = sub(u2, u1);
  const F rr = sub(s2, s1);
  const bool p_inf = is_zero(p.z), q_inf = is_zero(q.z);
  const bool d = is_zero(h) && !p_inf && !q_inf && is_zero(rr);  // P == Q: double P
  const F r2 = add(rr, rr);
  // the last eight products, "doubling | add"
  const F m1 = gsqr(select(d, p.x, add(p.z, q.z)));  // A = x1^2 | (z1 + z2)^2
  const F m2 = gsqr(select(d, p.y, add(h, h)));      // B = y1^2 | i4 = (2h)^2
  const F m3 = gsqr(select(d, m2, r2));              // C = B^2 | r2^2
  const F xb = add(p.x, m2);
  const F m4 = gmul(select(d, xb, h), select(d, xb, m2));  // (x1 + B)^2 | j = h i4
  const F e3 = add(add(m1, m1), m1);                       // E = 3A
  const F m5 = gmul(select(d, e3, u1), select(d, e3, m2));  // E^2 | v = u1 i4
  const F zz = sub(sub(m1, z1z1), z2z2);
  const F m6 = gmul(select(d, add(p.y, p.y), zz), select(d, p.z, h));  // z3 = 2 y1 z1 | z3 = zz h
  const F m7 = gmul(s1, m4);                                            // - | s1 j
  const F t = sub(sub(m4, m1), m3);
  const F dd = add(t, t);                                                // D
  const F x3 = select(d, sub(m5, add(dd, dd)), sub(sub(m3, m4), add(m5, m5)));
  const F m8 = gmul(select(d, e3, r2), select(d, sub(dd, x3), sub(m5, x3)));  // E (D - x3) | r2 (v - x3)
  const F c2 = add(m3, m3), c4 = add(c2, c2);
  const F y3 = sub(m8, select(d, add(c4, c4), add(m7, m7)));  // - 8C | - 2 s1 j
  Jac<F> out = {x3, y3, m6};
  if (p_inf) out = q;
  if (q_inf) out = p;
  return out;
}

template <class F>
__global__ void __launch_bounds__(THREADS, Budget<F>::add)
add_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
           const int32_t* __restrict__ bx, const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
           int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= n) return;
  store_point<F>(ox, oy, oz, i, add_complete(load_point<F>(ax, ay, az, i), load_point<F>(bx, by, bz, i)));
}

// Launch `kernel` over n points, one per thread
template <auto kernel, class... A>
int launch(long long n, void* stream, A... args) {
  kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

const int32_t* ro(const void* p) { return (const int32_t*)p; }
int32_t* rw(void* p) { return (int32_t*)p; }

}  // namespace

// Coordinates are contiguous (n, R) int32 rows, 16-byte aligned, R = 16
// (G1) or 32 (G2: c0 limbs then c1 limbs); g2 selects the field. q rows and
// qinf repeat over the batch when nq == 1.
extern "C" int kzk_curve_madd(const void* ax, const void* ay, const void* az, const void* qx, const void* qy,
                              const void* qinf, void* ox, void* oy, void* oz, long long n, long long nq, int g2,
                              void* stream) {
  if (n == 0) return 0;
  const uint8_t* qi = (const uint8_t*)qinf;
  if (g2)
    return launch<madd_kernel<G2>>(n, stream, ro(ax), ro(ay), ro(az), ro(qx), ro(qy), qi, rw(ox), rw(oy), rw(oz),
                                   n, nq);
  return launch<madd_kernel<G1>>(n, stream, ro(ax), ro(ay), ro(az), ro(qx), ro(qy), qi, rw(ox), rw(oy), rw(oz), n,
                                 nq);
}

extern "C" int kzk_curve_dbl(const void* ax, const void* ay, const void* az, void* ox, void* oy, void* oz,
                             long long n, int g2, void* stream) {
  if (n == 0) return 0;
  if (g2)
    return launch<dbl_kernel<G2>>(n, stream, ro(ax), ro(ay), ro(az), rw(ox), rw(oy), rw(oz), n);
  return launch<dbl_kernel<G1>>(n, stream, ro(ax), ro(ay), ro(az), rw(ox), rw(oy), rw(oz), n);
}

extern "C" int kzk_curve_add(const void* ax, const void* ay, const void* az, const void* bx, const void* by,
                             const void* bz, void* ox, void* oy, void* oz, long long n, int g2, void* stream) {
  if (n == 0) return 0;
  if (g2)
    return launch<add_kernel<G2>>(n, stream, ro(ax), ro(ay), ro(az), ro(bx), ro(by), ro(bz), rw(ox), rw(oy),
                                  rw(oz), n);
  return launch<add_kernel<G1>>(n, stream, ro(ax), ro(ay), ro(az), ro(bx), ro(by), ro(bz), rw(ox), rw(oy), rw(oz),
                                n);
}
