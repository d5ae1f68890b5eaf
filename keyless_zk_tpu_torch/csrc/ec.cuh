// BN254 Jacobian group law for Hopper, device side, generic over the
// coordinate field (Fp<FqMod> for G1, Fq2 for G2).
//
// Replaces keyless_zk_tpu/ops/pallas_ec.py (`dbl_core`, `madd_core`,
// `dbl_affine_core`, `add_core`), which the Pallas kernels inline; K3-K7
// (curve_ops.cu, msm_scan.cu, msm_merge.cu, msm_reduce.cu) share it here. The formulas
// (dbl-2009-l, add-2007-bl, madd-2007-bl) and their order of operations are
// those of the JAX package, so a kernel that adds in the same order as its
// JAX counterpart gives the same Jacobian coordinates, bit for bit.
//
// Inlining depends on the field. For G1 every group-law function is a
// __forceinline__ template, so a kernel's accumulator stays in registers
// across its loop: as calls, each step passed and returned its points
// through the local-memory stack. For G2 each function is a __noinline__
// overload of the same body: inlined, the G2 kernels grew to hundreds of
// thousands of instructions that took ptxas minutes to schedule, and a call
// costs little beside the 33 Fq products of a G2 add (the kernels build in
// ~21 s on the H100's host, PERF.md). The field products inside are calls
// for both fields (field.cuh `gmul`, `gsqr`), which keeps each kernel's
// loop small (field.cuh says what inlining them cost).
//
// A point is three coordinates in registers (24 words for G1, 48 for G2);
// infinity is z == 0. At the kernel boundary a point is 3 * R rows of
// 16-bit limbs (R = 16 for G1, 32 for G2): coordinate c, limb row r of
// element i sits at base[(c * R + r) * stride + i].

#pragma once
#include "field.cuh"

namespace kzk {

template <class F>
struct Jac {
  F x, y, z;
};

// the G2 calls (defined at the end, after the bodies they call)
static __device__ __noinline__ Jac<Fq2> dbl_core(const Jac<Fq2>& p);
static __device__ __noinline__ Jac<Fq2> madd_core(const Jac<Fq2>& p, const Fq2& x2, const Fq2& y2, bool q_inf);
static __device__ __noinline__ Jac<Fq2> dbl_affine_core(const Fq2& x, const Fq2& y);
static __device__ __noinline__ Jac<Fq2> madd_complete(const Jac<Fq2>& p, const Fq2& x2, const Fq2& y2, bool q_inf);
static __device__ __noinline__ Jac<Fq2> add_core(const Jac<Fq2>& p, const Jac<Fq2>& q);

template <class F>
__device__ __forceinline__ Jac<F> jac_select(bool c, const Jac<F>& a, const Jac<F>& b) {
  return {select(c, a.x, b.x), select(c, a.y, b.y), select(c, a.z, b.z)};
}

template <class F>
__device__ __forceinline__ Jac<F> jac_infinity() {
  return {Field<F>::zero(), Field<F>::zero(), Field<F>::zero()};
}

template <class F>
__device__ __forceinline__ Jac<F> load_jac(const int32_t* base, long long stride, long long i) {
  constexpr int R = Field<F>::rows;
  return {Field<F>::load(base + i, stride), Field<F>::load(base + R * stride + i, stride),
          Field<F>::load(base + 2 * R * stride + i, stride)};
}

template <class F>
__device__ __forceinline__ void store_jac(int32_t* base, long long stride, long long i, const Jac<F>& p) {
  constexpr int R = Field<F>::rows;
  Field<F>::store(base + i, stride, p.x);
  Field<F>::store(base + R * stride + i, stride, p.y);
  Field<F>::store(base + 2 * R * stride + i, stride, p.z);
}

template <class F>
__device__ __forceinline__ Jac<F> dbl_core(const Jac<F>& p) {
  F A = gsqr(p.x);
  F B = gsqr(p.y);
  F C = gsqr(B);
  F t = sub(sub(gsqr(add(p.x, B)), A), C);
  F D = add(t, t);
  F E = add(add(A, A), A);
  F Ff = gsqr(E);
  F x3 = sub(Ff, add(D, D));
  F c8 = add(add(C, C), add(C, C));
  c8 = add(c8, c8);
  F y3 = sub(gmul(E, sub(D, x3)), c8);
  F z3 = gmul(add(p.y, p.y), p.z);
  return {x3, y3, z3};
}

// madd-2007-bl without its edge cases; h and rr are left for the caller's
// P == +-Q test.
template <class F>
__device__ __forceinline__ Jac<F> madd_formula(const Jac<F>& p, const F& x2, const F& y2, F& h, F& rr) {
  F z1z1 = gsqr(p.z);
  F u2 = gmul(x2, z1z1);
  F s2 = gmul(gmul(y2, p.z), z1z1);
  h = sub(u2, p.x);
  rr = sub(s2, p.y);
  F r2 = add(rr, rr);
  F hh = gsqr(h);
  F i4 = add(add(hh, hh), add(hh, hh));
  F j = gmul(h, i4);
  F v = gmul(p.x, i4);
  F x3 = sub(sub(gsqr(r2), j), add(v, v));
  F yj = gmul(p.y, j);
  F y3 = sub(gmul(r2, sub(v, x3)), add(yj, yj));
  F z3 = sub(sub(gsqr(add(p.z, h)), z1z1), hh);
  return {x3, y3, z3};
}

// Mixed add: Jacobian p + affine (x2, y2) with infinity flag, without the
// P == Q doubling (pallas_ec.madd_core with assume_distinct). Precondition:
// no partial bucket sum equals the incoming table point, which holds for
// deduplicated tables of points with random discrete logs; P == Q gives a
// wrong result, not an error.
template <class F>
__device__ __forceinline__ Jac<F> madd_core(const Jac<F>& p, const F& x2, const F& y2, bool q_inf) {
  F h, rr;
  Jac<F> out = madd_formula(p, x2, y2, h, rr);
  // the order of jacobian.py: with both at infinity the result is p
  if (is_zero(p.z)) out = {x2, y2, q_inf ? Field<F>::zero() : Field<F>::one()};
  if (q_inf) out = p;
  return out;
}

// Doubling of an affine point (z == 1), one product cheaper than dbl_core
// (pallas_ec.dbl_affine_core): the P == Q branch of madd_complete.
template <class F>
__device__ __forceinline__ Jac<F> dbl_affine_core(const F& x, const F& y) {
  F A = gsqr(x);
  F B = gsqr(y);
  F C = gsqr(B);
  F t = sub(sub(gsqr(add(x, B)), A), C);
  F D = add(t, t);
  F E = add(add(A, A), A);
  F x3 = sub(gsqr(E), add(D, D));
  F c8 = add(add(C, C), add(C, C));
  c8 = add(c8, c8);
  F y3 = sub(gmul(E, sub(D, x3)), c8);
  return {x3, y3, add(y, y)};
}

// Complete mixed add (pallas_ec.madd_core without assume_distinct), with
// its order of selects: P == Q doubles the affine point; P == -Q leaves
// z3 == 0 from the formula; p at infinity gives (x2, y2, q_inf ? 0 : 1)
// (so both at infinity give (x2, y2, 0)); q at infinity alone gives p.
// The doubling runs only in the lanes that need it.
template <class F>
__device__ __forceinline__ Jac<F> madd_complete(const Jac<F>& p, const F& x2, const F& y2, bool q_inf) {
  F h, rr;
  Jac<F> out = madd_formula(p, x2, y2, h, rr);
  bool p_inf = is_zero(p.z);
  if (is_zero(h) && !p_inf && !q_inf && is_zero(rr)) out = dbl_affine_core(x2, y2);
  if (p_inf) out = {x2, y2, q_inf ? Field<F>::zero() : Field<F>::one()};
  if (q_inf && !p_inf) out = p;
  return out;
}

// Complete Jacobian + Jacobian add
template <class F>
__device__ __forceinline__ Jac<F> add_core(const Jac<F>& p, const Jac<F>& q) {
  F z1z1 = gsqr(p.z);
  F z2z2 = gsqr(q.z);
  F u1 = gmul(p.x, z2z2);
  F u2 = gmul(q.x, z1z1);
  F s1 = gmul(gmul(p.y, q.z), z2z2);
  F s2 = gmul(gmul(q.y, p.z), z1z1);
  F h = sub(u2, u1);
  F rr = sub(s2, s1);
  F r2 = add(rr, rr);
  F i4 = gsqr(add(h, h));
  F j = gmul(h, i4);
  F v = gmul(u1, i4);
  F x3 = sub(sub(gsqr(r2), j), add(v, v));
  F s1j = gmul(s1, j);
  F y3 = sub(gmul(r2, sub(v, x3)), add(s1j, s1j));
  F zz = sub(sub(gsqr(add(p.z, q.z)), z1z1), z2z2);
  F z3 = gmul(zz, h);
  Jac<F> out = {x3, y3, z3};

  bool p_inf = is_zero(p.z);
  bool q_inf = is_zero(q.z);
  if (is_zero(h) && !p_inf && !q_inf && is_zero(rr)) out = dbl_core(p);
  if (p_inf) out = q;
  if (q_inf) out = p;
  return out;
}

static __device__ __noinline__ Jac<Fq2> dbl_core(const Jac<Fq2>& p) { return dbl_core<Fq2>(p); }
static __device__ __noinline__ Jac<Fq2> madd_core(const Jac<Fq2>& p, const Fq2& x2, const Fq2& y2, bool q_inf) {
  return madd_core<Fq2>(p, x2, y2, q_inf);
}
static __device__ __noinline__ Jac<Fq2> dbl_affine_core(const Fq2& x, const Fq2& y) { return dbl_affine_core<Fq2>(x, y); }
static __device__ __noinline__ Jac<Fq2> madd_complete(const Jac<Fq2>& p, const Fq2& x2, const Fq2& y2, bool q_inf) {
  return madd_complete<Fq2>(p, x2, y2, q_inf);
}
static __device__ __noinline__ Jac<Fq2> add_core(const Jac<Fq2>& p, const Jac<Fq2>& q) { return add_core<Fq2>(p, q); }

// ---- homogeneous projective coordinates: K4's complete body (G1) -----------
// (X : Y : Z) is the affine point (X / Z, Y / Z); infinity is (0 : Y : 0),
// (0 : 1 : 0) where a run starts from it. The law is Renes, Costello and
// Batina, "Complete addition formulas for prime order elliptic curves"
// (2016), Algorithm 8: the mixed add for a = 0 in 11 products and two
// multiplications by 3b, with no branch. It is complete for P == Q, for
// P == -Q and for P at infinity; an affine Q cannot be infinity, so Q at
// infinity is a select. The plain version is ops/cuda_curve.py
// `madd_proj_plain`, step for step.

template <class F>
struct Proj {
  F x, y, z;
};

// 3b for y^2 = x^3 + 3 (G1): 9 a = 8 a + a, four additions
__device__ __forceinline__ Fp<FqMod> mul_b3(const Fp<FqMod>& a) {
  Fp<FqMod> a2 = add(a, a);
  Fp<FqMod> a4 = add(a2, a2);
  return add(add(a4, a4), a);
}

// (X : Y : Z) -> Jacobian (X Z, Y Z^2, Z), the form K5 and K6 read:
// X Z / Z^2 = X / Z and Y Z^2 / Z^3 = Y / Z; infinity (Z = 0) -> z = 0
template <class F>
__device__ __forceinline__ Jac<F> proj_to_jac(const Proj<F>& p) {
  return {gmul(p.x, p.z), gmul(p.y, gsqr(p.z)), p.z};
}

// Algorithm 8, p + (x2, y2) (steps numbered as in the paper), with
// proj_to_jac(p) folded into three of its products in the lanes where
// `fold`: there steps 1, 2 and 8 take X Z, Z^2 and Y Z^2 (into `pj`)
// instead, and the sum returned is not a point. A lane whose run has just
// ended thus converts its total inside the same 11 products that its
// warp's other lanes add with, where a conversion of its own would cost
// the warp three more products at most steps.
template <class F>
__device__ __forceinline__ Proj<F> madd_proj(const Proj<F>& p, const F& x2, const F& y2, bool q_inf, bool fold,
                                             Jac<F>& pj) {
  F t0 = gmul(p.x, select(fold, p.z, x2));                  // 1: X1 X2
  F t1 = gmul(select(fold, p.z, p.y), select(fold, p.z, y2));  // 2: Y1 Y2
  F t3 = add(x2, y2);                                       // 3
  F t4 = add(p.x, p.y);                                     // 4
  t3 = gmul(t3, t4);                                        // 5
  t4 = add(t0, t1);                                         // 6
  t3 = sub(t3, t4);                                         // 7
  t4 = gmul(select(fold, p.y, y2), select(fold, t1, p.z));  // 8: Y2 Z1
  pj = {t0, t4, p.z};
  t4 = add(t4, p.y);       // 9
  F y3 = gmul(x2, p.z);    // 10
  y3 = add(y3, p.x);       // 11
  F x3 = add(t0, t0);      // 12
  t0 = add(x3, t0);        // 13
  F t2 = mul_b3(p.z);      // 14
  F z3 = add(t1, t2);      // 15
  t1 = sub(t1, t2);        // 16
  y3 = mul_b3(y3);         // 17
  x3 = gmul(t4, y3);       // 18
  t2 = gmul(t3, t1);       // 19
  x3 = sub(t2, x3);        // 20
  y3 = gmul(y3, t0);       // 21
  t1 = gmul(t1, z3);       // 22
  y3 = add(t1, y3);        // 23
  t0 = gmul(t0, t3);       // 24
  z3 = gmul(z3, t4);       // 25
  z3 = add(z3, t0);        // 26
  Proj<F> out = {x3, y3, z3};
  if (q_inf) out = p;
  return out;
}

}  // namespace kzk
