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
// The group-law functions are __noinline__: inlined, the G2 kernels grew to
// hundreds of thousands of instructions that took ptxas minutes to
// schedule; a call costs little beside the 11-33 field products inside.
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
__device__ __noinline__ Jac<F> dbl_core(const Jac<F>& p) {
  F A = sqr(p.x);
  F B = sqr(p.y);
  F C = sqr(B);
  F t = sub(sub(sqr(add(p.x, B)), A), C);
  F D = add(t, t);
  F E = add(add(A, A), A);
  F Ff = sqr(E);
  F x3 = sub(Ff, add(D, D));
  F c8 = add(add(C, C), add(C, C));
  c8 = add(c8, c8);
  F y3 = sub(mul(E, sub(D, x3)), c8);
  F z3 = mul(add(p.y, p.y), p.z);
  return {x3, y3, z3};
}

// madd-2007-bl without its edge cases; h and rr are left for the caller's
// P == +-Q test.
template <class F>
__device__ __forceinline__ Jac<F> madd_formula(const Jac<F>& p, const F& x2, const F& y2, F& h, F& rr) {
  F z1z1 = sqr(p.z);
  F u2 = mul(x2, z1z1);
  F s2 = mul(mul(y2, p.z), z1z1);
  h = sub(u2, p.x);
  rr = sub(s2, p.y);
  F r2 = add(rr, rr);
  F hh = sqr(h);
  F i4 = add(add(hh, hh), add(hh, hh));
  F j = mul(h, i4);
  F v = mul(p.x, i4);
  F x3 = sub(sub(sqr(r2), j), add(v, v));
  F yj = mul(p.y, j);
  F y3 = sub(mul(r2, sub(v, x3)), add(yj, yj));
  F z3 = sub(sub(sqr(add(p.z, h)), z1z1), hh);
  return {x3, y3, z3};
}

// Mixed add: Jacobian p + affine (x2, y2) with infinity flag, without the
// P == Q doubling (pallas_ec.madd_core with assume_distinct). Precondition:
// no partial bucket sum equals the incoming table point, which holds for
// deduplicated tables of points with random discrete logs; P == Q gives a
// wrong result, not an error.
template <class F>
__device__ __noinline__ Jac<F> madd_core(const Jac<F>& p, const F& x2, const F& y2, bool q_inf) {
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
__device__ __noinline__ Jac<F> dbl_affine_core(const F& x, const F& y) {
  F A = sqr(x);
  F B = sqr(y);
  F C = sqr(B);
  F t = sub(sub(sqr(add(x, B)), A), C);
  F D = add(t, t);
  F E = add(add(A, A), A);
  F x3 = sub(sqr(E), add(D, D));
  F c8 = add(add(C, C), add(C, C));
  c8 = add(c8, c8);
  F y3 = sub(mul(E, sub(D, x3)), c8);
  return {x3, y3, add(y, y)};
}

// Complete mixed add (pallas_ec.madd_core without assume_distinct), with
// its order of selects: P == Q doubles the affine point; P == -Q leaves
// z3 == 0 from the formula; p at infinity gives (x2, y2, q_inf ? 0 : 1)
// (so both at infinity give (x2, y2, 0)); q at infinity alone gives p.
// The doubling runs only in the lanes that need it.
template <class F>
__device__ __noinline__ Jac<F> madd_complete(const Jac<F>& p, const F& x2, const F& y2, bool q_inf) {
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
__device__ __noinline__ Jac<F> add_core(const Jac<F>& p, const Jac<F>& q) {
  F z1z1 = sqr(p.z);
  F z2z2 = sqr(q.z);
  F u1 = mul(p.x, z2z2);
  F u2 = mul(q.x, z1z1);
  F s1 = mul(mul(p.y, q.z), z2z2);
  F s2 = mul(mul(q.y, p.z), z1z1);
  F h = sub(u2, u1);
  F rr = sub(s2, s1);
  F r2 = add(rr, rr);
  F i4 = sqr(add(h, h));
  F j = mul(h, i4);
  F v = mul(u1, i4);
  F x3 = sub(sub(sqr(r2), j), add(v, v));
  F s1j = mul(s1, j);
  F y3 = sub(mul(r2, sub(v, x3)), add(s1j, s1j));
  F zz = sub(sub(sqr(add(p.z, q.z)), z1z1), z2z2);
  F z3 = mul(zz, h);
  Jac<F> out = {x3, y3, z3};

  bool p_inf = is_zero(p.z);
  bool q_inf = is_zero(q.z);
  if (is_zero(h) && !p_inf && !q_inf && is_zero(rr)) out = dbl_core(p);
  if (p_inf) out = q;
  if (q_inf) out = p;
  return out;
}

}  // namespace kzk
