// BN254 prime-field arithmetic for Hopper (sm_90a), device side.
//
// Replaces the in-kernel limb arithmetic of the Pallas kernels
// (keyless_zk_tpu/ops/pallas_field.py `_make_kernel`, and `KFq` / `KFq2` in
// keyless_zk_tpu/ops/pallas_ec.py). The TPU VPU has no wide multiply, so
// the JAX package works on 16 limbs of 16 bits; a CUDA core multiplies
// 32 x 32 -> 64 bits, so here an element is 8 little-endian 32-bit words in
// registers, and a Montgomery product is one CIOS pass (8 outer rounds of a
// multiply-accumulate row and a reduction row) with R = 2^256 -- the same
// Montgomery radix as the JAX package, so the representations agree. The
// word arithmetic runs in the card's carry chains (PTX mad.lo.cc /
// madc.hi.cc / addc / subc). Against the 64-bit C form of the product
// (tools/kernel_variants.py `wide`) that bought no speed on the H100: nvcc
// compiles the C form into the same wide multiply-adds (K1's kernel is 704
// SASS instructions that way, 760 this way), K4's G1 scan and K6 time the
// same, K7 runs 7% faster this way and K4's G2 scan 16% slower
// (PERF.md), so K4's complete body takes the C form (`mul_wide`) for G2.
//
// At the kernel boundary an element is 16 limbs of 16 bits held in int32
// (the JAX layout the port keeps at every public function). `Field<F>::load`
// packs two limbs into one word; `Field<F>::store` unpacks. Limb k of an element sits at
// base[k * stride]: stride 1 for row-major (n, 16) records, stride = the
// element count for limb-major (16, n) planes.
//
// Every result is canonical (< p), so any correct formula gives the same
// value as the JAX package, bit for bit.

#pragma once
#include <cstdint>

namespace kzk {

struct FqMod {
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod q
    constexpr uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                               0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr uint32_t n0 = 0xe4866389u;  // -q^-1 mod 2^32
};

struct FrMod {
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod r
    constexpr uint32_t v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                               0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr uint32_t n0 = 0xefffffffu;  // -r^-1 mod 2^32
};

template <class M>
struct Fp {
  uint32_t v[8];
};

template <class M>
__device__ __forceinline__ Fp<M> fp_zero() {
  Fp<M> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

template <class M>
__device__ __forceinline__ Fp<M> fp_one() {  // Montgomery one
  Fp<M> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = M::one(i);
  return r;
}

// ---- carry chains (inline PTX) ----------------------------------------------
// Each chain is one asm statement: the carry flag does not survive between
// statements.

// d = a - b over eight words; returns the borrow out as a mask (0 or ~0)
__device__ __forceinline__ uint32_t sub8(uint32_t d[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t mask;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(mask)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b[0]),
        "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(0u));
  return mask;
}

// d = a + b over eight words; callers keep the sum below 2^256
__device__ __forceinline__ void add8(uint32_t d[8], const uint32_t a[8], const uint32_t b[8]) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b[0]),
        "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// t[0..7] += lo(a[j] * b) at word j, the carry out into t[8]
__device__ __forceinline__ void mad_lo_row(uint32_t t[9], const uint32_t a[8], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b));
}

// t[1..8] += hi(a[j] * b) at word j + 1; the caller's sum stays below
// 2^288, so nothing carries out of t[8]
__device__ __forceinline__ void mad_hi_row(uint32_t t[9], const uint32_t a[8], uint32_t b) {
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b));
}

template <class M>
__device__ __forceinline__ void modulus_words(uint32_t p[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) p[i] = M::p(i);
}

// s (< 2p, with `hi` the 2^256 bit) -> s mod p
template <class M>
__device__ __forceinline__ Fp<M> fp_csub(const uint32_t s[8], uint32_t hi) {
  uint32_t p[8];
  modulus_words<M>(p);
  Fp<M> d, r;
  const bool ge = sub8(d.v, s, p) == 0 || hi != 0;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = ge ? d.v[i] : s[i];
  return r;
}

// a + b < 2p < 2^255 (p < 2^254 for both BN254 moduli) fits eight words
template <class M>
__device__ __forceinline__ Fp<M> add(const Fp<M>& a, const Fp<M>& b) {
  uint32_t s[8];
  add8(s, a.v, b.v);
  return fp_csub<M>(s, 0);
}

// a - b, with p added back under the borrow mask (branch-free); the add-back
// wraps past 2^256 exactly when it is taken
template <class M>
__device__ __forceinline__ Fp<M> sub(const Fp<M>& a, const Fp<M>& b) {
  uint32_t d[8], pm[8];
  const uint32_t mask = sub8(d, a.v, b.v);
#pragma unroll
  for (int i = 0; i < 8; i++) pm[i] = M::p(i) & mask;
  Fp<M> r;
  add8(r.v, d, pm);
  return r;
}

template <class M>
__device__ __forceinline__ bool is_zero(const Fp<M>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

// (-a) mod p, mapping 0 to 0
template <class M>
__device__ __forceinline__ Fp<M> neg(const Fp<M>& a) {
  return sub(fp_zero<M>(), a);
}

template <class M>
__device__ __forceinline__ Fp<M> select(bool c, const Fp<M>& a, const Fp<M>& b) {
  Fp<M> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// Montgomery product a*b*2^-256 mod p, CIOS in 32-bit carry chains: per
// word b[i], two chains add a * b[i] (low words, then high words), two add
// m * p with m = t[0] * (-p^-1 mod 2^32), and the zero low word drops out.
// With a, b < p < 2^254 the running sum t stays < 2p, each round's sum
// stays < 2^288 (nine words), and one conditional subtract finishes.
template <class M>
__device__ __forceinline__ Fp<M> mul(const Fp<M>& a, const Fp<M>& b) {
  uint32_t p[8];
  modulus_words<M>(p);
  uint32_t t[9];
#pragma unroll
  for (int i = 0; i < 9; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mad_lo_row(t, a.v, b.v[i]);
    mad_hi_row(t, a.v, b.v[i]);
    const uint32_t m = t[0] * M::n0;
    mad_lo_row(t, p, m);
    mad_hi_row(t, p, m);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = t[j + 1];
    t[8] = 0;
  }
  return fp_csub<M>(t, 0);
}

template <class M>
__device__ __forceinline__ Fp<M> sqr(const Fp<M>& a) {
  return mul(a, a);
}

// The group law's product (ec.cuh, and the Fq2 product below): the same
// function behind a call, so that a kernel holds one copy of it. Inlined at
// each of a group op's 7-16 products (tools/kernel_variants.py `inline`),
// K6's G1 bucket walk grew from 5,024 to 44,608 SASS instructions and K4's
// G1 scan from 2,312 to 7,624, and on the H100 K6 took 2.3-2.8x as long
// (G1), K4 3-4% (G1) and 20% (G2) longer (PERF.md). K1 (mont_mul.cu) and
// K8 (redc.cu) make one product per thread and keep `mul` inline.
template <class M>
__device__ __noinline__ Fp<M> gmul(const Fp<M>& a, const Fp<M>& b) {
  return mul(a, b);
}

template <class M>
__device__ __forceinline__ Fp<M> gsqr(const Fp<M>& a) {
  return gmul(a, a);
}

// The same product in 64-bit C arithmetic (the port's first form,
// tools/kernel_variants.py `wide`): a 64-bit running sum per word of each
// CIOS row. K4's complete body takes it for G2 (msm_scan.cu `scan_mul`),
// where it runs faster than `mul` (PERF.md).
template <class M>
__device__ __forceinline__ Fp<M> mul_wide(const Fp<M>& a, const Fp<M>& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * M::n0;
    c = ((uint64_t)m * M::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * M::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return fp_csub<M>(t, t[8]);
}

// ---- row-major (n, 16) int32 records: 64 bytes, four 16-byte vectors ----------

template <class M>
__device__ __forceinline__ Fp<M> load_row(const int4* row) {
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int4 q = row[k];
    r.v[2 * k] = ((uint32_t)q.x & 0xffffu) | ((uint32_t)q.y << 16);
    r.v[2 * k + 1] = ((uint32_t)q.z & 0xffffu) | ((uint32_t)q.w << 16);
  }
  return r;
}

template <class M>
__device__ __forceinline__ void store_row(int4* row, const Fp<M>& a) {
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint32_t lo = a.v[2 * k], hi = a.v[2 * k + 1];
    row[k] = make_int4((int)(lo & 0xffffu), (int)(lo >> 16), (int)(hi & 0xffffu), (int)(hi >> 16));
  }
}

// ---- Fq2 = Fq[u]/(u^2 + 1) ---------------------------------------------------

struct Fq2 {
  Fp<FqMod> c0, c1;
};

__device__ __forceinline__ Fq2 add(const Fq2& a, const Fq2& b) { return {add(a.c0, b.c0), add(a.c1, b.c1)}; }
__device__ __forceinline__ Fq2 sub(const Fq2& a, const Fq2& b) { return {sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
__device__ __forceinline__ Fq2 neg(const Fq2& a) { return {neg(a.c0), neg(a.c1)}; }
__device__ __forceinline__ bool is_zero(const Fq2& a) { return is_zero(a.c0) && is_zero(a.c1); }
__device__ __forceinline__ Fq2 select(bool c, const Fq2& a, const Fq2& b) {
  return {select(c, a.c0, b.c0), select(c, a.c1, b.c1)};
}

// Karatsuba: 3 Fq products (KFq2.mul in pallas_ec.py). Not inlined, to keep
// the G2 kernels small enough to compile quickly.
static __device__ __noinline__ Fq2 mul(const Fq2& a, const Fq2& b) {
  Fp<FqMod> t0 = gmul(a.c0, b.c0);
  Fp<FqMod> t1 = gmul(a.c1, b.c1);
  Fp<FqMod> t2 = gmul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

// (a0^2 - a1^2, 2 a0 a1): 2 Fq products
static __device__ __noinline__ Fq2 sqr(const Fq2& a) {
  Fp<FqMod> re = gmul(add(a.c0, a.c1), sub(a.c0, a.c1));
  Fp<FqMod> t = gmul(a.c0, a.c1);
  return {re, add(t, t)};
}

__device__ __forceinline__ Fq2 gmul(const Fq2& a, const Fq2& b) { return mul(a, b); }
__device__ __forceinline__ Fq2 gsqr(const Fq2& a) { return sqr(a); }

// ---- field traits: zero/one and limb I/O for generic group-law code --------

template <class F>
struct Field;

template <class M>
struct Field<Fp<M>> {
  static constexpr int rows = 16;  // 16-bit limb rows one element occupies
  __device__ __forceinline__ static Fp<M> zero() { return fp_zero<M>(); }
  __device__ __forceinline__ static Fp<M> one() { return fp_one<M>(); }
  __device__ __forceinline__ static Fp<M> load(const int32_t* p, long long stride) {
    Fp<M> r;
#pragma unroll
    for (int i = 0; i < 8; i++)
      r.v[i] = ((uint32_t)p[(2 * i) * stride] & 0xffffu) | ((uint32_t)p[(2 * i + 1) * stride] << 16);
    return r;
  }
  __device__ __forceinline__ static void store(int32_t* p, long long stride, const Fp<M>& a) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
      p[(2 * i) * stride] = (int32_t)(a.v[i] & 0xffffu);
      p[(2 * i + 1) * stride] = (int32_t)(a.v[i] >> 16);
    }
  }
};

template <>
struct Field<Fq2> {
  static constexpr int rows = 32;  // c0 limbs, then c1 limbs
  using B = Field<Fp<FqMod>>;
  __device__ __forceinline__ static Fq2 zero() { return {B::zero(), B::zero()}; }
  __device__ __forceinline__ static Fq2 one() { return {B::one(), B::zero()}; }
  __device__ __forceinline__ static Fq2 load(const int32_t* p, long long stride) {
    return {B::load(p, stride), B::load(p + 16 * stride, stride)};
  }
  __device__ __forceinline__ static void store(int32_t* p, long long stride, const Fq2& a) {
    B::store(p, stride, a.c0);
    B::store(p + 16 * stride, stride, a.c1);
  }
};

}  // namespace kzk
