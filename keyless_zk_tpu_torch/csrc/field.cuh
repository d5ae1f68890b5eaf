// BN254 prime-field arithmetic for Hopper (sm_90a), device side.
//
// Replaces the in-kernel limb arithmetic of the Pallas kernels
// (keyless_zk_tpu/ops/pallas_field.py `_make_kernel`, and `KFq` / `KFq2` in
// keyless_zk_tpu/ops/pallas_ec.py). The TPU VPU has no wide multiply, so
// the JAX package works on 16 limbs of 16 bits; a CUDA core multiplies
// 32 x 32 -> 64 bits, so here an element is 8 little-endian 32-bit words in
// registers, and a Montgomery product is one CIOS pass (8 outer rounds of a
// multiply-accumulate row and a reduction row) with R = 2^256 -- the same
// Montgomery radix as the JAX package, so the representations agree.
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

// s (< 2p, with `hi` the 2^256 bit) -> s mod p
template <class M>
__device__ __forceinline__ Fp<M> fp_csub(const uint32_t s[8], uint32_t hi) {
  Fp<M> d, r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)s[i] - M::p(i) - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  bool ge = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = ge ? d.v[i] : s[i];
  return r;
}

template <class M>
__device__ __forceinline__ Fp<M> add(const Fp<M>& a, const Fp<M>& b) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  return fp_csub<M>(s, (uint32_t)c);
}

template <class M>
__device__ __forceinline__ Fp<M> sub(const Fp<M>& a, const Fp<M>& b) {
  Fp<M> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (borrow) {  // a < b: add p back (drops the 2^256 wrap)
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)d.v[i] + M::p(i);
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
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

// Montgomery product a*b*2^-256 mod p, CIOS. t stays < 2p < 2^255, so the
// ninth word of the running sum never exceeds 1 and one conditional
// subtract finishes.
template <class M>
__device__ __forceinline__ Fp<M> mul(const Fp<M>& a, const Fp<M>& b) {
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

template <class M>
__device__ __forceinline__ Fp<M> sqr(const Fp<M>& a) {
  return mul(a, a);
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
  Fp<FqMod> t0 = mul(a.c0, b.c0);
  Fp<FqMod> t1 = mul(a.c1, b.c1);
  Fp<FqMod> t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

// (a0^2 - a1^2, 2 a0 a1): 2 Fq products
static __device__ __noinline__ Fq2 sqr(const Fq2& a) {
  Fp<FqMod> re = mul(add(a.c0, a.c1), sub(a.c0, a.c1));
  Fp<FqMod> t = mul(a.c0, a.c1);
  return {re, add(t, t)};
}

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
