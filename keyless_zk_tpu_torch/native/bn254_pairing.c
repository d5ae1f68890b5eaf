/* BN254 (alt_bn128) optimal-ate pairing product check.
 *
 * Native replacement for the per-request Groth16 verification that the
 * reference performs through ark-groth16 (prover-service
 * request_handler/prover_handler.rs:329-336).  The pure-Python verifier in
 * groth16/pairing.py costs ~1.4 s per proof; this library does the same
 * check in single-digit milliseconds, keeping the defense-in-depth
 * re-verification inside a <1 s latency budget.
 *
 * Written from the standard published algorithm (optimal ate for BN curves:
 * Miller loop over 6u+2 with two Frobenius correction steps, then the
 * easy+hard final exponentiation via the Devegili-Scott addition chain).
 * Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - (9+u)),
 * Fq12 = Fq6[w]/(w^2 - v); an Fq12 element is stored as six Fq2
 * coefficients g[i] of w^i (w^6 = 9+u), which makes the Frobenius a
 * per-coefficient conjugate-and-scale.
 *
 * All field constants (p, Montgomery parameters, Frobenius coefficients)
 * come from a header generated at build time by groth16/pairing_native.py
 * — nothing here is hand-copied.
 *
 * The same library does a proof's host tail, its blinding with r and s
 * (five G1 and one G2 scalar multiplications, Jacobian, one inversion
 * each), in place of the pure-Python affine double-and-add
 * (groth16/prover.py `blind_plain`).
 *
 * Exported API (all coordinates standard-form 4x64-bit LE limbs):
 *   bn254_pairing_check(g1s, g2s, n)  ->  1 if prod e(Pi, Qi) == 1
 *   bn254_groth16_blind(out, g1s, g2s, ks): pi_a, pi_b, pi_c of a proof
 *   bn254_g1_mul / bn254_g2_mul: one scalar multiplication each
 *   bn254_fq_mul_test / bn254_miller_test: differential-test hooks.
 */

#include <stdint.h>
#include <string.h>

#include "bn254_pairing_consts.h"

typedef struct { uint64_t l[4]; } fq;
typedef struct { fq c0, c1; } fq2;
typedef struct { fq2 g[6]; } fq12; /* sum g[i] w^i, w^6 = xi */

/* ---------------- Fq (Montgomery) ---------------- */

static const fq FQ_P = { { BN_P0, BN_P1, BN_P2, BN_P3 } };
static const fq FQ_ONE = { { BN_R1_0, BN_R1_1, BN_R1_2, BN_R1_3 } }; /* mont(1) */
static const fq FQ_R2 = { { BN_R2_0, BN_R2_1, BN_R2_2, BN_R2_3 } };

static int fq_is_zero(const fq *a) {
    return (a->l[0] | a->l[1] | a->l[2] | a->l[3]) == 0;
}

static int fq_geq_p(const fq *a) {
    for (int i = 3; i >= 0; i--) {
        if (a->l[i] > FQ_P.l[i]) return 1;
        if (a->l[i] < FQ_P.l[i]) return 0;
    }
    return 1; /* equal */
}

static void fq_sub_p(fq *a) {
    unsigned __int128 b = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d = (unsigned __int128)a->l[i] - FQ_P.l[i] - (uint64_t)b;
        a->l[i] = (uint64_t)d;
        b = (d >> 64) & 1; /* borrow */
    }
}

static void fq_add(fq *r, const fq *a, const fq *b) {
    unsigned __int128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (unsigned __int128)a->l[i] + b->l[i];
        r->l[i] = (uint64_t)c;
        c >>= 64;
    }
    if (c || fq_geq_p(r)) fq_sub_p(r);
}

static void fq_sub(fq *r, const fq *a, const fq *b) {
    unsigned __int128 br = 0;
    fq t;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d = (unsigned __int128)a->l[i] - b->l[i] - (uint64_t)br;
        t.l[i] = (uint64_t)d;
        br = (d >> 64) & 1;
    }
    if (br) { /* add p back */
        unsigned __int128 c = 0;
        for (int i = 0; i < 4; i++) {
            c += (unsigned __int128)t.l[i] + FQ_P.l[i];
            t.l[i] = (uint64_t)c;
            c >>= 64;
        }
    }
    *r = t;
}

static void fq_neg(fq *r, const fq *a) {
    if (fq_is_zero(a)) { *r = *a; return; }
    fq t = FQ_P;
    fq_sub(r, &t, a);
    /* a < p so plain limb subtract is fine, fq_sub handles it */
}

/* CIOS Montgomery multiplication */
static void fq_mul(fq *r, const fq *a, const fq *b) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        unsigned __int128 c = 0;
        for (int j = 0; j < 4; j++) {
            c = (unsigned __int128)a->l[j] * b->l[i] + t[j] + (uint64_t)c;
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (uint64_t)c;
        t[5] = (uint64_t)(c >> 64);

        uint64_t m = t[0] * BN_N0;
        c = (unsigned __int128)m * FQ_P.l[0] + t[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (unsigned __int128)m * FQ_P.l[j] + t[j];
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (uint64_t)c;
        t[4] = t[5] + (uint64_t)(c >> 64);
    }
    memcpy(r->l, t, 32);
    if (t[4] || fq_geq_p(r)) fq_sub_p(r);
}

static void fq_sqr(fq *r, const fq *a) { fq_mul(r, a, a); }

static void fq_to_mont(fq *r, const fq *a) { fq_mul(r, a, &FQ_R2); }

static void fq_from_mont(fq *r, const fq *a) {
    fq one = { {1, 0, 0, 0} };
    fq_mul(r, a, &one);
}

/* Fermat inversion: a^(p-2) */
/* Binary extended GCD inversion (HAC 14.61) — ~10x cheaper than the
 * Fermat ladder. Proof verification handles public data only, so
 * variable time is fine (ark-groth16's verify is variable-time too). */
static inline int fq256_is_even(const fq *a) { return (a->l[0] & 1) == 0; }

static inline void fq256_shr1(fq *a) {
    a->l[0] = (a->l[0] >> 1) | (a->l[1] << 63);
    a->l[1] = (a->l[1] >> 1) | (a->l[2] << 63);
    a->l[2] = (a->l[2] >> 1) | (a->l[3] << 63);
    a->l[3] >>= 1;
}

static inline void fq256_half_mod(fq *a) {
    if (fq256_is_even(a)) {
        fq256_shr1(a);
    } else {
        unsigned __int128 carry = 0;
        for (int i = 0; i < 4; i++) {
            unsigned __int128 s = (unsigned __int128)a->l[i] + FQ_P.l[i] + (uint64_t)carry;
            a->l[i] = (uint64_t)s;
            carry = s >> 64;
        }
        fq256_shr1(a);
        a->l[3] |= (uint64_t)carry << 63;
    }
}

static inline int fq256_cmp(const fq *a, const fq *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->l[i] > b->l[i]) return 1;
        if (a->l[i] < b->l[i]) return -1;
    }
    return 0;
}

static inline void fq256_sub_raw(fq *out, const fq *a, const fq *b) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d = (unsigned __int128)a->l[i] - b->l[i] - (uint64_t)borrow;
        out->l[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

/* Montgomery-form inverse: aR -> a^-1 R.  The xGCD of aR yields
 * a^-1 R^-1; two REDC multiplies by R^2 restore the factor. */
static void fq_inv(fq *r, const fq *a) {
    static const fq ONE = { { 1, 0, 0, 0 } };
    if (fq_is_zero(a)) { *r = *a; return; } /* 0 -> 0, like the Fermat ladder */
    fq u = *a, v = FQ_P;
    fq x1 = ONE, x2 = { { 0, 0, 0, 0 } };
    while (fq256_cmp(&u, &ONE) != 0 && fq256_cmp(&v, &ONE) != 0) {
        while (fq256_is_even(&u)) { fq256_shr1(&u); fq256_half_mod(&x1); }
        while (fq256_is_even(&v)) { fq256_shr1(&v); fq256_half_mod(&x2); }
        if (fq256_cmp(&u, &v) >= 0) {
            fq256_sub_raw(&u, &u, &v);
            fq_sub(&x1, &x1, &x2);
        } else {
            fq256_sub_raw(&v, &v, &u);
            fq_sub(&x2, &x2, &x1);
        }
    }
    fq inv = (fq256_cmp(&u, &ONE) == 0) ? x1 : x2;
    fq_mul(&inv, &inv, &FQ_R2); /* a^-1 R^-1 * R^2 * R^-1 = a^-1 */
    fq_mul(r, &inv, &FQ_R2);    /* a^-1 * R^2 * R^-1 = a^-1 R */
}

/* ---------------- Fq2 = Fq[u]/(u^2+1) ---------------- */

static const fq2 FQ2_ONE = { { { BN_R1_0, BN_R1_1, BN_R1_2, BN_R1_3 } }, { {0, 0, 0, 0} } };

static int fq2_is_zero(const fq2 *a) { return fq_is_zero(&a->c0) && fq_is_zero(&a->c1); }

static void fq2_add(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_add(&r->c0, &a->c0, &b->c0);
    fq_add(&r->c1, &a->c1, &b->c1);
}

static void fq2_sub(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_sub(&r->c0, &a->c0, &b->c0);
    fq_sub(&r->c1, &a->c1, &b->c1);
}

static void fq2_neg(fq2 *r, const fq2 *a) {
    fq_neg(&r->c0, &a->c0);
    fq_neg(&r->c1, &a->c1);
}

static void fq2_conj(fq2 *r, const fq2 *a) {
    r->c0 = a->c0;
    fq_neg(&r->c1, &a->c1);
}

static void fq2_mul(fq2 *r, const fq2 *a, const fq2 *b) {
    fq t0, t1, t2, s0, s1;
    fq_mul(&t0, &a->c0, &b->c0);
    fq_mul(&t1, &a->c1, &b->c1);
    fq_add(&s0, &a->c0, &a->c1);
    fq_add(&s1, &b->c0, &b->c1);
    fq_mul(&t2, &s0, &s1);
    fq_sub(&r->c0, &t0, &t1);
    fq_sub(&t2, &t2, &t0);
    fq_sub(&r->c1, &t2, &t1);
}

static void fq2_sqr(fq2 *r, const fq2 *a) {
    fq s, d, t;
    fq_add(&s, &a->c0, &a->c1);
    fq_sub(&d, &a->c0, &a->c1);
    fq_mul(&t, &a->c0, &a->c1);
    fq_mul(&r->c0, &s, &d);
    fq_add(&r->c1, &t, &t);
}

static void fq2_mul_fq(fq2 *r, const fq2 *a, const fq *k) {
    fq_mul(&r->c0, &a->c0, k);
    fq_mul(&r->c1, &a->c1, k);
}

static void fq2_inv(fq2 *r, const fq2 *a) {
    fq n, t0, t1;
    fq_sqr(&t0, &a->c0);
    fq_sqr(&t1, &a->c1);
    fq_add(&n, &t0, &t1);
    fq_inv(&n, &n);
    fq_mul(&r->c0, &a->c0, &n);
    fq_mul(&t0, &a->c1, &n);
    fq_neg(&r->c1, &t0);
}

/* xi = 9 + u (alias-safe: r may equal a) */
static void fq2_mul_xi(fq2 *r, const fq2 *a) {
    fq t0, t1, nine_c0, nine_c1;
    const fq a0 = a->c0, a1 = a->c1;
    /* 9*c = 8c + c */
    fq_add(&t0, &a0, &a0); fq_add(&t0, &t0, &t0); fq_add(&t0, &t0, &t0);
    fq_add(&nine_c0, &t0, &a0);
    fq_add(&t1, &a1, &a1); fq_add(&t1, &t1, &t1); fq_add(&t1, &t1, &t1);
    fq_add(&nine_c1, &t1, &a1);
    fq_sub(&r->c0, &nine_c0, &a1);
    fq_add(&r->c1, &nine_c1, &a0);
}

/* ---------------- Fq12 as six Fq2 coefficients of w^i ---------------- */

static void fq12_one(fq12 *r) {
    memset(r, 0, sizeof(*r));
    r->g[0] = FQ2_ONE;
}

static int fq12_is_one(const fq12 *a) {
    fq2 d;
    fq2_sub(&d, &a->g[0], &FQ2_ONE);
    if (!fq2_is_zero(&d)) return 0;
    for (int i = 1; i < 6; i++)
        if (!fq2_is_zero(&a->g[i])) return 0;
    return 1;
}

/* schoolbook with reduction w^6 = xi: 36 fq2 muls — fine for the
 * per-request budget (a Karatsuba tower would save ~40%). */
static void fq12_mul(fq12 *r, const fq12 *a, const fq12 *b) {
    fq2 acc[11];
    memset(acc, 0, sizeof(acc));
    for (int i = 0; i < 6; i++) {
        if (fq2_is_zero(&a->g[i])) continue;
        for (int j = 0; j < 6; j++) {
            fq2 t;
            fq2_mul(&t, &a->g[i], &b->g[j]);
            fq2_add(&acc[i + j], &acc[i + j], &t);
        }
    }
    for (int k = 10; k >= 6; k--) {
        fq2 t;
        fq2_mul_xi(&t, &acc[k]);
        fq2_add(&acc[k - 6], &acc[k - 6], &t);
    }
    memcpy(r->g, acc, 6 * sizeof(fq2));
}

static void fq12_sqr(fq12 *r, const fq12 *a) { fq12_mul(r, a, a); }

/* f *= (a0 + a1 w + a3 w^3) with a0 in Fq — the Miller line shape.
 * 6 fq-by-fq2 + 12 fq2 muls vs the generic 36. */
static void fq12_mul_line(fq12 *f, const fq *a0, const fq2 *a1, const fq2 *a3) {
    fq2 acc[11];
    memset(acc, 0, sizeof(acc));
    for (int j = 0; j < 6; j++) {
        fq2 t;
        fq2_mul_fq(&t, &f->g[j], a0);
        fq2_add(&acc[j], &acc[j], &t);
        fq2_mul(&t, &f->g[j], a1);
        fq2_add(&acc[j + 1], &acc[j + 1], &t);
        fq2_mul(&t, &f->g[j], a3);
        fq2_add(&acc[j + 3], &acc[j + 3], &t);
    }
    for (int k = 8; k >= 6; k--) {
        fq2 t;
        fq2_mul_xi(&t, &acc[k]);
        fq2_add(&acc[k - 6], &acc[k - 6], &t);
    }
    memcpy(f->g, acc, 6 * sizeof(fq2));
}

static void fq12_conj(fq12 *r, const fq12 *a) {
    /* w -> -w (the p^6 Frobenius): negate odd coefficients */
    for (int i = 0; i < 6; i++) {
        if (i & 1) fq2_neg(&r->g[i], &a->g[i]);
        else r->g[i] = a->g[i];
    }
}

/* Frobenius constants from the generated header */
static const uint64_t FROB1[5][2][4] = BN_FROB1;
static const uint64_t FROB2[5][2][4] = BN_FROB2;
static const uint64_t FROB3[5][2][4] = BN_FROB3;

static void load_fq2(fq2 *r, const uint64_t c[2][4]) {
    memcpy(r->c0.l, c[0], 32);
    memcpy(r->c1.l, c[1], 32);
}

static void fq12_frob(fq12 *r, const fq12 *a, int power) {
    const uint64_t (*tab)[2][4] = power == 1 ? FROB1 : (power == 2 ? FROB2 : FROB3);
    int do_conj = (power & 1);
    r->g[0] = a->g[0];
    if (do_conj) fq_neg(&r->g[0].c1, &a->g[0].c1);
    for (int i = 1; i < 6; i++) {
        fq2 c, gi = a->g[i];
        if (do_conj) fq_neg(&gi.c1, &gi.c1);
        load_fq2(&c, tab[i - 1]);
        fq2_mul(&r->g[i], &gi, &c);
    }
}

static void fq12_inv(fq12 *r, const fq12 *a) {
    /* view as fq6 pair: a = A + B w with A = (g0, g2, g4), B = (g1, g3, g5)
     * over v = w^2.  inv = (A - Bw) / (A^2 - B^2 v).  We implement the fq6
     * arithmetic inline through fq12 ops on even coefficients. */
    /* Build A and B as fq12 elements with only even coefficients. */
    fq12 A, B, A2, B2, Bv, denom, num, dinv;
    memset(&A, 0, sizeof(A));
    memset(&B, 0, sizeof(B));
    for (int j = 0; j < 3; j++) {
        A.g[2 * j] = a->g[2 * j];
        B.g[2 * j] = a->g[2 * j + 1];
    }
    fq12_mul(&A2, &A, &A);
    fq12_mul(&B2, &B, &B);
    memset(&Bv, 0, sizeof(Bv));
    /* B^2 * v = B^2 * w^2: shift even coeffs up by one v-slot */
    {
        fq2 t;
        Bv.g[2] = B2.g[0];
        Bv.g[4] = B2.g[2];
        fq2_mul_xi(&t, &B2.g[4]);
        Bv.g[0] = t;
    }
    /* denom = A2 - Bv (even-only fq12 = an fq6) */
    for (int i = 0; i < 6; i++) fq2_sub(&denom.g[i], &A2.g[i], &Bv.g[i]);

    /* invert the fq6 denom = (d0, d1, d2) in v-coordinates */
    {
        fq2 d0 = denom.g[0], d1 = denom.g[2], d2 = denom.g[4];
        fq2 t0, t1, t2, c0, c1, c2, tmp, f, finv;
        /* c0 = d0^2 - xi d1 d2 ; c1 = xi d2^2 - d0 d1 ; c2 = d1^2 - d0 d2 */
        fq2_sqr(&t0, &d0);
        fq2_mul(&tmp, &d1, &d2); fq2_mul_xi(&t1, &tmp); fq2_sub(&c0, &t0, &t1);
        fq2_sqr(&t0, &d2); fq2_mul_xi(&t0, &t0);
        fq2_mul(&t1, &d0, &d1); fq2_sub(&c1, &t0, &t1);
        fq2_sqr(&t0, &d1); fq2_mul(&t1, &d0, &d2); fq2_sub(&c2, &t0, &t1);
        /* f = d0 c0 + xi (d1 c2 + d2 c1) */
        fq2_mul(&t0, &d0, &c0);
        fq2_mul(&t1, &d1, &c2);
        fq2_mul(&t2, &d2, &c1);
        fq2_add(&t1, &t1, &t2); fq2_mul_xi(&t1, &t1);
        fq2_add(&f, &t0, &t1);
        fq2_inv(&finv, &f);
        fq2_mul(&c0, &c0, &finv);
        fq2_mul(&c1, &c1, &finv);
        fq2_mul(&c2, &c2, &finv);
        memset(&dinv, 0, sizeof(dinv));
        dinv.g[0] = c0; dinv.g[2] = c1; dinv.g[4] = c2;
    }
    /* num = A - B w : odd coefficients negated-shifted */
    memset(&num, 0, sizeof(num));
    for (int j = 0; j < 3; j++) {
        num.g[2 * j] = A.g[2 * j];
        fq2_neg(&num.g[2 * j + 1], &B.g[2 * j]);
    }
    fq12_mul(r, &num, &dinv);
}

/* (a + b t)² in Fq4 = Fq2[t]/(t² - ξ): returns (a² + ξ b², 2ab) */
static void fp4_sqr(fq2 *r0, fq2 *r1, const fq2 *a, const fq2 *b) {
    fq2 t0, t1, s;
    fq2_sqr(&t0, a);
    fq2_sqr(&t1, b);
    fq2_add(&s, a, b);
    fq2_mul_xi(r0, &t1);
    fq2_add(r0, r0, &t0);
    fq2_sqr(&s, &s);
    fq2_sub(&s, &s, &t0);
    fq2_sub(r1, &s, &t1);
}

/* Granger-Scott squaring, valid for elements of the cyclotomic subgroup
 * (everything after the easy final-exp part). ~9 fq2 muls vs 36. */
static void fq12_cyc_sqr(fq12 *r, const fq12 *f) {
    /* Fq12 = Fq4[v]: z-naming per the standard algorithm with
     * (z0,z4,z3,z2,z1,z5) = (g0,g2,g4,g1,g3,g5) */
    fq2 z0 = f->g[0], z4 = f->g[2], z3 = f->g[4];
    fq2 z2 = f->g[1], z1 = f->g[3], z5 = f->g[5];
    fq2 t0, t1, t2, t3, u;

    fp4_sqr(&t0, &t1, &z0, &z1);
    fq2_sub(&z0, &t0, &z0); fq2_add(&z0, &z0, &z0); fq2_add(&z0, &z0, &t0);
    fq2_add(&z1, &t1, &z1); fq2_add(&z1, &z1, &z1); fq2_add(&z1, &z1, &t1);
    fp4_sqr(&t0, &t1, &z2, &z3);
    fp4_sqr(&t2, &t3, &z4, &z5);
    fq2_sub(&z4, &t0, &z4); fq2_add(&z4, &z4, &z4); fq2_add(&z4, &z4, &t0);
    fq2_add(&z5, &t1, &z5); fq2_add(&z5, &z5, &z5); fq2_add(&z5, &z5, &t1);
    fq2_mul_xi(&u, &t3);
    fq2_add(&z2, &u, &z2); fq2_add(&z2, &z2, &z2); fq2_add(&z2, &z2, &u);
    fq2_sub(&z3, &t2, &z3); fq2_add(&z3, &z3, &z3); fq2_add(&z3, &z3, &t2);

    r->g[0] = z0; r->g[2] = z4; r->g[4] = z3;
    r->g[1] = z2; r->g[3] = z1; r->g[5] = z5;
}

static void fq12_pow_u(fq12 *r, const fq12 *a) {
    /* exponent u = BN_U (63 bits, positive for this curve); only called on
     * cyclotomic-subgroup elements (final exp), so squarings use the
     * Granger-Scott compressed form */
    uint64_t u = BN_U;
    fq12 acc, base = *a;
    fq12_one(&acc);
    while (u) {
        if (u & 1) fq12_mul(&acc, &acc, &base);
        u >>= 1;
        if (u) fq12_cyc_sqr(&base, &base);
    }
    *r = acc;
}

/* ---------------- curve points ---------------- */

typedef struct { fq x, y; int inf; } g1_t;
typedef struct { fq2 x, y; int inf; } g2_t;

#define MAX_PAIRS 16

/* Montgomery batch inversion: d[i] <- d[i]^-1, one fq2_inv total.
 * All d[i] must be nonzero (holds for valid pairing inputs). */
static void fq2_batch_inv(fq2 *d, int n) {
    fq2 pref[MAX_PAIRS], acc, tmp;
    pref[0] = d[0];
    for (int i = 1; i < n; i++) fq2_mul(&pref[i], &pref[i - 1], &d[i]);
    fq2_inv(&acc, &pref[n - 1]);
    for (int i = n - 1; i > 0; i--) {
        fq2_mul(&tmp, &acc, &pref[i - 1]); /* d_i^-1 */
        fq2_mul(&acc, &acc, &d[i]);
        d[i] = tmp;
    }
    d[0] = acc;
}

/* One shared Miller step for all pairs (multi-pairing: the pairs share the
 * loop schedule, so the product Π f_i advances with ONE f squaring per bit
 * and one sparse line multiplication per pair, with the n slope
 * denominators inverted in one batch). dbl: tangent at T[i]; else chord
 * T[i] -> R[i]. */
static void step_multi(fq12 *f, g2_t *T, const g2_t *R, const g1_t *P, int n, int dbl) {
    fq2 num[MAX_PAIRS], den[MAX_PAIRS];
    for (int i = 0; i < n; i++) {
        if (dbl) {
            fq2 t;
            fq2_sqr(&num[i], &T[i].x);
            fq2_add(&t, &num[i], &num[i]);
            fq2_add(&num[i], &t, &num[i]);
            fq2_add(&den[i], &T[i].y, &T[i].y);
        } else {
            fq2_sub(&num[i], &R[i].y, &T[i].y);
            fq2_sub(&den[i], &R[i].x, &T[i].x);
        }
    }
    fq2_batch_inv(den, n);
    for (int i = 0; i < n; i++) {
        fq2 lambda, a1, a3, t;
        fq2_mul(&lambda, &num[i], &den[i]);
        /* line l(P) = yp - λ xp w + (λ xT - yT) w³ (P coords mont) */
        fq2_mul_fq(&t, &lambda, &P[i].x);
        fq2_neg(&a1, &t);
        fq2_mul(&t, &lambda, &T[i].x);
        fq2_sub(&a3, &t, &T[i].y);
        fq12_mul_line(f, &P[i].y, &a1, &a3);
        /* point: x3 = λ² - xT - xR ; y3 = λ(xT - x3) - yT */
        {
            fq2 l2, x3, y3, d;
            fq2_sqr(&l2, &lambda);
            fq2_sub(&x3, &l2, &T[i].x);
            fq2_sub(&x3, &x3, dbl ? &T[i].x : &R[i].x);
            fq2_sub(&d, &T[i].x, &x3);
            fq2_mul(&y3, &lambda, &d);
            fq2_sub(&y3, &y3, &T[i].y);
            T[i].x = x3;
            T[i].y = y3;
        }
    }
}

/* shared-f optimal-ate Miller loop over n <= MAX_PAIRS pairs;
 * multiplies the result into *f (callers pass f = 1 or accumulate). */
static void miller_multi(fq12 *f, const g1_t *P, const g2_t *Qin, int n) {
    g2_t T[MAX_PAIRS], Q1[MAX_PAIRS], Q2[MAX_PAIRS];
    for (int i = 0; i < n; i++) T[i] = Qin[i];
    unsigned __int128 s = ((unsigned __int128)BN_S_HI << 64) | BN_S_LO;
    for (int i = BN_S_BITS - 2; i >= 0; i--) {
        fq12_mul(f, f, f);
        step_multi(f, T, T, P, n, 1);
        if ((s >> i) & 1) step_multi(f, T, Qin, P, n, 0);
    }
    /* Frobenius corrections: Q1 = π(Q), Q2 = π²(Q);
     * f *= l(T,Q1); T += Q1; f *= l(T,-Q2) */
    {
        fq2 c1x, c1y, c2x, c2y;
        load_fq2(&c1x, FROB1[1]); /* γ1,2 = ξ^{(p-1)/3} */
        load_fq2(&c1y, FROB1[2]); /* γ1,3 = ξ^{(p-1)/2} */
        load_fq2(&c2x, FROB2[1]);
        load_fq2(&c2y, FROB2[2]);
        for (int i = 0; i < n; i++) {
            fq2 qx, qy;
            fq2_conj(&qx, &Qin[i].x);
            fq2_conj(&qy, &Qin[i].y);
            fq2_mul(&Q1[i].x, &qx, &c1x);
            fq2_mul(&Q1[i].y, &qy, &c1y);
            Q1[i].inf = 0;
            fq2_mul(&Q2[i].x, &Qin[i].x, &c2x);
            fq2_mul(&Q2[i].y, &Qin[i].y, &c2y);
            fq2_neg(&Q2[i].y, &Q2[i].y); /* -Q2 */
            Q2[i].inf = 0;
        }
    }
    step_multi(f, T, Q1, P, n, 0);
    step_multi(f, T, Q2, P, n, 0);
}

static void miller(fq12 *f, const g1_t *P, const g2_t *Qin) {
    fq12_one(f);
    miller_multi(f, P, Qin, 1);
}

static void final_exp(fq12 *r, const fq12 *f_in) {
    fq12 f = *f_in, t, finv, m;
    /* easy: m = (conj(f)/f)^(p²) * (conj(f)/f) */
    fq12_conj(&t, &f);
    fq12_inv(&finv, &f);
    fq12_mul(&m, &t, &finv);
    fq12_frob(&t, &m, 2);
    fq12_mul(&m, &t, &m);

    /* hard part: Devegili–Scott addition chain for BN curves */
    fq12 fu, fu2, fu3, fp, fp2, fp3, fu2p, fu3p, y0, y1, y2, y3, y4, y5, y6, T0, T1;
    fq12_pow_u(&fu, &m);
    fq12_pow_u(&fu2, &fu);
    fq12_pow_u(&fu3, &fu2);
    fq12_frob(&fp, &m, 1);
    fq12_frob(&fp2, &m, 2);
    fq12_frob(&fp3, &m, 3);
    fq12_frob(&y3, &fu, 1);
    fq12_frob(&fu2p, &fu2, 1);
    fq12_frob(&fu3p, &fu3, 1);
    fq12_frob(&y2, &fu2, 2);

    fq12_mul(&y0, &fp, &fp2);
    fq12_mul(&y0, &y0, &fp3);
    fq12_conj(&y1, &m);
    fq12_conj(&y5, &fu2);
    fq12_conj(&y3, &y3);
    fq12_mul(&y4, &fu, &fu2p);
    fq12_conj(&y4, &y4);
    fq12_mul(&y6, &fu3, &fu3p);
    fq12_conj(&y6, &y6);

    fq12_cyc_sqr(&T0, &y6);
    fq12_mul(&T0, &T0, &y4);
    fq12_mul(&T0, &T0, &y5);
    fq12_mul(&T1, &y3, &y5);
    fq12_mul(&T1, &T1, &T0);
    fq12_mul(&T0, &T0, &y2);
    fq12_cyc_sqr(&T1, &T1);
    fq12_mul(&T1, &T1, &T0);
    fq12_cyc_sqr(&T1, &T1);
    fq12_mul(&T0, &T1, &y1);
    fq12_mul(&T1, &T1, &y0);
    fq12_cyc_sqr(&T0, &T0);
    fq12_mul(r, &T0, &T1);
}

/* ---------------- G1 / G2 group law (the Groth16 blinding) ----------------
 *
 * Jacobian (X : Y : Z) ~ (X/Z^2, Y/Z^3) on y^2 = x^3 + b, with Z = 0 the
 * point at infinity; one template for G1 over Fq and G2 over Fq2 (type and
 * function prefix F, affine type A, Montgomery one ONE).  The mixed add is
 * complete: P at infinity, Q at infinity, P == Q (it doubles) and P == -Q
 * (infinity).  A scalar multiplication is MSB-first double-and-add over the
 * 256-bit scalar with one inversion back to affine at the end; k = 0 gives
 * infinity.  The scalars are secret blinding factors, and this code is
 * variable-time, as the host tail it replaces was. */

#define DEFINE_GROUP(G, F, A, ONE)                                                \
typedef struct { F X, Y, Z; } G##_jac;                                            \
                                                                                  \
static void G##_set_inf(G##_jac *r) { r->X = ONE; r->Y = ONE; memset(&r->Z, 0, sizeof(F)); } \
                                                                                  \
/* dbl-2009-l (a = 0); alias-safe; Z = 0 stays 0 */                               \
static void G##_dbl(G##_jac *r, const G##_jac *p) {                               \
    F a, b, c, d, e, f, t, z3;                                                    \
    F##_sqr(&a, &p->X);                                                           \
    F##_sqr(&b, &p->Y);                                                           \
    F##_sqr(&c, &b);                                                              \
    F##_add(&t, &p->X, &b);                                                       \
    F##_sqr(&t, &t);                                                              \
    F##_sub(&t, &t, &a);                                                          \
    F##_sub(&t, &t, &c);                                                          \
    F##_add(&d, &t, &t);                  /* D = 2((X + B)^2 - A - C) */          \
    F##_add(&e, &a, &a);                                                          \
    F##_add(&e, &e, &a);                  /* E = 3A */                            \
    F##_sqr(&f, &e);                                                              \
    F##_mul(&t, &p->Y, &p->Z);                                                    \
    F##_add(&z3, &t, &t);                 /* Z3 = 2 Y Z */                        \
    F##_sub(&r->X, &f, &d);                                                       \
    F##_sub(&r->X, &r->X, &d);            /* X3 = F - 2D */                       \
    F##_sub(&t, &d, &r->X);                                                       \
    F##_mul(&t, &e, &t);                                                          \
    F##_add(&c, &c, &c);                                                          \
    F##_add(&c, &c, &c);                                                          \
    F##_add(&c, &c, &c);                                                          \
    F##_sub(&r->Y, &t, &c);               /* Y3 = E (D - X3) - 8C */              \
    r->Z = z3;                                                                    \
}                                                                                 \
                                                                                  \
/* madd-2007-bl: r = p + q, q affine; alias-safe in r and p */                    \
static void G##_madd(G##_jac *r, const G##_jac *p, const A *q) {                  \
    F z1z1, u2, s2, h, hh, i, j, rr, v, t;                                        \
    if (q->inf) { *r = *p; return; }                                              \
    if (F##_is_zero(&p->Z)) { r->X = q->x; r->Y = q->y; r->Z = ONE; return; }    \
    F##_sqr(&z1z1, &p->Z);                                                        \
    F##_mul(&u2, &q->x, &z1z1);                                                   \
    F##_mul(&s2, &q->y, &p->Z);                                                   \
    F##_mul(&s2, &s2, &z1z1);                                                     \
    F##_sub(&h, &u2, &p->X);                                                      \
    F##_sub(&rr, &s2, &p->Y);                                                     \
    if (F##_is_zero(&h)) {                /* same x: P == Q or P == -Q */          \
        if (F##_is_zero(&rr)) G##_dbl(r, p);                                      \
        else G##_set_inf(r);                                                      \
        return;                                                                   \
    }                                                                             \
    F##_add(&rr, &rr, &rr);               /* r = 2 (S2 - Y1) */                   \
    F##_sqr(&hh, &h);                                                             \
    F##_add(&i, &hh, &hh);                                                        \
    F##_add(&i, &i, &i);                  /* I = 4 HH */                          \
    F##_mul(&j, &h, &i);                                                          \
    F##_mul(&v, &p->X, &i);                                                       \
    F##_add(&t, &p->Z, &h);                                                       \
    F##_sqr(&t, &t);                                                              \
    F##_sub(&t, &t, &z1z1);                                                       \
    F##_sub(&r->Z, &t, &hh);              /* Z3 = (Z1 + H)^2 - Z1Z1 - HH */       \
    F##_mul(&t, &p->Y, &j);                                                       \
    F##_add(&t, &t, &t);                  /* 2 Y1 J, before Y1 is overwritten */  \
    F##_sqr(&r->X, &rr);                                                          \
    F##_sub(&r->X, &r->X, &j);                                                    \
    F##_sub(&r->X, &r->X, &v);                                                    \
    F##_sub(&r->X, &r->X, &v);            /* X3 = r^2 - J - 2V */                 \
    F##_sub(&v, &v, &r->X);                                                       \
    F##_mul(&v, &rr, &v);                                                         \
    F##_sub(&r->Y, &v, &t);               /* Y3 = r (V - X3) - 2 Y1 J */          \
}                                                                                 \
                                                                                  \
static void G##_to_affine(A *r, const G##_jac *p) {                               \
    F zi, zi2;                                                                    \
    if (F##_is_zero(&p->Z)) { memset(r, 0, sizeof(*r)); r->inf = 1; return; }     \
    F##_inv(&zi, &p->Z);                                                          \
    F##_sqr(&zi2, &zi);                                                           \
    F##_mul(&r->x, &p->X, &zi2);                                                  \
    F##_mul(&zi2, &zi2, &zi);                                                     \
    F##_mul(&r->y, &p->Y, &zi2);                                                  \
    r->inf = 0;                                                                   \
}                                                                                 \
                                                                                  \
/* r = k p, k as 4 little-endian 64-bit limbs */                                  \
static void G##_mul(A *r, const A *p, const uint64_t k[4]) {                      \
    G##_jac acc;                                                                  \
    G##_set_inf(&acc);                                                            \
    for (int bit = 255; bit >= 0; bit--) {                                        \
        G##_dbl(&acc, &acc);                                                      \
        if ((k[bit >> 6] >> (bit & 63)) & 1) G##_madd(&acc, &acc, p);             \
    }                                                                             \
    G##_to_affine(r, &acc);                                                       \
}                                                                                 \
                                                                                  \
/* r = pts[0] + ... + pts[n - 1] */                                               \
static void G##_sum(A *r, const A *pts, int n) {                                  \
    G##_jac acc;                                                                  \
    G##_set_inf(&acc);                                                            \
    for (int i = 0; i < n; i++) G##_madd(&acc, &acc, &pts[i]);                    \
    G##_to_affine(r, &acc);                                                       \
}

DEFINE_GROUP(g1, fq, g1_t, FQ_ONE)
DEFINE_GROUP(g2, fq2, g2_t, FQ2_ONE)

/* ---------------- public API ---------------- */

static void load_fq_std(fq *r, const uint64_t *limbs) {
    fq t;
    memcpy(t.l, limbs, 32);
    fq_to_mont(r, &t);
}

static void store_fq_std(uint64_t *limbs, const fq *a) {
    fq t;
    fq_from_mont(&t, a);
    memcpy(limbs, t.l, 32);
}

static int all_zero(const uint64_t *w, int n) {
    uint64_t acc = 0;
    for (int i = 0; i < n; i++) acc |= w[i];
    return acc == 0;
}

/* Affine points in standard form, G1 as (x, y) = 8 words and G2 as
 * (x.c0, x.c1, y.c0, y.c1) = 16 words; all zero is the point at infinity
 * (no curve point has x = y = 0). */
static void g1_load(g1_t *p, const uint64_t *in) {
    memset(p, 0, sizeof(*p));
    p->inf = all_zero(in, 8);
    if (p->inf) return;
    load_fq_std(&p->x, in);
    load_fq_std(&p->y, in + 4);
}

static void g2_load(g2_t *p, const uint64_t *in) {
    memset(p, 0, sizeof(*p));
    p->inf = all_zero(in, 16);
    if (p->inf) return;
    load_fq_std(&p->x.c0, in);
    load_fq_std(&p->x.c1, in + 4);
    load_fq_std(&p->y.c0, in + 8);
    load_fq_std(&p->y.c1, in + 12);
}

static void g1_store(uint64_t *out, const g1_t *p) {
    memset(out, 0, 8 * sizeof(uint64_t));
    if (p->inf) return;
    store_fq_std(out, &p->x);
    store_fq_std(out + 4, &p->y);
}

static void g2_store(uint64_t *out, const g2_t *p) {
    memset(out, 0, 16 * sizeof(uint64_t));
    if (p->inf) return;
    store_fq_std(out, &p->x.c0);
    store_fq_std(out + 4, &p->x.c1);
    store_fq_std(out + 8, &p->y.c0);
    store_fq_std(out + 12, &p->y.c1);
}

void bn254_g1_mul(uint64_t *out8, const uint64_t *p8, const uint64_t *k4) {
    g1_t p, r;
    g1_load(&p, p8);
    g1_mul(&r, &p, k4);
    g1_store(out8, &r);
}

void bn254_g2_mul(uint64_t *out16, const uint64_t *p16, const uint64_t *k4) {
    g2_t p, r;
    g2_load(&p, p16);
    g2_mul(&r, &p, k4);
    g2_store(out16, &r);
}

/* One proof's blinding (groth16.cpp:288-353), scalars below the group order:
 *   pi_a = A + alpha1 + r delta1
 *   pi_b = B2 + beta2 + s delta2
 *   B1'  = B1 + beta1 + s delta1
 *   pi_c = C + H + s pi_a + r B1' - (r s) delta1
 * g1s: A, B1, C, H, alpha1, beta1, delta1 (8 words each); g2s: B2, beta2,
 * delta2 (16 words each); ks: r, s and r s reduced mod the group order
 * (4 words each);
 * out: pi_a (8 words), pi_b (16), pi_c (8). */
void bn254_groth16_blind(uint64_t *out32, const uint64_t *g1s, const uint64_t *g2s, const uint64_t *ks) {
    enum { A_, B1_, C_, H_, ALPHA1, BETA1, DELTA1 };
    const uint64_t *r = ks, *s = ks + 4, *rs = ks + 8;
    g1_t p[7], t[5], pi_a, pi_c;
    g2_t q[3], pi_b;
    for (int i = 0; i < 7; i++) g1_load(&p[i], g1s + 8 * i);
    for (int i = 0; i < 3; i++) g2_load(&q[i], g2s + 16 * i);

    t[0] = p[A_];
    t[1] = p[ALPHA1];
    g1_mul(&t[2], &p[DELTA1], r);
    g1_sum(&pi_a, t, 3);

    g2_mul(&q[2], &q[2], s);
    g2_sum(&pi_b, q, 3);

    t[0] = p[B1_];
    t[1] = p[BETA1];
    g1_mul(&t[2], &p[DELTA1], s);
    g1_sum(&t[4], t, 3); /* B1' */

    t[0] = p[C_];
    t[1] = p[H_];
    g1_mul(&t[2], &pi_a, s);
    g1_mul(&t[3], &t[4], r);
    g1_mul(&t[4], &p[DELTA1], rs);
    fq_neg(&t[4].y, &t[4].y);
    g1_sum(&pi_c, t, 5);

    g1_store(out32, &pi_a);
    g2_store(out32 + 8, &pi_b);
    g1_store(out32 + 24, &pi_c);
}

/* g1s: n * 8 u64 (x, y); g2s: n * 16 u64 (x.c0, x.c1, y.c0, y.c1);
 * an all-zero point means "skip this pair" (point at infinity). */
int bn254_pairing_check(const uint64_t *g1s, const uint64_t *g2s, int n) {
    fq12 acc;
    g1_t P[MAX_PAIRS];
    g2_t Q[MAX_PAIRS];
    int m = 0;
    fq12_one(&acc);
    for (int k = 0; k < n; k++) {
        const uint64_t *p1 = g1s + 8 * k;
        const uint64_t *p2 = g2s + 16 * k;
        int z1 = 1, z2 = 1;
        for (int i = 0; i < 8; i++) z1 &= (p1[i] == 0);
        for (int i = 0; i < 16; i++) z2 &= (p2[i] == 0);
        if (z1 || z2) continue;
        load_fq_std(&P[m].x, p1);
        load_fq_std(&P[m].y, p1 + 4);
        P[m].inf = 0;
        load_fq_std(&Q[m].x.c0, p2);
        load_fq_std(&Q[m].x.c1, p2 + 4);
        load_fq_std(&Q[m].y.c0, p2 + 8);
        load_fq_std(&Q[m].y.c1, p2 + 12);
        Q[m].inf = 0;
        if (++m == MAX_PAIRS || k == n - 1) {
            miller_multi(&acc, P, Q, m); /* multiplies into acc */
            m = 0;
        }
    }
    if (m) miller_multi(&acc, P, Q, m);
    final_exp(&acc, &acc);
    return fq12_is_one(&acc);
}

/* differential-test hooks */
static void load_fq12_std(fq12 *r, const uint64_t *in96) {
    for (int i = 0; i < 6; i++) {
        load_fq_std(&r->g[i].c0, in96 + 8 * i);
        load_fq_std(&r->g[i].c1, in96 + 8 * i + 4);
    }
}

static void store_fq12_std(uint64_t *out96, const fq12 *a) {
    for (int i = 0; i < 6; i++) {
        fq x, y;
        fq_from_mont(&x, &a->g[i].c0);
        fq_from_mont(&y, &a->g[i].c1);
        memcpy(out96 + 8 * i, x.l, 32);
        memcpy(out96 + 8 * i + 4, y.l, 32);
    }
}

/* op: 0 mul, 1 inv(a), 2..4 frob a by 1..3, 5 conj, 6 a^u, 7 sqr */
void bn254_fq12_op_test(uint64_t *out96, const uint64_t *a96, const uint64_t *b96, int op) {
    fq12 a, b, r;
    load_fq12_std(&a, a96);
    load_fq12_std(&b, b96);
    switch (op) {
    case 0: fq12_mul(&r, &a, &b); break;
    case 1: fq12_inv(&r, &a); break;
    case 2: fq12_frob(&r, &a, 1); break;
    case 3: fq12_frob(&r, &a, 2); break;
    case 4: fq12_frob(&r, &a, 3); break;
    case 5: fq12_conj(&r, &a); break;
    case 6: fq12_pow_u(&r, &a); break;
    default: fq12_sqr(&r, &a); break;
    }
    store_fq12_std(out96, &r);
}

void bn254_miller_raw(uint64_t *out96, const uint64_t *g1, const uint64_t *g2) {
    g1_t P;
    g2_t Q;
    fq12 f;
    load_fq_std(&P.x, g1);
    load_fq_std(&P.y, g1 + 4);
    load_fq_std(&Q.x.c0, g2);
    load_fq_std(&Q.x.c1, g2 + 4);
    load_fq_std(&Q.y.c0, g2 + 8);
    load_fq_std(&Q.y.c1, g2 + 12);
    miller(&f, &P, &Q);
    store_fq12_std(out96, &f);
}

void bn254_fq_mul_test(uint64_t *r, const uint64_t *a, const uint64_t *b) {
    fq fa, fb, fr, m;
    memcpy(fa.l, a, 32);
    memcpy(fb.l, b, 32);
    fq_to_mont(&fa, &fa);
    fq_to_mont(&fb, &fb);
    fq_mul(&fr, &fa, &fb);
    fq_from_mont(&m, &fr);
    memcpy(r, m.l, 32);
}

void bn254_miller_test(uint64_t *out96, const uint64_t *g1, const uint64_t *g2) {
    /* single full pairing e(P, Q), coefficients w^0..w^5 (fq2 each), standard form */
    g1_t P;
    g2_t Q;
    fq12 f, e;
    load_fq_std(&P.x, g1);
    load_fq_std(&P.y, g1 + 4);
    load_fq_std(&Q.x.c0, g2);
    load_fq_std(&Q.x.c1, g2 + 4);
    load_fq_std(&Q.y.c0, g2 + 8);
    load_fq_std(&Q.y.c1, g2 + 12);
    miller(&f, &P, &Q);
    final_exp(&e, &f);
    for (int i = 0; i < 6; i++) {
        fq a, b;
        fq_from_mont(&a, &e.g[i].c0);
        fq_from_mont(&b, &e.g[i].c1);
        memcpy(out96 + 8 * i, a.l, 32);
        memcpy(out96 + 8 * i + 4, b.l, 32);
    }
}
