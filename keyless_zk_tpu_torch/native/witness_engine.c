/* Native witness-evaluation engine for the BN254 scalar field.
 *
 * Plays the role of the reference's circom-generated C witness generator
 * (`main_c`, invoked per request at prover_handler.rs:541-572), but as a
 * bytecode interpreter over the ConstraintSystem's structured witness ops
 * instead of generated source: one compiled library serves every circuit.
 *
 * Field values are 4x64-bit Montgomery residues mod the BN254 scalar
 * prime r (R = 2^256).  Multiplication is 4-limb CIOS via __int128.
 * Rare big-integer hints (RSA long division) call back into Python.
 *
 * Build: gcc -O3 -march=native -shared -fPIC -o libwitness_engine.so witness_engine.c
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* BN254 scalar field r, little-endian limbs. */
static const u64 P[4] = {
    0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
    0xb85045b68181585dULL, 0x30644e72e131a029ULL,
};
/* -p^-1 mod 2^64 */
static const u64 N0 = 0xc2e1f593efffffffULL;
/* R^2 mod p (for to_mont) */
static const u64 R2[4] = {
    0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
    0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL,
};
/* R mod p (Montgomery one) */
static const u64 RMODP[4] = {
    0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
    0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL,
};
/* p - R mod p (Montgomery minus-one) */
static const u64 NEGR[4] = {
    0x974bc177a0000006ULL, 0xf13771b2da58a367ULL,
    0x51e1a2470908122eULL, 0x2259d6b14729c0faULL,
};

typedef struct { u64 v[4]; } fe;

static inline int fe_is_zero(const fe *a) {
    return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

static inline int fe_geq_p(const fe *a) {
    for (int i = 3; i >= 0; i--) {
        if (a->v[i] > P[i]) return 1;
        if (a->v[i] < P[i]) return 0;
    }
    return 1; /* equal */
}

static inline void fe_sub_p(fe *a) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - P[i] - (u64)borrow;
        a->v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fe_add(fe *out, const fe *a, const fe *b) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->v[i] + b->v[i] + (u64)carry;
        out->v[i] = (u64)s;
        carry = s >> 64;
    }
    /* a, b < p < 2^254 so no carry out of 256 bits */
    if (fe_geq_p(out)) fe_sub_p(out);
}

static inline void fe_sub(fe *out, const fe *a, const fe *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - (u64)borrow;
        out->v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) { /* add p back */
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)out->v[i] + P[i] + (u64)carry;
            out->v[i] = (u64)s;
            carry = s >> 64;
        }
    }
}

/* CIOS Montgomery multiplication: out = a*b*R^-1 mod p. */
static void fe_mont_mul(fe *out, const fe *a, const fe *b) {
    u64 t[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)a->v[i] * b->v[j] + (u64)carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s4 = (u128)t[4] + (u64)carry;
        u64 t5 = (u64)(s4 >> 64);
        t[4] = (u64)s4;

        u64 m = t[0] * N0;
        carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)m * P[j] + (u64)carry;
            t[j - 1] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[4] + (u64)carry;
        t[3] = (u64)s;
        t[4] = t5 + (u64)(s >> 64);
    }
    fe r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || fe_geq_p(&r)) fe_sub_p(&r);
    *out = r;
}

static inline void fe_to_mont(fe *out, const fe *a) {
    fe r2 = {{R2[0], R2[1], R2[2], R2[3]}};
    fe_mont_mul(out, a, &r2);
}

static inline void fe_from_mont(fe *out, const fe *a) {
    fe one = {{1, 0, 0, 0}};
    fe_mont_mul(out, a, &one);
}

/* ---- binary extended GCD inversion --------------------------------------
 * ~10x cheaper than the Fermat ladder (shift/sub iterations instead of
 * ~380 Montgomery multiplies). Witness generation is variable-time in the
 * reference too (gmp in the circom C generator), so this changes nothing
 * about the timing posture. */

static inline int fe256_is_even(const fe *a) { return (a->v[0] & 1) == 0; }

static inline void fe256_shr1(fe *a) {
    a->v[0] = (a->v[0] >> 1) | (a->v[1] << 63);
    a->v[1] = (a->v[1] >> 1) | (a->v[2] << 63);
    a->v[2] = (a->v[2] >> 1) | (a->v[3] << 63);
    a->v[3] >>= 1;
}

/* a >>= 1 in Z_p: odd values get +p first (p odd, so a+p is even). The
 * sum can carry past 2^256; fold the carry into the shift. */
static inline void fe256_half_mod(fe *a) {
    if (fe256_is_even(a)) {
        fe256_shr1(a);
    } else {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)a->v[i] + P[i] + (u64)carry;
            a->v[i] = (u64)s;
            carry = s >> 64;
        }
        fe256_shr1(a);
        a->v[3] |= (u64)carry << 63;
    }
}

static inline int fe256_cmp(const fe *a, const fe *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->v[i] > b->v[i]) return 1;
        if (a->v[i] < b->v[i]) return -1;
    }
    return 0;
}

static inline void fe256_sub_raw(fe *out, const fe *a, const fe *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - (u64)borrow;
        out->v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

/* out = in^-1 mod p for standard-form in (0 < in < p): HAC 14.61. */
static void fe_inv_xgcd(fe *out, const fe *in) {
    if (fe_is_zero(in)) { *out = *in; return; } /* 0 -> 0 (callers guard) */
    fe u = *in, v = {{P[0], P[1], P[2], P[3]}};
    fe x1 = {{1, 0, 0, 0}}, x2 = {{0, 0, 0, 0}};
    static const fe ONE = {{1, 0, 0, 0}};
    while (fe256_cmp(&u, &ONE) != 0 && fe256_cmp(&v, &ONE) != 0) {
        while (fe256_is_even(&u)) { fe256_shr1(&u); fe256_half_mod(&x1); }
        while (fe256_is_even(&v)) { fe256_shr1(&v); fe256_half_mod(&x2); }
        if (fe256_cmp(&u, &v) >= 0) {
            fe256_sub_raw(&u, &u, &v);
            fe_sub(&x1, &x1, &x2);
        } else {
            fe256_sub_raw(&v, &v, &u);
            fe_sub(&x2, &x2, &x1);
        }
    }
    *out = (fe256_cmp(&u, &ONE) == 0) ? x1 : x2;
}

/* Montgomery-form inverse: aR -> a^-1 R.  xGCD gives (aR)^-1 = a^-1 R^-1;
 * two REDC multiplies by R^2 restore the Montgomery factor. */
static void fe_mont_inv(fe *out, const fe *a) {
    fe inv, r2 = {{R2[0], R2[1], R2[2], R2[3]}};
    fe_inv_xgcd(&inv, a);
    fe_mont_mul(&inv, &inv, &r2); /* a^-1 R^-1 * R^2 * R^-1 = a^-1 */
    fe_mont_mul(out, &inv, &r2);  /* a^-1 * R^2 * R^-1 = a^-1 R */
}

/* ---- bytecode ---------------------------------------------------------- */

enum {
    OP_INPUT = 0,   /* out wires already hold standard values: to Montgomery */
    OP_LC = 1,      /* outs[0] = eval(lc0) */
    OP_MUL = 2,     /* outs[0] = eval(lc0) * eval(lc1) */
    OP_BITS = 3,    /* outs[j] = bit j of eval(lc0) */
    OP_ISZERO = 4,  /* outs = [inv or 0, flag] */
    OP_ONEHOT = 5,  /* outs[j] = eval(lc0) == j + param0 */
    OP_QUOREM = 6,  /* outs = [eval(lc0) / param0, eval(lc0) % param0] */
    OP_PYCALL = 7,  /* scratch-in LCs -> python callback -> outs */
    OP_FMS = 8,     /* outs[0] = eval(lc0)*eval(lc1) - eval(lc2): the C-side
                     * R1CS propagation solve x = (A.w)(B.w) - C_known.w with
                     * the unknown's coef inverse folded into lc0/lc2 */
    OP_DIVSUB = 9,  /* outs[0] = eval(lc0)*eval(lc1)^-1 - eval(lc2): the
                     * A/B-side solve x = (C.w)/(B.w) - A_known.w (errors if
                     * eval(lc1) == 0 — the witness is then underdetermined) */
};

/* op row layout: opcode, param0, param1, out_ptr, out_count, lc_ptr, lc_count, reserved */
#define OPROW 8

typedef int (*pycall_fn)(int64_t op_index, const u64 *in_std, int64_t n_in,
                         u64 *out_std, int64_t n_out);

typedef struct {
    const int64_t *op_table;
    int64_t n_ops;
    const int32_t *out_wires;
    const int32_t *lc_wires;     /* term wire index */
    const u64 *lc_coefs;         /* 4 u64 per term, Montgomery form */
    const int64_t *lc_offsets;   /* per-LC: (term_ptr, term_count) rows of 2 */
    u64 *wires;                  /* 4 u64 per wire, Montgomery during run */
    int64_t n_wires;
} prog;

/* coef tags for the +-1 fast path: circuit wiring is dominated by
 * coefficient 1 (copies/sums) and -1 (differences); both skip the
 * Montgomery multiply entirely (cR * vR * R^-1 = vR when c = 1). */
static inline int fe_eq4(const fe *a, const u64 b[4]) {
    return a->v[0] == b[0] && a->v[1] == b[1] && a->v[2] == b[2] && a->v[3] == b[3];
}

static void eval_lc(const prog *pg, int64_t lc_index, fe *out) {
    const int64_t *off = pg->lc_offsets + 2 * lc_index;
    int64_t ptr = off[0], cnt = off[1];
    fe acc = {{0, 0, 0, 0}};
    for (int64_t t = 0; t < cnt; t++) {
        const fe *coef = (const fe *)(pg->lc_coefs + 4 * (ptr + t));
        const fe *val = (const fe *)(pg->wires + 4 * pg->lc_wires[ptr + t]);
        if (fe_eq4(coef, RMODP)) {
            fe_add(&acc, &acc, val);
        } else if (fe_eq4(coef, NEGR)) {
            fe_sub(&acc, &acc, val);
        } else {
            fe prod;
            fe_mont_mul(&prod, coef, val);
            fe_add(&acc, &acc, &prod);
        }
    }
    *out = acc;
}

int witness_eval(const int64_t *op_table, int64_t n_ops,
                 const int32_t *out_wires,
                 const int32_t *lc_wires, const u64 *lc_coefs,
                 const int64_t *lc_offsets,
                 u64 *wires, int64_t n_wires,
                 pycall_fn pycb) {
    prog pg = {op_table, n_ops, out_wires, lc_wires, lc_coefs, lc_offsets,
               wires, n_wires};
    /* wire 0 = one (Montgomery) */
    memcpy(wires, RMODP, sizeof(RMODP));

    u64 scratch_in[5 * 64 * 4];
    u64 scratch_out[64 * 4 + 4];

    for (int64_t i = 0; i < n_ops; i++) {
        const int64_t *row = op_table + OPROW * i;
        int64_t opcode = row[0], p0 = row[1];
        int64_t out_ptr = row[3], out_cnt = row[4];
        int64_t lc_ptr = row[5], lc_cnt = row[6];
        const int32_t *outs = out_wires + out_ptr;

        switch (opcode) {
        case OP_INPUT:
            for (int64_t j = 0; j < out_cnt; j++) {
                fe *w = (fe *)(wires + 4 * outs[j]);
                fe_to_mont(w, w);
            }
            break;
        case OP_LC: {
            fe v;
            eval_lc(&pg, lc_ptr, &v);
            *(fe *)(wires + 4 * outs[0]) = v;
            break;
        }
        case OP_MUL: {
            fe a, b, r;
            eval_lc(&pg, lc_ptr, &a);
            eval_lc(&pg, lc_ptr + 1, &b);
            fe_mont_mul(&r, &a, &b);       /* (aR)(bR)R^-1 = abR */
            *(fe *)(wires + 4 * outs[0]) = r;
            break;
        }
        case OP_BITS: {
            fe m, s;
            eval_lc(&pg, lc_ptr, &m);
            fe_from_mont(&s, &m);
            for (int64_t j = 0; j < out_cnt; j++) {
                u64 bit = (s.v[j / 64] >> (j % 64)) & 1;
                fe *w = (fe *)(wires + 4 * outs[j]);
                if (bit) memcpy(w, RMODP, sizeof(RMODP));
                else memset(w, 0, sizeof(fe));
            }
            break;
        }
        case OP_ISZERO: {
            fe v;
            eval_lc(&pg, lc_ptr, &v);
            fe *inv = (fe *)(wires + 4 * outs[0]);
            fe *flag = (fe *)(wires + 4 * outs[1]);
            if (fe_is_zero(&v)) {
                memset(inv, 0, sizeof(fe));
                memcpy(flag, RMODP, sizeof(RMODP));
            } else {
                fe_mont_inv(inv, &v);
                memset(flag, 0, sizeof(fe));
            }
            break;
        }
        case OP_ONEHOT: {
            fe m, s;
            eval_lc(&pg, lc_ptr, &m);
            fe_from_mont(&s, &m);
            int small = (s.v[1] | s.v[2] | s.v[3]) == 0;
            for (int64_t j = 0; j < out_cnt; j++) {
                fe *w = (fe *)(wires + 4 * outs[j]);
                if (small && s.v[0] == (u64)(j + p0))
                    memcpy(w, RMODP, sizeof(RMODP));
                else
                    memset(w, 0, sizeof(fe));
            }
            break;
        }
        case OP_QUOREM: {
            fe m, s;
            eval_lc(&pg, lc_ptr, &m);
            fe_from_mont(&s, &m);
            if (s.v[1] | s.v[2] | s.v[3]) return -(int)i - 1; /* oversize */
            fe q = {{s.v[0] / (u64)p0, 0, 0, 0}};
            fe r = {{s.v[0] % (u64)p0, 0, 0, 0}};
            fe_to_mont((fe *)(wires + 4 * outs[0]), &q);
            fe_to_mont((fe *)(wires + 4 * outs[1]), &r);
            break;
        }
        case OP_PYCALL: {
            if (lc_cnt > 5 * 64 || out_cnt > 64) return -(int)i - 1;
            for (int64_t j = 0; j < lc_cnt; j++) {
                fe m;
                eval_lc(&pg, lc_ptr + j, &m);
                fe_from_mont((fe *)(scratch_in + 4 * j), &m);
            }
            if (pycb(i, scratch_in, lc_cnt, scratch_out, out_cnt) != 0)
                return -(int)i - 1;
            for (int64_t j = 0; j < out_cnt; j++) {
                fe_to_mont((fe *)(wires + 4 * outs[j]),
                           (const fe *)(scratch_out + 4 * j));
            }
            break;
        }
        case OP_FMS: {
            fe a, b, c, r;
            eval_lc(&pg, lc_ptr, &a);
            eval_lc(&pg, lc_ptr + 1, &b);
            eval_lc(&pg, lc_ptr + 2, &c);
            fe_mont_mul(&r, &a, &b);
            fe_sub(&r, &r, &c);
            *(fe *)(wires + 4 * outs[0]) = r;
            break;
        }
        case OP_DIVSUB: {
            fe a, b, c, inv, r;
            eval_lc(&pg, lc_ptr, &a);
            eval_lc(&pg, lc_ptr + 1, &b);
            eval_lc(&pg, lc_ptr + 2, &c);
            if (fe_is_zero(&b)) return -(int)i - 1;
            fe_mont_inv(&inv, &b);
            fe_mont_mul(&r, &a, &inv);
            fe_sub(&r, &r, &c);
            *(fe *)(wires + 4 * outs[0]) = r;
            break;
        }
        default:
            return -(int)i - 1;
        }
    }

    /* convert the whole witness to standard form */
    for (int64_t i = 0; i < n_wires; i++) {
        fe *w = (fe *)(wires + 4 * i);
        fe_from_mont(w, w);
    }
    return 0;
}

/* R1CS satisfaction check over standard-form wires.
 * Constraint LC tables share the format above but coefs are STANDARD form.
 * Returns -1 if satisfied, else the first violated constraint index. */
int64_t r1cs_check(const int64_t *abc_offsets, /* per-constraint 6 entries:
                                                  (a_ptr,a_cnt,b_ptr,b_cnt,c_ptr,c_cnt) */
                   int64_t n_constraints,
                   const int32_t *term_wires, const u64 *term_coefs_mont,
                   const u64 *wires_std, int64_t n_wires) {
    for (int64_t q = 0; q < n_constraints; q++) {
        const int64_t *off = abc_offsets + 6 * q;
        fe acc[3];
        for (int s = 0; s < 3; s++) {
            fe a = {{0, 0, 0, 0}};
            int64_t ptr = off[2 * s], cnt = off[2 * s + 1];
            for (int64_t t = 0; t < cnt; t++) {
                const fe *coef = (const fe *)(term_coefs_mont + 4 * (ptr + t));
                const fe *val = (const fe *)(wires_std + 4 * term_wires[ptr + t]);
                if (fe_eq4(coef, RMODP)) {          /* c = 1: cv = v */
                    fe_add(&a, &a, val);
                } else if (fe_eq4(coef, NEGR)) {    /* c = -1: cv = -v */
                    fe_sub(&a, &a, val);
                } else {
                    fe prod;
                    fe_mont_mul(&prod, coef, val); /* (cR)(v)R^-1 = cv */
                    fe_add(&a, &a, &prod);
                }
            }
            acc[s] = a;
        }
        /* a*b == c with standard-form acc: mont_mul(a,b) = abR^-1; compare
         * against mont_mul(c, 1) = cR^-1 */
        fe ab, cc, one = {{1, 0, 0, 0}};
        fe_mont_mul(&ab, &acc[0], &acc[1]);
        fe_mont_mul(&cc, &acc[2], &one);
        if (memcmp(&ab, &cc, sizeof(fe)) != 0) return q;
    }
    return -1;
}
