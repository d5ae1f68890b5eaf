"""RSA-2048 verification gadgets: bignum modmul + PKCS#1 v1.5 check.

Native equivalents of the reference's RSA templates
(circuit/templates/helpers/rsa/FpMul.circom:28-94, FpPow65537Mod.circom:6-41,
RSA_PKCS1_v1_5_Verify.circom:13-57): K=32 limbs of N=64 bits, modular
multiplication proven via the polynomial-identity technique —

    conv(a,b) - conv(p,q) - r  interpolated from 2K-1 point evaluations
    (each evaluation one product constraint), then shown to carry to zero
    as a bounded integer (CheckCarryToZero.circom semantics).

Witness hints perform the long division (the circom `<--` hints at
FpMul.circom:55-66) and the signed carry chain natively.

A jax-free copy of keyless_zk_tpu/circuits/rsa_gadget.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import functools

from .r1cs import ConstraintSystem, LinComb, P

N_BITS = 64
K_LIMBS = 32


def materialize(cs: ConstraintSystem, lc: LinComb) -> int:
    """Return a wire carrying lc's value (reuses the wire when lc is one)."""
    if len(lc) == 1:
        (w, c), = lc.items()
        if c == 1 and w != 0:
            return w
    out = cs.new_wire()
    cs.op("lc", (), [out], [lc])
    cs.constrain_eq(cs.lc(out), lc)
    return out


@functools.lru_cache(maxsize=4)
def _interp_matrix(n_points: int) -> tuple:
    """Row i = coefficients expressing poly coef i from values at x=0..n-1."""
    # Lagrange: p(X) = sum_j v_j * prod_{m != j} (X - m)/(j - m)
    rows = [[0] * n_points for _ in range(n_points)]
    for j in range(n_points):
        # numerator polynomial prod_{m != j}(X - m) as int coefficients
        poly = [1]
        for m in range(n_points):
            if m == j:
                continue
            poly = [
                ((poly[k - 1] if k > 0 else 0) - m * (poly[k] if k < len(poly) else 0))
                % P
                for k in range(len(poly) + 1)
            ]
        denom = 1
        for m in range(n_points):
            if m != j:
                denom = denom * (j - m) % P
        dinv = pow(denom, -1, P)
        for i in range(n_points):
            rows[i][j] = poly[i] * dinv % P
    return tuple(tuple(r) for r in rows)


def fp_mul(
    cs: ConstraintSystem,
    a: list[int],
    b: list[int],
    modulus: list[int],
    n_bits: int = N_BITS,
    k: int = K_LIMBS,
) -> list[int]:
    """out = a*b mod modulus, limbs as wires (LSB-limb first).

    Inputs must already be range-checked to n_bits per limb; q and r are
    range-checked here.  Values need only be correct mod modulus
    (FpMul.circom's contract).
    """
    L = 2 * k - 1
    q = cs.new_wires(k)
    r = cs.new_wires(k)
    limb_lcs = [cs.lc(w) for w in a + b + modulus]
    cs.op("bigdiv", (n_bits, k), q + r, limb_lcs)
    for w in q + r:
        cs.to_bits(cs.lc(w), n_bits)

    # point evaluations (one product constraint each)
    def poly_at(limbs: list[int], x: int) -> LinComb:
        acc = LinComb()
        xp = 1
        for w in limbs:
            acc = acc + cs.lc((w, xp))
            xp = xp * x % P
        return acc

    v_ab = [cs.mul(poly_at(a, x), poly_at(b, x)) for x in range(L)]
    v_pq = [cs.mul(poly_at(modulus, x), poly_at(q, x)) for x in range(L)]

    # t_j = conv(a,b)_j - conv(p,q)_j - r_j as linear combinations
    inv = _interp_matrix(L)
    t = []
    for j in range(L):
        acc = LinComb()
        for x in range(L):
            cjx = inv[j][x]
            if cjx:
                acc = acc + cs.lc((v_ab[x], cjx), (v_pq[x], P - cjx))
        if j < k:
            acc = acc - cs.lc(r[j])
        t.append(acc)

    # signed carry chain: t_j + c_{j-1} = c_j * 2^n_bits, |c_j| < 2^carry_mag
    carry_mag = n_bits + (k - 1).bit_length() + 2
    carries = cs.new_wires(L - 1)
    cs.op(
        "bigcarry", (n_bits, k), carries, [cs.lc(w) for w in a + b + modulus + q + r]
    )
    prev = LinComb()
    for j in range(L - 1):
        cs.constrain_eq(t[j] + prev, cs.lc((carries[j], 1 << n_bits)))
        # range check the signed carry via an offset decomposition
        cs.to_bits(cs.lc(carries[j]) + cs.const(1 << carry_mag), carry_mag + 1)
        prev = cs.lc(carries[j])
    cs.constrain_zero(t[L - 1] + prev)
    return r


def fp_pow_65537(
    cs: ConstraintSystem, base: list[int], modulus: list[int], n_bits=N_BITS, k=K_LIMBS
) -> list[int]:
    """base^65537 mod modulus (FpPow65537Mod: 16 squarings + 1 multiply)."""
    acc = base
    for _ in range(16):
        acc = fp_mul(cs, acc, acc, modulus, n_bits, k)
    return fp_mul(cs, base, acc, modulus, n_bits, k)


# PKCS#1 v1.5 SHA-256 EM constants (RSA_PKCS1_v1_5_Verify.circom:36-57)
_DER_LIMB_4 = 217300885422736416
_DER_LIMB_5 = 938447882527703397
_REMAINS_BITS = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0,
                 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0]
_DER_LIMB_6 = sum(_REMAINS_BITS[31 - i] << i for i in range(32)) + ((1 << 64) - (1 << 32))
_PS_LIMB = (1 << 64) - 1
_TOP_LIMB = (1 << 49) - 1


def rsa_pkcs1_verify(
    cs: ConstraintSystem,
    signature: list[int],
    modulus: list[int],
    hashed: list[LinComb],
) -> None:
    """Assert signature^65537 mod modulus == EM(SHA-256 digest).

    `hashed` is the digest as 4 x 64-bit values, least-significant limb
    first (RSA_PKCS1_v1_5_Verify.circom:13-57).
    """
    assert len(hashed) == 4
    em = fp_pow_65537(cs, signature, modulus)
    for i in range(4):
        cs.constrain_eq(cs.lc(em[i]), hashed[i])
    cs.constrain_eq(cs.lc(em[4]), cs.const(_DER_LIMB_4))
    cs.constrain_eq(cs.lc(em[5]), cs.const(_DER_LIMB_5))
    cs.constrain_eq(cs.lc(em[6]), cs.const(_DER_LIMB_6))
    for i in range(7, 31):
        cs.constrain_eq(cs.lc(em[i]), cs.const(_PS_LIMB))
    cs.constrain_eq(cs.lc(em[31]), cs.const(_TOP_LIMB))
