"""Host-side (python-int) BN254 group arithmetic.

Plays the role the generic C++ field/curve fallback plays in the reference
(rust-rapidsnark fr_generic.cpp, curve.cpp): an exact, slow, obviously-correct
model used (a) as ground truth in differential tests of the CUDA kernels,
(b) for the tiny final-tail computations where batching buys nothing
(the Groth16 blinding tail), and (c) by the synthetic-key dlog oracle.

A frozen copy of keyless_zk_tpu_torch/curves/ref_curve.py for the
benchmark's reference: it imports nothing of the program.

Affine points are (x, y) tuples of ints (Fq) or of Fq2 pairs; None is the
point at infinity.
"""

from __future__ import annotations

from . import bn254

Q = bn254.Q


# ---- Fq2 = Fq[u]/(u^2+1) ---------------------------------------------------

def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
    return ((a[0] * d) % Q, (-a[1] * d) % Q)


def fq2_scalar(c):
    return (c % Q, 0)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)

# Twist curve constant b' = 3 / (9 + u) for G2.
B2 = fq2_mul(fq2_scalar(3), fq2_inv((9, 1)))


class GroupOps:
    """Generic short-Weierstrass affine ops over a field given by callables."""

    def __init__(self, add, sub, mul, inv, neg, zero, one, b):
        self.fadd, self.fsub, self.fmul, self.finv, self.fneg = add, sub, mul, inv, neg
        self.zero, self.one, self.b = zero, one, b

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        lhs = self.fmul(y, y)
        rhs = self.fadd(self.fmul(self.fmul(x, x), x), self.b)
        return lhs == rhs

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.fneg(pt[1]))

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if y1 != y2 or y1 == self.zero:
                return None
            # doubling
            num = self.fmul(self.fmul(x1, x1), self._three())
            den = self.fadd(y1, y1)
        else:
            num = self.fsub(y2, y1)
            den = self.fsub(x2, x1)
        lam = self.fmul(num, self.finv(den))
        x3 = self.fsub(self.fsub(self.fmul(lam, lam), x1), x2)
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def _three(self):
        return self.fadd(self.fadd(self.one, self.one), self.one)

    def mul(self, pt, k: int):
        k %= bn254.R_SCALAR
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.add(pt, pt)
            k >>= 1
        return acc

    def msm(self, scalars, points):
        acc = None
        for s, p in zip(scalars, points):
            acc = self.add(acc, self.mul(p, s))
        return acc


G1 = GroupOps(
    add=lambda a, b: (a + b) % Q,
    sub=lambda a, b: (a - b) % Q,
    mul=lambda a, b: (a * b) % Q,
    inv=lambda a: pow(a, -1, Q),
    neg=lambda a: (-a) % Q,
    zero=0,
    one=1,
    b=bn254.CURVE_B,
)

G2 = GroupOps(
    add=fq2_add,
    sub=fq2_sub,
    mul=fq2_mul,
    inv=fq2_inv,
    neg=fq2_neg,
    zero=FQ2_ZERO,
    one=FQ2_ONE,
    b=B2,
)

G1_GEN = bn254.G1_GENERATOR
G2_GEN = (bn254.G2_GENERATOR_X, bn254.G2_GENERATOR_Y)

assert G1.is_on_curve(G1_GEN)
assert G2.is_on_curve(G2_GEN)
