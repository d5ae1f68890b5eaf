"""BN254 (alt_bn128) optimal-ate pairing and Groth16 verification, host side.

A frozen copy of keyless_zk_tpu_torch/groth16/pairing.py for the benchmark's
reference: the pure-Python tower only (about half a second per check), and it
imports nothing of the program.

Tower: Fq2 = Fq[i]/(i^2+1); Fq12 = Fq[w]/(w^12 - 18 w^6 + 82), with G2
points on the twist mapped into Fq12 by the standard untwist
(x -> x' * w^2, y -> y' * w^3). The algorithm shape (twist, line
functions, Miller loop, final exponentiation) follows the public py_ecc
bn128 construction.
"""

from __future__ import annotations

from . import bn254

Q = bn254.Q
R_SCALAR = bn254.R_SCALAR

ATE_LOOP_COUNT = 29793968203157093288  # 6x + 2 for the BN parameter x
LOG_ATE_LOOP_COUNT = 63

# Fq12 = Fq[w] / (w^12 - 18 w^6 + 82)
FQ12_MODULUS_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)


def _inv(a: int, p: int = Q) -> int:
    return pow(a, -1, p)


class FQ2:
    """Fq2 element as (c0, c1): c0 + c1*i with i^2 = -1."""

    __slots__ = ("c",)

    def __init__(self, c0: int, c1: int = 0):
        self.c = (c0 % Q, c1 % Q)

    def __add__(self, o):
        return FQ2(self.c[0] + o.c[0], self.c[1] + o.c[1])

    def __sub__(self, o):
        return FQ2(self.c[0] - o.c[0], self.c[1] - o.c[1])

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ2(self.c[0] * o, self.c[1] * o)
        a0, a1 = self.c
        b0, b1 = o.c
        return FQ2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def __neg__(self):
        return FQ2(-self.c[0], -self.c[1])

    def inv(self):
        a0, a1 = self.c
        d = _inv(a0 * a0 + a1 * a1)
        return FQ2(a0 * d, -a1 * d)

    def __eq__(self, o):
        return self.c == o.c

    def is_zero(self):
        return self.c == (0, 0)

    @staticmethod
    def one():
        return FQ2(1, 0)

    @staticmethod
    def zero():
        return FQ2(0, 0)


class FQ12:
    """Fq12 element as a 12-coefficient polynomial in w over Fq."""

    __slots__ = ("c",)

    def __init__(self, coeffs):
        self.c = tuple(x % Q for x in coeffs)
        assert len(self.c) == 12

    @staticmethod
    def one():
        return FQ12((1,) + (0,) * 11)

    @staticmethod
    def zero():
        return FQ12((0,) * 12)

    def __add__(self, o):
        return FQ12(tuple(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o):
        return FQ12(tuple(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self):
        return FQ12(tuple(-a for a in self.c))

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ12(tuple(a * o for a in self.c))
        t = [0] * 23
        a, b = self.c, o.c
        for i in range(12):
            ai = a[i]
            if ai:
                for j in range(12):
                    t[i + j] += ai * b[j]
        # reduce by w^12 = 18 w^6 - 82
        for k in range(22, 11, -1):
            v = t[k]
            if v:
                t[k - 6] += 18 * v
                t[k - 12] -= 82 * v
                t[k] = 0
        return FQ12(t[:12])

    __rmul__ = __mul__

    def __eq__(self, o):
        return self.c == o.c

    def inv(self):
        """Extended Euclid over Fq[w] against the FQ12 modulus polynomial."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = list(FQ12_MODULUS_COEFFS) + [1]  # the monic modulus polynomial
        while _deg(low):
            r = _poly_rounded_div(high, low)
            nm, new = hm[:], high[:]
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        d = _inv(low[0])
        return FQ12([(c * d) % Q for c in lm[:12]])

    def __pow__(self, e: int):
        res = FQ12.one()
        base = self
        while e > 0:
            if e & 1:
                res = res * base
            base = base * base
            e >>= 1
        return res


def _deg(p):
    d = len(p) - 1
    while d and p[d] % Q == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _deg(a), _deg(b)
    temp = [x % Q for x in a]
    o = [0] * len(a)
    binv = _inv(b[degb] % Q)
    for i in range(dega - degb, -1, -1):
        o[i] = (o[i] + temp[degb + i] * binv) % Q
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - o[i] * b[c]) % Q
    return o[:13]


# ---- curve ops over a generic coefficient field ------------------------------

def _is_inf(pt):
    return pt is None


def _norm(v):
    """Reduce an int coordinate mod Q; FQ12 coordinates self-reduce."""
    return v % Q if isinstance(v, int) else v


def _double(pt):
    if pt is None:
        return None
    x, y = pt
    m_num = 3 * x * x
    m = m_num * _field_inv(2 * y)
    nx = _norm(m * m - 2 * x)
    ny = _norm(m * (x - nx) - y)
    return (nx, ny)


def _field_inv(v):
    if isinstance(v, int):
        return _inv(v % Q)
    return v.inv()


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    if x1 == x2:
        return None
    m = (y2 - y1) * _field_inv(x2 - x1)
    nx = _norm(m * m - x1 - x2)
    ny = _norm(m * (x1 - nx) - y1)
    return (nx, ny)


def multiply(pt, n: int):
    if n % R_SCALAR == 0 or pt is None:
        return None
    n = n % R_SCALAR
    result = None
    addend = pt
    while n:
        if n & 1:
            result = _add(result, addend)
        addend = _double(addend)
        n >>= 1
    return result


def g1_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % Q if isinstance(y, int) else -y)


# ---- twist & miller loop -----------------------------------------------------

_W2 = FQ12((0, 0, 1) + (0,) * 9)  # w^2
_W3 = FQ12((0, 0, 0, 1) + (0,) * 8)  # w^3


def twist(pt):
    """G2 point ((x0,x1),(y0,y1)) over Fq2 -> point over Fq12."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    xc = [(x0 - 9 * x1) % Q, x1 % Q]
    yc = [(y0 - 9 * y1) % Q, y1 % Q]
    nx = FQ12((xc[0],) + (0,) * 5 + (xc[1],) + (0,) * 5)
    ny = FQ12((yc[0],) + (0,) * 5 + (yc[1],) + (0,) * 5)
    return (nx * _W2, ny * _W3)


def cast_g1_to_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12((x,) + (0,) * 11), FQ12((y,) + (0,) * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 - x2) == FQ12.zero():
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (3 * (x1 * x1)) * (2 * y1).inv()
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def _frob12(pt):
    """(x, y) -> (x^q, y^q) coefficient-wise Frobenius in Fq12 via pow."""
    x, y = pt
    return (x ** Q, y ** Q)


def miller_loop(q_fq12, p_fq12, final_exp: bool = True) -> FQ12:
    if q_fq12 is None or p_fq12 is None:
        return FQ12.one()
    r = q_fq12
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r, r, p_fq12)
        r = _double_fq12(r)
        if ATE_LOOP_COUNT & (2**i):
            f = f * _linefunc(r, q_fq12, p_fq12)
            r = _add_fq12(r, q_fq12)
    q1 = _frob12(q_fq12)
    nq2 = _frob12(q1)
    nq2 = (nq2[0], -nq2[1])
    f = f * _linefunc(r, q1, p_fq12)
    r = _add_fq12(r, q1)
    f = f * _linefunc(r, nq2, p_fq12)
    if final_exp:
        return f ** ((Q**12 - 1) // R_SCALAR)
    return f


def _double_fq12(pt):
    x, y = pt
    m = (3 * (x * x)) * (2 * y).inv()
    nx = m * m - 2 * x
    ny = m * (x - nx) - y
    return (nx, ny)


def _add_fq12(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double_fq12(p1)
    m = (y2 - y1) * (x2 - x1).inv()
    nx = m * m - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def pairing(q_g2, p_g1, final_exp: bool = True) -> FQ12:
    """e(P, Q) with P in G1 ((x, y) ints), Q in G2 ((x0,x1),(y0,y1))."""
    return miller_loop(twist(q_g2), cast_g1_to_fq12(p_g1), final_exp=final_exp)


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, sharing one final exponentiation."""
    f = FQ12.one()
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        f = f * miller_loop(twist(q_g2), cast_g1_to_fq12(p_g1), final_exp=False)
    return f ** ((Q**12 - 1) // R_SCALAR) == FQ12.one()


# ---- Groth16 verification ----------------------------------------------------

def verify_groth16(vk: dict, public_inputs: list[int], proof: dict) -> bool:
    """Pairing check e(A,B) = e(alpha,beta) e(L,gamma) e(C,delta).

    `vk` is the snarkjs verification_key.json dict (decimal strings); `proof`
    is the snarkjs proof dict (pi_a/pi_b/pi_c) as produced by the prover
    (format of reference groth16.cpp:362-410).
    """

    def g1(v):
        x, y = int(v[0]), int(v[1])
        if x == 0 and y == 0:
            return None
        return (x, y)

    def g2(v):
        return ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))

    ic = [g1(p) for p in vk["IC"]]
    if len(ic) != len(public_inputs) + 1:
        raise ValueError("the vk's IC does not match the public inputs")
    acc = ic[0]
    for w, pt in zip(public_inputs, ic[1:]):
        acc = _add(acc, multiply(pt, w))

    a = g1(proof["pi_a"])
    b = g2(proof["pi_b"])
    c = g1(proof["pi_c"])
    pairs = [
        (g1_neg(a), b),
        (g1(vk["vk_alpha_1"]), g2(vk["vk_beta_2"])),
        (acc, g2(vk["vk_gamma_2"])),
        (c, g2(vk["vk_delta_2"])),
    ]
    return pairing_product_is_one(pairs)
