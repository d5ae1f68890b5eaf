"""Base64url decoding in R1CS.

Native equivalent of the reference's base64url templates
(circuit/templates/helpers/base64url/Base64UrlDecode.circom:17-90,
Base64UrlLookup.circom, Base64UrlDecodedLength.circom): per-character
range-indicator lookup with the completeness check sum(ranges) == 1,
4x6-bit -> 3x8-bit repacking, and the floor(3m/4) decoded-length gadget
with Euclidean-division hints.

A jax-free copy of keyless_zk_tpu/circuits/base64_gadget.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .r1cs import ConstraintSystem, LinComb, P
from .gadgets import less_than


def base64url_lookup(cs: ConstraintSystem, ch: LinComb) -> LinComb:
    """6-bit decoded value of one base64url character (byte LinComb).

    Accepts A-Z a-z 0-9 - _ and, like the reference, '=' and 0-padding
    (both decode to 0); any other byte is unsatisfiable.
    """

    def in_range(lo: int, hi: int) -> LinComb:
        # (ch >= lo) * (ch <= hi)
        ge = cs.const(1) - cs.lc(less_than(cs, ch, cs.const(lo), 8))
        le = cs.lc(less_than(cs, ch, cs.const(hi + 1), 8))
        return cs.lc(cs.mul(ge, le))

    def is_eq(val: int) -> LinComb:
        from .gadgets import is_zero

        return cs.lc(is_zero(cs, ch - cs.const(val)))

    r_AZ = in_range(65, 90)
    r_az = in_range(97, 122)
    r_09 = in_range(48, 57)
    r_minus = is_eq(45)
    r_under = is_eq(95)
    r_eq = is_eq(61)
    r_zero = is_eq(0)

    out = cs.lc(cs.mul(r_AZ, ch - cs.const(65)))
    out = out + cs.lc(cs.mul(r_az, ch - cs.const(71)))
    out = out + cs.lc(cs.mul(r_09, ch + cs.const(4)))
    out = out + r_minus.scale(62) + r_under.scale(63)

    total = r_AZ + r_az + r_09 + r_minus + r_under + r_eq + r_zero
    cs.constrain_eq(total, cs.const(1))
    return out


def base64url_decode(cs: ConstraintSystem, chars: list[LinComb], n_out: int) -> list[LinComb]:
    """Decode base64url characters to n_out bytes (Base64UrlDecode(N)).

    chars has length floor((4*n_out + 2) / 3); zero-padding decodes to 0.
    """
    m = (4 * n_out + 2) // 3
    assert len(chars) == m
    out: list[LinComb] = []
    for i in range(0, m, 4):
        group = chars[i : i + 4]
        # missing tail characters behave as zero padding
        vals = []
        for ch in group:
            six = base64url_lookup(cs, ch)
            vals.append([cs.lc(b) for b in cs.to_bits(six, 6)])  # LSB first
        while len(vals) < 4:
            vals.append([LinComb()] * 6)
        c0, c1, c2, c3 = vals

        def pack(bits_lsb_first: list[LinComb]) -> LinComb:
            acc = LinComb()
            for j, b in enumerate(bits_lsb_first):
                acc = acc + b.scale(1 << j)
            return acc

        byte0 = pack([c1[4], c1[5]] + c0)  # c0 << 2 | c1 >> 4
        byte1 = pack(c2[2:6] + c1[0:4])  # (c1 & 0xF) << 4 | c2 >> 2
        byte2 = pack(c3 + [c2[0], c2[1]])  # (c2 & 3) << 6 | c3
        for j, b in enumerate((byte0, byte1, byte2)):
            if i // 4 * 3 + j < n_out:
                out.append(b)
    return out


def base64url_decoded_length(
    cs: ConstraintSystem, m: LinComb, max_encoded_len: int
) -> LinComb:
    """floor(3*m/4) with in-circuit Euclidean-division check
    (Base64UrlDecodedLength)."""
    max_quo = (3 * max_encoded_len) // 4
    q = cs.new_wire()
    r = cs.new_wire()
    cs.op("quorem", (4,), [q, r], [m.scale(3)])
    cs.constrain_eq(m.scale(3), cs.lc((q, 4)) + cs.lc(r))
    cs.to_bits(cs.lc(r), 2)
    cs.to_bits(cs.lc(q), max(max_quo.bit_length(), 1))
    return cs.lc(q)
