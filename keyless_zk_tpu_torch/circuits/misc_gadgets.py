"""Remaining keyless helper gadgets: ascii digits, bit packing, bigint
comparison, SHA2 padding verification.

Native equivalents of circuit/templates/helpers/strings/AsciiDigitsToScalar
.circom, AssertIsAsciiDigits.circom, packing/BigEndianBitsToScalars.circom,
packing/AssertIs64BitLimbs, bigint/BigLessThan.circom, and
sha/SHA2_256_PaddingVerify.circom.

A jax-free copy of keyless_zk_tpu/circuits/misc_gadgets.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .r1cs import ConstraintSystem, LinComb, P
from .gadgets import array_selector, is_equal, less_than
from .jwt_gadget import b_and, b_not, b_or, multi_and
from .hash_gadget import assert_is_substring, hash_bytes_to_field_with_len


def assert_is_ascii_digits(cs: ConstraintSystem, digits: list[LinComb], length: LinComb) -> None:
    """AssertIsAsciiDigits: in[0..len-1] must be in [48, 57]."""
    sel = array_selector(cs, LinComb(), length, len(digits))
    for i, d in enumerate(digits):
        cs.to_bits(d, 9)
        gt47 = b_not(cs, cs.lc(less_than(cs, d, cs.const(48), 9)))
        lt58 = cs.lc(less_than(cs, d, cs.const(58), 9))
        ok = b_and(cs, gt47, lt58)
        cs.constrain(b_not(cs, ok), cs.lc(sel[i]), LinComb())


def ascii_digits_to_scalar(cs: ConstraintSystem, digits: list[LinComb], length: LinComb) -> LinComb:
    """AsciiDigitsToScalar: decimal ASCII -> field element (MAX_LEN > 1)."""
    n = len(digits)
    assert n > 1
    assert_is_ascii_digits(cs, digits, length)

    index_eq = cs.new_wires(n - 1)
    cs.op("onehot", (1,), index_eq, [length])
    s = cs.const(1)
    acc = digits[0] - cs.const(48)
    total = LinComb()
    for i in range(1, n):
        cs.constrain(cs.lc(index_eq[i - 1]), length - cs.const(i), LinComb())
        s = s - cs.lc(index_eq[i - 1])
        total = total + cs.lc(index_eq[i - 1])
        shift = acc.scale(10) + digits[i] - cs.const(48)
        acc = cs.lc(cs.mul(shift - acc, s)) + acc
    cs.constrain_eq(total, cs.const(1))
    return acc


def big_endian_bits_to_scalars(
    cs: ConstraintSystem, bits: list[LinComb], bits_per_scalar: int
) -> list[LinComb]:
    """BigEndianBitsToScalars (linear packing, MSB first within each scalar)."""
    out = []
    for i in range(0, len(bits), bits_per_scalar):
        group = bits[i : i + bits_per_scalar]
        acc = LinComb()
        for j, b in enumerate(group):
            acc = acc + b.scale(1 << (len(group) - 1 - j))
        out.append(acc)
    return out


def assert_is_64bit_limbs(cs: ConstraintSystem, limbs) -> None:
    for l in limbs:
        cs.to_bits(l if isinstance(l, LinComb) else cs.lc(l), 64)


def big_less_than(cs: ConstraintSystem, a: list[LinComb], b: list[LinComb], n_bits: int = 64) -> LinComb:
    """BigLessThan.circom: multi-limb a < b (limbs LSB first, pre-range-checked)."""
    k = len(a)
    lt = [cs.lc(less_than(cs, a[i], b[i], n_bits)) for i in range(k)]
    eq = [cs.lc(is_equal(cs, a[i], b[i])) for i in range(k)]
    out = lt[k - 1]
    eq_run = eq[k - 1]
    for i in range(k - 2, -1, -1):
        out = b_or(cs, out, b_and(cs, eq_run, lt[i]))
        if i:
            eq_run = b_and(cs, eq_run, eq[i])
    return out


INV8 = pow(8, -1, P)


def sha2_padding_verify(
    cs: ConstraintSystem,
    msg: list[LinComb],
    num_blocks: LinComb,
    padding_start: LinComb,
    l_byte_encoded: list[LinComb],
    padding_without_len: list[LinComb],
) -> None:
    """SHA2_256_PaddingVerify.circom:11-41 (RFC 4634 padding)."""
    len_bits = num_blocks.scale(512)
    k = len_bits - padding_start.scale(8) - cs.const(65)
    cs.to_bits(k, 9)

    in_hash = hash_bytes_to_field_with_len(cs, msg, num_blocks.scale(64))
    # 4.1.a: "1000...0" bytes appear right after the message
    assert_is_substring(
        cs,
        msg,
        in_hash,
        padding_without_len,
        (k + cs.const(1)).scale(INV8),
        padding_start,
    )
    cs.constrain_eq(padding_without_len[0], cs.const(128))
    for b in padding_without_len[1:]:
        cs.constrain_zero(b)

    # 4.1.c: the 64-bit big-endian length terminates the padded message
    assert_is_substring(
        cs,
        msg,
        in_hash,
        l_byte_encoded,
        cs.const(8),
        padding_start + (k + cs.const(1)).scale(INV8),
    )
    l_val = LinComb()
    for i, byte in enumerate(l_byte_encoded):
        l_val = l_val + byte.scale(1 << (8 * (7 - i)))
    cs.constrain_eq(l_val, padding_start.scale(8))
