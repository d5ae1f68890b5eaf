"""Hash-to-field and Fiat-Shamir string gadgets.

Native equivalents of the reference's hashtofield and strings templates:

- HashBytesToFieldWithLen (helpers/hashtofield/HashBytesToFieldWithLen.circom
  :40-68): pack 31 bytes little-endian per scalar, append the length, hash
  with the HashElemsToField tree;
- HashElemsToField (HashElemsToField.circom:25-100): Poseidon(n) for n<=16,
  else a hex-ary tree of Poseidon(16) roots;
- Hash64BitLimbsToFieldWithLen: 3 limbs (192 bits) per scalar;
- IsSubstring / AssertIsSubstring / AssertIsConcatenation
  (helpers/strings/IsSubstring.circom:38-110, AssertIsConcatenation.circom):
  polynomial-identity checks at a Poseidon-derived Fiat-Shamir challenge.

A jax-free copy of keyless_zk_tpu/circuits/hash_gadget.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .r1cs import ConstraintSystem, LinComb
from .gadgets import (
    array_selector,
    is_equal,
    is_zero,
    poseidon_gadget,
    right_array_selector,
    select_array_value,
)

BYTES_PER_SCALAR = 31


def pack_chunks(cs: ConstraintSystem, vals: list[LinComb], per: int, bits: int) -> list[LinComb]:
    """ChunksToFieldElems: little-endian fixed-width packing (free/linear)."""
    out = []
    for i in range(0, len(vals), per):
        acc = LinComb()
        for j, v in enumerate(vals[i : i + per]):
            acc = acc + v.scale(1 << (bits * j))
        out.append(acc)
    return out


def hash_elems_to_field(cs: ConstraintSystem, elems: list[LinComb]) -> LinComb:
    """HashElemsToField tree (singleton tail chunks go through Poseidon(1))."""
    level = list(elems)
    if len(level) <= 16:
        return poseidon_gadget(cs, level)
    while len(level) > 1:
        level = [
            poseidon_gadget(cs, level[i : i + 16]) for i in range(0, len(level), 16)
        ]
    return level[0]


def hash_bytes_to_field_with_len(
    cs: ConstraintSystem,
    byte_vals: list[LinComb],
    length: LinComb,
    assume_bytes: bool = False,
) -> LinComb:
    """HashBytesToFieldWithLen; set assume_bytes when the caller already
    range-checked (the AssertIsBytes at HashBytesToFieldWithLen.circom:47)."""
    if not assume_bytes:
        for b in byte_vals:
            cs.to_bits(b, 8)
    packed = pack_chunks(cs, byte_vals, BYTES_PER_SCALAR, 8)
    return hash_elems_to_field(cs, [*packed, length])


def hash_64bit_limbs_to_field_with_len(
    cs: ConstraintSystem, limbs: list[LinComb], length: LinComb
) -> LinComb:
    """Hash64BitLimbsToFieldWithLen: 3 x 64-bit limbs packed per scalar."""
    packed = pack_chunks(cs, limbs, 3, 64)
    return hash_elems_to_field(cs, [*packed, length])


def _challenge_powers(cs: ConstraintSystem, alpha: LinComb, n: int) -> list[LinComb]:
    powers = [cs.const(1), alpha]
    for _ in range(2, n):
        powers.append(cs.lc(cs.mul(powers[-1], alpha)))
    return powers[:n]


def is_substring(
    cs: ConstraintSystem,
    string: list[LinComb],
    str_hash: LinComb,
    substr: list[LinComb],
    substr_len: LinComb,
    start_index: LinComb,
    assume_bytes: bool = False,
) -> int:
    """1 iff substr (0-padded after substr_len) occurs in string at
    start_index (IsSubstring.circom:38-110)."""
    max_str = len(string)
    substr_hash = hash_bytes_to_field_with_len(cs, substr, substr_len, assume_bytes)
    alpha = poseidon_gadget(cs, [str_hash, substr_hash, substr_len, start_index])
    powers = _challenge_powers(cs, alpha, max_str)

    sel = array_selector(cs, start_index, start_index + substr_len, max_str)
    str_eval = LinComb()
    for i in range(max_str):
        masked = cs.lc(cs.mul(cs.lc(sel[i]), string[i]))
        str_eval = str_eval + cs.lc(cs.mul(masked, powers[i]))
    sub_eval = LinComb()
    for i, ch in enumerate(substr):
        sub_eval = sub_eval + cs.lc(cs.mul(ch, powers[i]))

    shift = select_array_value(cs, powers, start_index)
    nonzero = cs.const(1) - cs.lc(is_zero(cs, str_eval))
    matches = cs.lc(is_equal(cs, str_eval, cs.lc(cs.mul(shift, sub_eval))))
    return cs.mul(nonzero, matches)


def assert_is_substring(cs, string, str_hash, substr, substr_len, start_index, assume_bytes=False):
    ok = is_substring(cs, string, str_hash, substr, substr_len, start_index, assume_bytes)
    cs.constrain_eq(cs.lc(ok), cs.const(1))


def assert_is_concatenation(
    cs: ConstraintSystem,
    full: list[LinComb],
    left: list[LinComb],
    right: list[LinComb],
    left_len: LinComb,
    right_len: LinComb,
    assume_bytes: bool = False,
) -> None:
    """full == left[0:left_len] || right[0:right_len]
    (AssertIsConcatenation.circom; `right` must be 0-padded upstream)."""
    left_hash = hash_bytes_to_field_with_len(cs, left, left_len, assume_bytes)
    right_hash = hash_bytes_to_field_with_len(cs, right, right_len, assume_bytes)
    full_hash = hash_bytes_to_field_with_len(cs, full, left_len + right_len, assume_bytes)
    alpha = poseidon_gadget(cs, [left_hash, right_hash, full_hash, left_len])

    # left must be 0-padded after left_len
    zero_sel = right_array_selector(cs, left_len - cs.const(1), len(left))
    for i, ch in enumerate(left):
        cs.constrain(cs.lc(zero_sel[i]), ch, LinComb())

    powers = _challenge_powers(cs, alpha, len(full))
    def poly_eval(seq):
        acc = LinComb()
        for i, ch in enumerate(seq):
            acc = acc + cs.lc(cs.mul(ch, powers[i]))
        return acc

    left_eval = poly_eval(left)
    right_eval = poly_eval(right)
    full_eval = poly_eval(full)
    shift = select_array_value(cs, powers, left_len)
    cs.constrain_eq(full_eval, left_eval + cs.lc(cs.mul(shift, right_eval)))
