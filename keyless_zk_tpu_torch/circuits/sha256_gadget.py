"""SHA-256 compression in R1CS (the keyless relation's heaviest block).

Native equivalent of circomlib's sha256compression.circom as wrapped by the
reference's SHA2_256_Prepadded_Hash (circuit/templates/helpers/sha/
SHA2_256_Prepadded_Hash.circom:14-84): hash every 512-bit block of an
already-padded bit array, then mux out the digest at block `t_block` with a
one-hot selector.

Design notes (cost model identical to circom's):
- a 32-bit word is a list of 32 LinComb bits, MSB first; rotations/shifts
  are free index permutations;
- xor costs 1 product per bit pair, ch(e,f,g) = e*(f-g)+g costs 1,
  maj costs 2;
- modular additions pack words linearly and pay one (32+k)-bit
  decomposition, keeping only a' and e' decomposed per round.

A jax-free copy of keyless_zk_tpu/circuits/sha256_gadget.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .r1cs import ConstraintSystem, LinComb
from .gadgets import single_one_array
from ..witness.sha256 import _H0, _K

ZERO = LinComb()


def _xor2(cs: ConstraintSystem, a: LinComb, b: LinComb) -> LinComb:
    if not a:
        return b
    if not b:
        return a
    ab = cs.lc(cs.mul(a, b))
    return a + b - ab - ab


def _xor3(cs, a, b, c):
    return _xor2(cs, _xor2(cs, a, b), c)


def _ch(cs, e, f, g):
    # e ? f : g  ==  e*(f-g) + g
    return g + cs.lc(cs.mul(e, f - g))


def _maj(cs, a, b, c):
    t = cs.lc(cs.mul(b, c))
    return t + cs.lc(cs.mul(a, b + c - t - t))


def _rotr(word: list, n: int) -> list:
    return word[-n:] + word[:-n]


def _shr(word: list, n: int) -> list:
    return [ZERO] * n + word[:-n]


def _pack(word: list) -> LinComb:
    """MSB-first bits -> value as a LinComb."""
    acc = LinComb()
    for i, b in enumerate(word):
        acc = acc + b.scale(1 << (31 - i))
    return acc


def _add_mod32(cs: ConstraintSystem, terms: list[LinComb], n_terms_bits: int) -> list:
    """(sum of packed 32-bit values) mod 2^32 -> fresh MSB-first bit word."""
    total = LinComb()
    for t in terms:
        total = total + t
    bits = cs.to_bits(total, 32 + n_terms_bits)  # LSB first
    return [cs.lc(bits[31 - i]) for i in range(32)]


def _sigma0(cs, w):
    return [_xor3(cs, a, b, c) for a, b, c in zip(_rotr(w, 7), _rotr(w, 18), _shr(w, 3))]


def _sigma1(cs, w):
    return [_xor3(cs, a, b, c) for a, b, c in zip(_rotr(w, 17), _rotr(w, 19), _shr(w, 10))]


def _big_sigma0(cs, w):
    return [_xor3(cs, a, b, c) for a, b, c in zip(_rotr(w, 2), _rotr(w, 13), _rotr(w, 22))]


def _big_sigma1(cs, w):
    return [_xor3(cs, a, b, c) for a, b, c in zip(_rotr(w, 6), _rotr(w, 11), _rotr(w, 25))]


def sha256_compression(
    cs: ConstraintSystem, state: list[list], block_bits: list[LinComb]
) -> list[list]:
    """One compression: state is 8 words, block_bits 512 bits (MSB-first
    big-endian — bit j of byte i at block_bits[8*i + j])."""
    assert len(state) == 8 and len(block_bits) == 512

    w = [block_bits[32 * t : 32 * (t + 1)] for t in range(16)]
    for t in range(16, 64):
        w.append(
            _add_mod32(
                cs,
                [
                    _pack(_sigma1(cs, w[t - 2])),
                    _pack(w[t - 7]),
                    _pack(_sigma0(cs, w[t - 15])),
                    _pack(w[t - 16]),
                ],
                2,
            )
        )

    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = (
            _pack(h)
            + _pack(_big_sigma1(cs, e))
            + _pack([_ch(cs, eb, fb, gb) for eb, fb, gb in zip(e, f, g)])
            + LinComb({0: int(_K[t])})
            + _pack(w[t])
        )
        t2 = _pack(_big_sigma0(cs, a)) + _pack(
            [_maj(cs, ab, bb, cb) for ab, bb, cb in zip(a, b, c)]
        )
        new_e = _add_mod32(cs, [_pack(d), t1], 3)
        new_a = _add_mod32(cs, [t1, t2], 3)
        a, b, c, d, e, f, g, h = new_a, a, b, c, new_e, e, f, g

    out = []
    for init, word in zip(state, (a, b, c, d, e, f, g, h)):
        out.append(_add_mod32(cs, [_pack(init), _pack(word)], 1))
    return out


def initial_state(cs: ConstraintSystem) -> list[list]:
    """H0 constants as constant-bit words."""
    state = []
    for hv in _H0:
        word = [
            LinComb({0: (int(hv) >> (31 - i)) & 1}) if (int(hv) >> (31 - i)) & 1 else ZERO
            for i in range(32)
        ]
        state.append(word)
    return state


def sha256_prepadded(
    cs: ConstraintSystem,
    in_bits: list[LinComb],
    t_block: LinComb,
    max_blocks: int,
) -> list[LinComb]:
    """Digest (256 MSB-first bit LinCombs) after block index `t_block`.

    Matches SHA2_256_Prepadded_Hash: all max_blocks compressions run; the
    output is the one-hot mux of the per-block digests at t_block.
    """
    assert len(in_bits) == 512 * max_blocks
    state = initial_state(cs)
    digests = []
    for i in range(max_blocks):
        state = sha256_compression(cs, state, in_bits[512 * i : 512 * (i + 1)])
        digests.append([bit for word in state for bit in word])

    hot = single_one_array(cs, t_block, max_blocks)
    out = []
    for k in range(256):
        acc = LinComb()
        for i in range(max_blocks):
            acc = acc + cs.lc(cs.mul(cs.lc(hot[i]), digests[i][k]))
        out.append(acc)
    return out


def bytes_to_bits(cs: ConstraintSystem, byte_wires: list[int]) -> list[LinComb]:
    """Byte wires -> MSB-first bit LinCombs with range checks
    (Bytes2BigEndianBits semantics)."""
    bits = []
    for w in byte_wires:
        b = cs.to_bits(cs.lc(w), 8)  # LSB first
        bits.extend(cs.lc(b[7 - j]) for j in range(8))
    return bits
