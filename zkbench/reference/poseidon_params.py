"""Poseidon-BN254 parameter generation (Grain LFSR, circomlib-compatible).

The reference stack hashes with circomlib's Poseidon everywhere — in-circuit
(circuit/templates/stdlib + circomlib's poseidon.circom) and host-side via
aptos-crypto's poseidon_bn254 (used by e.g. prover-service training_wheels.rs
compute_nonce and public_inputs_hash.rs). Both take their round constants and
MDS matrix from the Poseidon authors' deterministic Grain-LFSR script
(generate_parameters_grain.sage) instantiated for GF(r_BN254), x^5 s-box,
n=254, R_F=8, and circomlib's per-width partial-round table.

We regenerate those parameters here rather than shipping a constants blob;
tests pin the outputs against circomlib's published test vectors, so a
generation mismatch cannot hide.

A frozen copy of keyless_zk_tpu_torch/hashes/poseidon_params.py for the
benchmark's reference: it imports nothing of the program.
"""

from __future__ import annotations

import functools

from . import bn254

P = bn254.R_SCALAR

N_BITS = 254
R_F = 8
# circomlib N_ROUNDS_P for t = 2..17 (poseidon.circom / poseidon_constants)
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
MAX_T = len(N_ROUNDS_P) + 1


class _Grain:
    """The 80-bit Grain LFSR from the Poseidon reference scripts."""

    def __init__(self, t: int, r_p: int):
        bits = []
        for value, width in (
            (1, 2),  # field = prime
            (0, 4),  # s-box = x^alpha
            (N_BITS, 12),
            (t, 12),
            (R_F, 10),
            (r_p, 10),
        ):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def bit(self) -> int:
        # evaluate in pairs: first bit gates, second bit is the output
        while True:
            b1 = self._update()
            b2 = self._update()
            if b1:
                return b2

    def field_element(self) -> int:
        while True:
            v = 0
            for _ in range(N_BITS):
                v = (v << 1) | self.bit()
            if v < P:
                return v

    def field_element_unrejected(self) -> int:
        v = 0
        for _ in range(N_BITS):
            v = (v << 1) | self.bit()
        return v % P


@functools.lru_cache(maxsize=MAX_T)
def poseidon_params(t: int) -> tuple[tuple[int, ...], tuple[tuple[int, ...], ...]]:
    """(round_constants, mds) for state width t (t-1 hash inputs).

    round_constants has (R_F + R_P) * t entries in application order;
    mds is a t x t Cauchy matrix 1/(x_i + y_j).
    """
    if not 2 <= t <= MAX_T:
        raise ValueError(f"poseidon width {t} out of range [2, {MAX_T}]")
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(t, r_p)
    constants = tuple(g.field_element() for _ in range((R_F + r_p) * t))
    # the matrix continues the same stream; samples are reduced, not rejected
    xs = [g.field_element_unrejected() for _ in range(t)]
    ys = [g.field_element_unrejected() for _ in range(t)]
    mds = tuple(
        tuple(pow((xs[i] + ys[j]) % P, -1, P) for j in range(t)) for i in range(t)
    )
    return constants, mds


def n_rounds_partial(t: int) -> int:
    return N_ROUNDS_P[t - 2]
