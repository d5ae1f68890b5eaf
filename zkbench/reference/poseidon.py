"""Poseidon-BN254 hash (circomlib-compatible permutation).

Host scalar implementation over Python ints. This is the hash used by the
reference for nonce derivation (prover-service training_wheels.rs:30-49),
the identity commitment (public_inputs_hash.rs:16-48), and the single public
input (public_inputs_hash.rs:89-146); outputs must match aptos-crypto's
poseidon_bn254 bit-for-bit (golden tests pin this).

Evaluation order follows circomlib's poseidon.circom: t = nInputs + 1,
state starts as [0, inputs...]; each round adds constants, applies x^5
(all lanes in full rounds, lane 0 only in partial rounds), then mixes with
the MDS matrix; the digest is state[0] after the final round.

A frozen copy of keyless_zk_tpu_torch/hashes/poseidon.py for the benchmark's
reference: it imports nothing of the program.
"""

from __future__ import annotations

from . import bn254
from .poseidon_params import MAX_T, R_F, n_rounds_partial, poseidon_params

P = bn254.R_SCALAR


def poseidon_permutation(state: list[int]) -> list[int]:
    t = len(state)
    constants, mds = poseidon_params(t)
    r_p = n_rounds_partial(t)
    n_rounds = R_F + r_p
    state = [x % P for x in state]
    for r in range(n_rounds):
        state = [(x + constants[r * t + i]) % P for i, x in enumerate(state)]
        if r < R_F // 2 or r >= R_F // 2 + r_p:
            state = [pow(x, 5, P) for x in state]
        else:
            state[0] = pow(state[0], 5, P)
        state = [
            sum(mds[i][j] * state[j] for j in range(t)) % P for i in range(t)
        ]
    return state


def poseidon_hash(inputs: list[int]) -> int:
    """circomlib Poseidon(nInputs) — up to MAX_T - 1 inputs."""
    if not 1 <= len(inputs) <= MAX_T - 1:
        raise ValueError(f"poseidon arity {len(inputs)} out of range")
    return poseidon_permutation([0] + list(inputs))[0]


def poseidon_bytes_with_len(data: bytes, max_bytes: int) -> int:
    """Hash a byte string with its length, packing 31 bytes per scalar.

    Mirrors aptos-crypto poseidon_bn254::pad_and_hash_bytes_with_len and the
    circuit's HashBytesToFieldWithLen (templates/helpers/hashtofield/
    HashBytesToFieldWithLen.circom:40-68): zero-pad to max_bytes, pack
    little-endian 31-byte chunks into scalars, append the true length.
    """
    if len(data) > max_bytes:
        raise ValueError("data longer than max_bytes")
    padded = data + b"\x00" * (max_bytes - len(data))
    chunks = [
        int.from_bytes(padded[i : i + 31], "little") for i in range(0, len(padded), 31)
    ]
    return poseidon_elems_with_len(chunks, len(data))


def poseidon_elems_with_len(elems: list[int], length: int) -> int:
    """Hash scalars plus a length scalar (HashElemsToField-style tree).

    <= 15 payload elems fit one permutation; larger inputs use the
    hex-ary Merkle reduction of Poseidon(16) the circuit uses
    (templates/helpers/hashtofield/HashElemsToField.circom:25-100).
    """
    return hash_elems([*elems, length])


def hash_elems(elems: list[int]) -> int:
    """Poseidon over any number of scalars via 16-ary tree reduction.

    Matches HashElemsToField exactly for <= 64 elements: chunks of 16 are
    hashed (a singleton tail chunk becomes Poseidon(1), NOT a passthrough —
    HashElemsToField.circom:25-100), then the roots are hashed together.
    """
    elems = list(elems)
    if len(elems) <= MAX_T - 1:
        return poseidon_hash(elems)
    level = elems
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 16):
            nxt.append(poseidon_hash(level[i : i + 16]))
        level = nxt
    return level[0]
