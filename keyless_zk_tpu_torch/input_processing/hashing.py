"""Keyless Poseidon hashing helpers (aptos-crypto poseidon_bn254::keyless).

These reproduce the exact packing/hashing conventions the reference pulls
from the external aptos-crypto crate (used by public_inputs_hash.rs and
training_wheels.rs): 31 bytes packed little-endian per scalar, length
scalars appended, circomlib Poseidon over the result. The end-to-end golden
value (public_inputs_hash.rs:219-222) pins every convention here.

A jax-free copy of keyless_zk_tpu/input_processing/hashing.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from ..hashes.poseidon import poseidon_hash

BYTES_PACKED_PER_SCALAR = 31
LIMBS_PACKED_PER_SCALAR = 3  # 3 x 64-bit limbs = 192 bits per scalar


def pack_bytes_to_one_scalar(chunk: bytes) -> int:
    return int.from_bytes(chunk, "little")


def pad_and_pack_bytes_to_scalars_no_len(data: bytes, max_bytes: int) -> list[int]:
    if len(data) > max_bytes:
        raise ValueError(f"bytes too long: {len(data)} > {max_bytes}")
    padded = data + b"\x00" * (max_bytes - len(data))
    return [
        pack_bytes_to_one_scalar(padded[i : i + BYTES_PACKED_PER_SCALAR])
        for i in range(0, len(padded), BYTES_PACKED_PER_SCALAR)
    ]


def pad_and_pack_bytes_to_scalars_with_len(data: bytes, max_bytes: int) -> list[int]:
    return [*pad_and_pack_bytes_to_scalars_no_len(data, max_bytes), len(data)]


def hash_scalars(scalars: list[int]) -> int:
    return poseidon_hash(scalars)


def pad_and_hash_bytes_with_len(data: bytes, max_bytes: int) -> int:
    return hash_scalars(pad_and_pack_bytes_to_scalars_with_len(data, max_bytes))


def pad_and_hash_string(s: str, max_bytes: int) -> int:
    return pad_and_hash_bytes_with_len(s.encode(), max_bytes)


def rsa_modulus_to_scalar(modulus: int, modulus_bytes: int = 256) -> int:
    """RSA_JWK::to_poseidon_scalar: LE modulus bytes in 24-byte (3x64-bit)
    chunks, plus the byte length; matches the circuit's
    Hash64BitLimbsToFieldWithLen over 32 limbs (keyless.circom pubkey hash).
    """
    le = modulus.to_bytes(modulus_bytes, "little")
    chunk = 8 * LIMBS_PACKED_PER_SCALAR
    scalars = [
        pack_bytes_to_one_scalar(le[i : i + chunk]) for i in range(0, modulus_bytes, chunk)
    ]
    scalars.append(modulus_bytes)
    return hash_scalars(scalars)


def compute_nonce(
    exp_date_secs: int, epk_bytes: bytes, epk_blinder: int, max_epk_scalars: int = 3
) -> int:
    """Nonce = Poseidon(epk scalars, epk len, exp_date, blinder)
    (training_wheels.rs:30-49)."""
    frs = pad_and_pack_bytes_to_scalars_with_len(
        epk_bytes, max_epk_scalars * BYTES_PACKED_PER_SCALAR
    )
    frs.append(exp_date_secs)
    frs.append(epk_blinder)
    return hash_scalars(frs)
