"""BCS serialization of the aptos-types keyless signing structures.

The reference signs a BCS-serialized `Groth16ProofAndStatement`
(prover-service/src/request_handler/training_wheels.rs:155-169) with the
aptos-crypto convention: the Ed25519 message is

    sha3_256(b"APTOS::" || <serde type name>) || bcs(value)

(aptos-crypto `signing_message` + the CryptoHasher derive's
`DefaultHasher::prefixed_hash` seed). The structures (from
aptos-types/src/keyless, pulled in by the reference via its aptos-types
dependency) are:

    Groth16ProofAndStatement { proof: Groth16Proof, public_inputs_hash: [u8; 32] }
    Groth16Proof { a: G1Bytes, b: G2Bytes, c: G1Bytes }
    G1Bytes([u8; 32])   # ark-serialize compressed G1 (x LE + flag bits)
    G2Bytes([u8; 64])   # ark-serialize compressed G2 (x.c0 LE || x.c1 LE + flags)

BCS encodes fixed-size byte arrays raw (no length prefix), so the message
body is exactly 32 + 64 + 32 + 32 = 160 bytes. `public_inputs_hash` is the
Fr value's 32 little-endian bytes (keyless-common/src/types.rs:25-41
PoseidonHash = Fr.into_bigint().to_bytes_le()).

The response's `training_wheels_signature` field is
bcs(EphemeralSignature::ed25519(sig)) hex-encoded
(prover_handler.rs:434-451): enum variant index 0 as a ULEB128 byte, then
the 64-byte signature with a ULEB128 length prefix (Ed25519Signature
serializes via serialize_bytes).

Point compression (flag bits 0x80 = y lexicographically largest, 0x40 =
infinity) reuses tooling/onchain_vk.py, whose G2 encoding is pinned against
the documented on-chain example hex (keyless-common/src/types.rs:43-60).

A jax-free copy of keyless_zk_tpu/service/bcs.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import hashlib

from ..tooling.onchain_vk import compress_g1, compress_g2

_HASH_PREFIX = b"APTOS::"


def uleb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def hasher_seed(type_name: str) -> bytes:
    """aptos-crypto CryptoHasher seed: sha3-256 of b"APTOS::" + type name."""
    return hashlib.sha3_256(_HASH_PREFIX + type_name.encode()).digest()


GROTH16_PROOF_AND_STATEMENT_SEED = hasher_seed("Groth16ProofAndStatement")


def _affine_g1(coords) -> tuple | None:
    """snarkjs projective decimal strings [x, y, z] (z in {0,1}) -> affine."""
    x, y, z = (int(c) for c in coords)
    return None if z == 0 else (x, y)


def _affine_g2(coords) -> tuple | None:
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in coords)
    return None if (z0, z1) == (0, 0) else ((x0, x1), (y0, y1))


def groth16_proof_bcs(proof_json: dict) -> bytes:
    """snarkjs proof JSON -> bcs(aptos Groth16Proof) (a || b || c compressed)."""
    a = compress_g1(_affine_g1(proof_json["pi_a"]))
    b = compress_g2(_affine_g2(proof_json["pi_b"]))
    c = compress_g1(_affine_g1(proof_json["pi_c"]))
    return a + b + c


def proof_and_statement_bcs(proof_json: dict, public_inputs_hash: int) -> bytes:
    """bcs(Groth16ProofAndStatement): 160 bytes."""
    return groth16_proof_bcs(proof_json) + (public_inputs_hash % (1 << 256)).to_bytes(
        32, "little"
    )


def proof_and_statement_signing_message(proof_json: dict, public_inputs_hash: int) -> bytes:
    """The exact 192-byte message the training-wheels Ed25519 key signs."""
    return GROTH16_PROOF_AND_STATEMENT_SEED + proof_and_statement_bcs(
        proof_json, public_inputs_hash
    )


def ephemeral_signature_bcs(sig: bytes) -> bytes:
    """bcs(EphemeralSignature::ed25519(sig)): variant 0 + length-prefixed bytes."""
    if len(sig) != 64:
        raise ValueError("ed25519 signature must be 64 bytes")
    return b"\x00" + uleb128(len(sig)) + sig


def ephemeral_signature_from_bcs(blob: bytes) -> bytes:
    """Inverse of ephemeral_signature_bcs (Ed25519 variant only)."""
    if blob[:2] != b"\x00\x40" or len(blob) != 66:
        raise ValueError("not a bcs Ed25519 EphemeralSignature")
    return blob[2:]
