"""Point encodings and the training-wheels message, written from the
formats themselves.

ark-serialize compressed points (x little-endian; in the top byte 0x80 =
y lexicographically largest, 0x40 = the point at infinity), as the
service's response carries them; and the Ed25519 message the
training-wheels key signs over a proof and its statement:

    sha3_256(b"APTOS::Groth16ProofAndStatement") || a || b || c || hash

with a, b, c compressed (32 + 64 + 32 bytes) and the public-inputs hash
as 32 little-endian bytes. The response's signature field is
bcs(EphemeralSignature::ed25519(sig)): b"\\x00\\x40" then the 64 bytes.
"""

from __future__ import annotations

import hashlib

from . import bn254
from .curve import B2, fq2_add, fq2_mul

Q = bn254.Q
FLAG_INFINITY = 0x40
FLAG_Y_LARGEST = 0x80
PROOF_AND_STATEMENT_SEED = hashlib.sha3_256(b"APTOS::Groth16ProofAndStatement").digest()


def _y_largest_fq(y: int) -> bool:
    return y > Q - y


def _y_largest_fq2(y) -> bool:
    ny = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    return (y[1], y[0]) > (ny[1], ny[0])


def _sqrt_fq(a: int):
    r = pow(a, (Q + 1) // 4, Q)  # q = 3 mod 4
    return r if r * r % Q == a % Q else None


def _sqrt_fq2(a):
    a0, a1 = a
    if a1 == 0:
        r = _sqrt_fq(a0)
        if r is not None:
            return (r, 0)
        t = _sqrt_fq((-a0) % Q)
        return None if t is None else (0, t)
    n = _sqrt_fq((a0 * a0 + a1 * a1) % Q)
    if n is None:
        return None
    half = pow(2, -1, Q)
    for sign in (1, Q - 1):
        r0 = _sqrt_fq((a0 + sign * n) * half % Q)
        if r0 is None or r0 == 0:
            continue
        r1 = a1 * pow(2 * r0 % Q, -1, Q) % Q
        if ((r0 * r0 - r1 * r1) % Q, 2 * r0 * r1 % Q) == (a0 % Q, a1 % Q):
            return (r0, r1)
    return None


def decompress_g1(buf: bytes):
    """32 bytes -> affine (x, y), or None at infinity; ValueError if the
    bytes are no point."""
    if len(buf) != 32:
        raise ValueError("a compressed G1 point has 32 bytes")
    b = bytearray(buf)
    flags = b[-1] & 0xC0
    b[-1] &= 0x3F
    if flags & FLAG_INFINITY:
        return None
    x = int.from_bytes(bytes(b), "little")
    if x >= Q:
        raise ValueError("G1 x is not reduced")
    y = _sqrt_fq((pow(x, 3, Q) + bn254.CURVE_B) % Q)
    if y is None:
        raise ValueError("no G1 point has this x")
    if _y_largest_fq(y) != bool(flags & FLAG_Y_LARGEST):
        y = Q - y
    return (x, y)


def decompress_g2(buf: bytes):
    """64 bytes -> affine ((x0, x1), (y0, y1)), or None at infinity."""
    if len(buf) != 64:
        raise ValueError("a compressed G2 point has 64 bytes")
    b = bytearray(buf)
    flags = b[-1] & 0xC0
    b[-1] &= 0x3F
    if flags & FLAG_INFINITY:
        return None
    x = (int.from_bytes(bytes(b[:32]), "little"), int.from_bytes(bytes(b[32:]), "little"))
    if max(x) >= Q:
        raise ValueError("G2 x is not reduced")
    y = _sqrt_fq2(fq2_add(fq2_mul(fq2_mul(x, x), x), B2))
    if y is None:
        raise ValueError("no G2 point has this x")
    if _y_largest_fq2(y) != bool(flags & FLAG_Y_LARGEST):
        y = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    return (x, y)


def proof_json(a, b, c) -> dict:
    """Affine points -> the snarkjs proof dict the pairing check reads."""
    return {
        "pi_a": [str(a[0]), str(a[1]), "1"],
        "pi_b": [[str(b[0][0]), str(b[0][1])], [str(b[1][0]), str(b[1][1])], ["1", "0"]],
        "pi_c": [str(c[0]), str(c[1]), "1"],
    }


def signing_message(a_bytes: bytes, b_bytes: bytes, c_bytes: bytes, public_inputs_hash: int) -> bytes:
    return PROOF_AND_STATEMENT_SEED + a_bytes + b_bytes + c_bytes + public_inputs_hash.to_bytes(32, "little")


def signature_from_bcs(blob: bytes) -> bytes:
    if len(blob) != 66 or blob[:2] != b"\x00\x40":
        raise ValueError("not a bcs Ed25519 EphemeralSignature")
    return blob[2:]
