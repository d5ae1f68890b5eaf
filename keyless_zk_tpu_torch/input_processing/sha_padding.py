"""SHA2-256 message padding (RFC 4634 §4.1) for the in-circuit hash.

Mirror of keyless-common/src/input_processing/sha.rs:24-62; validated
against the reference's 896-byte golden vector.

A jax-free copy of keyless_zk_tpu/input_processing/sha_padding.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations


def jwt_bit_len_binary(msg: bytes) -> bytes:
    """64-bit big-endian bit-length (sha.rs:15-18)."""
    return (len(msg) * 8).to_bytes(8, "big")


def compute_sha_padding(msg: bytes, with_length: bool) -> bytes:
    """The padding bytes only: 0x80, zero bytes, optional 64-bit length."""
    bit_len = len(msg) * 8
    k = (448 - bit_len - 1) % 512
    pad_bits = "1" + "0" * k
    assert len(pad_bits) % 8 == 0
    out = int(pad_bits, 2).to_bytes(len(pad_bits) // 8, "big")
    if with_length:
        out += jwt_bit_len_binary(msg)
    return out


def with_sha_padding_bytes(msg: bytes) -> bytes:
    """msg plus its full SHA-256 padding (sha.rs:58-62)."""
    return msg + compute_sha_padding(msg, with_length=True)
