"""SHA-256 compression over pre-padded input.

The circuit hashes the JWT with SHA2_256_Prepadded_Hash (circuit/templates/
helpers/sha/SHA2_256_Prepadded_Hash.circom:14-84): the message arrives
already padded and the number of compression blocks is an input signal.
This module provides the same pre-padded entry point for witness
generation and for validating our padding code against hashlib.

A jax-free copy of keyless_zk_tpu/witness/sha256.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint64,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint64,
)

_M32 = np.uint64(0xFFFFFFFF)


def _rotr(x, n):
    return ((x >> np.uint64(n)) | (x << np.uint64(32 - n))) & _M32


def compress_block(state: np.ndarray, block: bytes) -> np.ndarray:
    w = np.zeros(64, dtype=np.uint64)
    w[:16] = np.frombuffer(block, dtype=">u4").astype(np.uint64)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> np.uint64(3))
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> np.uint64(10))
        w[t] = (w[t - 16] + s0 + w[t - 7] + s1) & _M32
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[t] + w[t]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return (state + np.array([a, b, c, d, e, f, g, h], dtype=np.uint64)) & _M32


def sha256_of_prepadded(blocks: bytes, num_blocks: int | None = None) -> bytes:
    """Digest of an already-padded message (len multiple of 64)."""
    assert len(blocks) % 64 == 0
    n = len(blocks) // 64 if num_blocks is None else num_blocks
    state = _H0.copy()
    for i in range(n):
        state = compress_block(state, blocks[64 * i : 64 * (i + 1)])
    return b"".join(int(x).to_bytes(4, "big") for x in state)
