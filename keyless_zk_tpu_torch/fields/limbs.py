"""Limb encoding for 254-bit field elements (host side, numpy).

A field element is a little-endian vector of 16 limbs of 16 bits. This is
the layout of the JAX package (keyless_zk_tpu/fields/limbs.py), kept at
every public function of the port so that the two compare directly; the
port holds the limbs as int32 tensors (fields/torch_field.py) and its CUDA
kernels pack them into 8 x 32-bit words in registers.

This is a jax-free copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
ELEM_BITS = LIMB_BITS * NUM_LIMBS  # 256


def int_to_limbs(x: int, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    """Encode a non-negative int as little-endian 16-bit limbs in uint32."""
    if x < 0 or x >= (1 << (LIMB_BITS * num_limbs)):
        raise ValueError(f"value out of range for {num_limbs} limbs")
    out = np.empty((num_limbs,), dtype=np.uint32)
    for i in range(num_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs: np.ndarray) -> int:
    """Decode little-endian limbs (any ndarray of ints) into a python int."""
    x = 0
    for i in reversed(range(limbs.shape[-1])):
        x = (x << LIMB_BITS) | int(limbs[..., i])
    return x


def ints_to_limbs(xs, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    """Vector encode: list of ints -> (n, num_limbs) uint32."""
    xs = list(xs)
    nbytes = 2 * num_limbs
    try:
        buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    except OverflowError:
        raise ValueError(f"value out of range for {num_limbs} limbs") from None
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), num_limbs).astype(np.uint32)


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    """Vector decode: (..., num_limbs) -> flat list of ints (C order)."""
    arr = np.asarray(arr)
    if arr.size and arr.min() >= 0 and arr.max() <= LIMB_MASK:
        # canonical 16-bit limbs are little-endian uint16 records: one
        # int.from_bytes per element instead of a bigint dot product
        rec = 2 * arr.shape[-1]
        buf = np.ascontiguousarray(arr.astype(np.uint16)).tobytes()
        return [int.from_bytes(buf[i : i + rec], "little") for i in range(0, len(buf), rec)]
    flat = arr.reshape(-1, arr.shape[-1]).astype(object)
    weights = np.array([1 << (LIMB_BITS * i) for i in range(arr.shape[-1])], dtype=object)
    return list(flat @ weights)


def bytes_le_to_limbs(buf: bytes | np.ndarray, n_bytes_per_elem: int = 32) -> np.ndarray:
    """Bulk convert little-endian fixed-width byte records to limb arrays.

    This is the host-side fast path for zkey/wtns ingestion (each record is an
    n8=32-byte LE integer, see reference zkey_utils.hpp:62-70): vectorized as
    a uint8 -> uint16-pair view, no per-element python loop.
    """
    raw = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) else buf
    assert raw.size % n_bytes_per_elem == 0
    n = raw.size // n_bytes_per_elem
    # LE byte pairs are exactly LE uint16 limbs: reinterpret, then widen via
    # np.add into a preallocated buffer (avoids numpy's slow strided astype).
    v16 = np.ascontiguousarray(raw).view(np.uint16).reshape(n, n_bytes_per_elem // 2)
    out = np.empty(v16.shape, dtype=np.uint32)
    np.add(v16, np.uint32(0), out=out, casting="unsafe")
    return out


def limbs_to_bytes_le(arr: np.ndarray) -> bytes:
    """Inverse of bytes_le_to_limbs for (n, L) uint32 limb arrays.

    Narrowing via np.add into uint16 then reinterpreting as LE bytes.
    """
    arr = np.asarray(arr, dtype=np.uint32)
    out16 = np.empty(arr.shape, dtype=np.uint16)
    np.add(arr, np.uint16(0), out=out16, casting="unsafe")
    return out16.tobytes()
