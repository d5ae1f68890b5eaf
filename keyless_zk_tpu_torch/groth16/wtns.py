"""Witness file (.wtns) parser.

Format per the reference reader (rust-rapidsnark/rapidsnark/src/
wtns_utils.hpp:11-48): section 1 = { u32 n8, prime (n8 bytes), u32 nVars };
section 2 = nVars standard-form little-endian field elements.

A jax-free copy of keyless_zk_tpu/groth16/wtns.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..fields.limbs import bytes_le_to_limbs
from .binfile import BinFile, le_bytes_to_int


@dataclass
class Witness:
    n8: int
    prime: int
    n_vars: int
    values: np.ndarray  # (nVars, 16) uint32 limbs, standard form


def load_wtns(path: str) -> Witness:
    bf = BinFile.load(path, "wtns")
    s1 = bf.section(1)
    (n8,) = struct.unpack_from("<I", s1, 0)
    prime = le_bytes_to_int(s1[4 : 4 + n8])
    (n_vars,) = struct.unpack_from("<I", s1, 4 + n8)
    s2 = bf.section(2)
    values = bytes_le_to_limbs(s2[: n_vars * n8], n8)
    return Witness(n8=n8, prime=prime, n_vars=n_vars, values=values)


def witness_from_ints(values: list[int], prime: int) -> Witness:
    """Build a Witness from standard-form host ints (native witgen path)."""
    from ..fields.limbs import ints_to_limbs

    return Witness(
        n8=32, prime=prime, n_vars=len(values), values=ints_to_limbs(values)
    )


def save_wtns(path: str, wtns: Witness) -> None:
    """Write the snarkjs .wtns container (for interop/debug round-trips)."""
    from ..fields.limbs import limbs_to_bytes_le

    body1 = struct.pack("<I", wtns.n8) + wtns.prime.to_bytes(wtns.n8, "little")
    body1 += struct.pack("<I", wtns.n_vars)
    body2 = limbs_to_bytes_le(wtns.values)
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(body1)) + body1)
        f.write(struct.pack("<IQ", 2, len(body2)) + body2)
