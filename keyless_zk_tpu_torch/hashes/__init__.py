"""Hash primitives: circomlib-compatible Poseidon-BN254 (host + params).

A jax-free copy of keyless_zk_tpu/hashes/__init__.py: the port imports nothing
of the JAX package."""

from .poseidon import hash_elems, poseidon_hash, poseidon_permutation

__all__ = ["hash_elems", "poseidon_hash", "poseidon_permutation"]
