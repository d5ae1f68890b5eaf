"""Groth16 proving over BN254 (PyTorch port of keyless_zk_tpu.groth16)."""

from .pairing import verify_groth16
from .prover import Groth16Prover, Proof
from .zkey import G1Table, G2Table, ProvingKey, from_jax_proving_key

__all__ = ["Groth16Prover", "Proof", "ProvingKey", "G1Table", "G2Table", "from_jax_proving_key", "verify_groth16"]
