"""Groth16 proving over BN254 (PyTorch port of keyless_zk_tpu.groth16), with
the snarkjs .zkey and .wtns files and the verifier."""

from .pairing import verify_groth16
from .prover import Groth16Prover, Proof
from .wtns import Witness, load_wtns, save_wtns, witness_from_ints
from .zkey import G1Table, G2Table, ProvingKey, from_jax_proving_key, load_zkey, save_zkey

__all__ = ["Groth16Prover", "Proof", "ProvingKey", "G1Table", "G2Table", "from_jax_proving_key", "load_zkey",
           "save_zkey", "Witness", "load_wtns", "save_wtns", "witness_from_ints", "verify_groth16"]
