"""Equal proofs: the port's prove(w, r, s) and the JAX package's on the same
key, witness, r and s (the JAX side compiles its G1 and G2 MSMs on
XLA:CPU, which is why this sits in a file of its own)."""

import torch

from keyless_zk_tpu.groth16.prover import Groth16Prover as JaxProver
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key
from test_torch_prover import native_setup

torch.set_num_threads(1)


def test_prove_equals_jax_proof():
    res, wit, _ = native_setup()
    want = JaxProver(res.pk).prove(wit, r=7, s=8)
    got = Groth16Prover(from_jax_proving_key(res.pk)).prove(wit, r=7, s=8)
    assert (got.pi_a, got.pi_b, got.pi_c) == (want.pi_a, want.pi_b, want.pi_c)
    assert got.to_json_dict() == want.to_json_dict()
