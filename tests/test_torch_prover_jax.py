"""Equal proofs: the port's prove(w, r, s) and the JAX package's on the same
key, witness, r and s (the JAX side compiles its G1 and G2 MSMs on
XLA:CPU, which is why this sits in a file of its own): under the JAX
package's setup, and under the port's setup of the same circuit, built with
the port's ConstraintSystem (its host path; test_torch_setup.py holds the
batched ladder path equal to the JAX setup)."""

import torch

from keyless_zk_tpu.groth16.prover import Groth16Prover as JaxProver
from keyless_zk_tpu.groth16.zkey import G1Table as JaxG1Table
from keyless_zk_tpu.groth16.zkey import G2Table as JaxG2Table
from keyless_zk_tpu.groth16.zkey import ProvingKey as JaxProvingKey
from keyless_zk_tpu_torch.circuits import ConstraintSystem, groth16_setup, r1cs_from_cs
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key, verify_groth16
from test_torch_prover import native_setup

torch.set_num_threads(1)


def test_prove_equals_jax_proof():
    res, wit, _ = native_setup()
    want = JaxProver(res.pk).prove(wit, r=7, s=8)
    got = Groth16Prover(from_jax_proving_key(res.pk), device="cpu").prove(wit, r=7, s=8)
    assert (got.pi_a, got.pi_b, got.pi_c) == (want.pi_a, want.pi_b, want.pi_c)
    assert got.to_json_dict() == want.to_json_dict()


def _jax_key(pk):
    """The port's ProvingKey as the JAX package's dataclass (same fields)."""
    tables = {
        name: (JaxG2Table if name == "points_b2" else JaxG1Table)(t.x, t.y, t.inf)
        for name in ("points_a", "points_b1", "points_b2", "points_c", "points_h")
        for t in [getattr(pk, name)]
    }
    scalars = {k: getattr(pk, k) for k in (
        "n8q", "n8r", "q", "r", "n_vars", "n_public", "domain_size", "n_coefs", "vk_alpha1", "vk_beta1",
        "vk_beta2", "vk_gamma2", "vk_delta1", "vk_delta2", "coef_m", "coef_c", "coef_s", "coef_val")}
    return JaxProvingKey(**scalars, **tables)


def test_proof_under_port_setup_equals_jax_proof():
    """native_setup's circuit (a == b^3 + b + 5) through the port's
    ConstraintSystem and setup: the port's proof under that key equals the
    JAX prover's and verifies under the port's pairing."""
    cs = ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    b2 = cs.mul(cs.lc(b), cs.lc(b))
    b3 = cs.mul(cs.lc(b2), cs.lc(b))
    cs.constrain_eq(cs.lc(b3) + cs.lc(b) + cs.const(5), cs.lc(a))
    w = cs.compute_witness(a=3**3 + 3 + 5, b=3)
    res = groth16_setup(r1cs_from_cs(cs), toxic={"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6},
                        device="cpu")
    wit = cs.witness_np(w)
    got = Groth16Prover(res.pk, device="cpu").prove(wit, r=7, s=8)
    want = JaxProver(_jax_key(res.pk)).prove(wit, r=7, s=8)
    assert (got.pi_a, got.pi_b, got.pi_c) == (want.pi_a, want.pi_b, want.pi_c)
    assert got.to_json_dict() == want.to_json_dict()
    assert verify_groth16(res.vk, [w[a]], got.to_json_dict())
