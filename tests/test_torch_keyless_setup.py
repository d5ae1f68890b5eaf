"""Key setup and a proof on the gadget circuit of keyless_gadget_circuit.py
("setup" size: 509 constraints, domain 2^9, every witness opcode), the
port against the JAX package:

- the port's `groth16_setup(device="cpu")` with pinned toxic values equals
  the JAX package's array by array, and its vk dict is equal;
- a port proof with fixed r and s equals the proof that the toxic values
  determine, computed on the host with the JAX package's curve from the
  R1CS and the witness (A(tau), B(tau), C(tau), the quotient h(tau));
- it verifies under the port's pairing and the JAX package's against the
  public input (the circuit's Poseidon digest), and fails both with the
  public input or a proof coordinate changed.

The JAX prover itself is not run here: its MSMs compile on XLA:CPU for
minutes at this key; tests/test_torch_prover_jax.py holds the port's
proofs equal to it on smaller keys."""

import dataclasses

import numpy as np
import pytest
import torch

import keyless_gadget_circuit as kg
from keyless_zk_tpu.circuits import groth16_setup as jax_setup
from keyless_zk_tpu.circuits.r1cs_file import r1cs_from_cs as jax_r1cs_from_cs
from keyless_zk_tpu.curves import ref_curve as jax_curve
from keyless_zk_tpu.fields import bn254 as jax_bn254
from keyless_zk_tpu.groth16 import verify_groth16 as jax_verify
from keyless_zk_tpu_torch.circuits import groth16_setup, r1cs_from_cs
from keyless_zk_tpu_torch.groth16 import Groth16Prover, verify_groth16
from keyless_zk_tpu_torch.hashes import poseidon_hash

torch.set_num_threads(1)

TOXIC = {"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6}
R_FIXED, S_FIXED = 0x1234567890ABCDEF, 0xFEDCBA0987654321


@pytest.fixture(scope="module")
def setups():
    cs, _ = kg.build("keyless_zk_tpu_torch", "setup")
    jcs, _ = kg.build("keyless_zk_tpu", "setup")
    w = cs.compute_witness(**kg.inputs(poseidon_hash, "setup"))
    assert cs.check_witness(w) is None
    mine = groth16_setup(r1cs_from_cs(cs), toxic=TOXIC, device="cpu")
    theirs = jax_setup(jax_r1cs_from_cs(jcs), toxic=TOXIC)
    return cs, w, mine, theirs


def oracle_proof(r1cs, w, toxic, r, s):
    """The Groth16 proof (pi_a, pi_b, pi_c) that the toxic values, r and s
    determine for witness w, as host affine points: with the public
    binding rows A[m0 + i][i] = 1 (i <= n_public) of the setup,
    a = alpha + A(tau) + r delta, b = beta + B(tau) + s delta,
    c = (sum over private wires of w_i (beta u_i + alpha v_i + w_i(tau))
    + h(tau) Z(tau)) / delta + s a + r b - r s delta."""
    P = jax_bn254.R_SCALAR
    tau, alpha, beta, delta = (toxic[k] for k in ("tau", "alpha", "beta", "delta"))
    m0, npub = r1cs.n_constraints, r1cs.n_public
    n = 1 << max(1, (m0 + npub).bit_length())
    omega = jax_bn254.fr_root_of_unity(n.bit_length() - 1)
    z_tau = (pow(tau, n, P) - 1) % P
    lag = [z_tau * pow(omega, q, P) * pow(n * (tau - pow(omega, q, P)), -1, P) % P for q in range(n)]

    def ev(row):
        return sum(c * w[i] for i, c in row.items()) % P

    a_rows = [ev(row) for row in r1cs.A] + [w[i] for i in range(npub + 1)]
    a_tau, b_tau, c_tau = (sum(x * lag[q] for q, x in enumerate(rows)) % P
                           for rows in (a_rows, [ev(row) for row in r1cs.B], [ev(row) for row in r1cs.C]))
    h_tau = (a_tau * b_tau - c_tau) * pow(z_tau, -1, P) % P
    pub = range(npub + 1)
    u_pub = sum(w[i] * (sum(row.get(i, 0) * lag[q] for q, row in enumerate(r1cs.A)) + lag[m0 + i]) for i in pub)
    v_pub = sum(w[i] * sum(row.get(i, 0) * lag[q] for q, row in enumerate(r1cs.B)) for i in pub)
    w_pub = sum(w[i] * sum(row.get(i, 0) * lag[q] for q, row in enumerate(r1cs.C)) for i in pub)
    private = beta * (a_tau - u_pub) + alpha * (b_tau - v_pub) + (c_tau - w_pub)
    a = (alpha + a_tau + r * delta) % P
    b = (beta + b_tau + s * delta) % P
    c = ((private + h_tau * z_tau) * pow(delta, -1, P) + s * a + r * b - r * s * delta) % P
    g1, g2 = jax_curve.G1, jax_curve.G2
    return g1.mul(jax_curve.G1_GEN, a), g2.mul(jax_curve.G2_GEN, b), g1.mul(jax_curve.G1_GEN, c)


def test_setup_matches_jax_array_by_array(setups):
    _, _, mine, theirs = setups
    assert mine.pk.domain_size == 512
    for f in dataclasses.fields(mine.pk):
        got, want = getattr(mine.pk, f.name), getattr(theirs.pk, f.name)
        if f.name.startswith("points_"):
            for part in ("x", "y", "inf"):
                assert np.array_equal(getattr(got, part), np.asarray(getattr(want, part))), (f.name, part)
        elif isinstance(got, np.ndarray):
            assert np.array_equal(got, np.asarray(want)), f.name
        else:
            assert got == want, f.name
    assert mine.vk == theirs.vk


def test_proof_equals_the_toxic_oracle_and_verifies(setups):
    cs, w, mine, _ = setups
    proof = Groth16Prover(mine.pk, device="cpu").prove(cs.witness_np(w), r=R_FIXED, s=S_FIXED)
    assert (proof.pi_a, proof.pi_b, proof.pi_c) == oracle_proof(r1cs_from_cs(cs), w, TOXIC, R_FIXED, S_FIXED)
    js = proof.to_json_dict()
    pub = [w[1]]
    assert pub == [poseidon_hash([kg.inputs(poseidon_hash, "setup")["a"]])]
    assert verify_groth16(mine.vk, pub, js) and jax_verify(mine.vk, pub, js)
    assert not verify_groth16(mine.vk, [pub[0] + 1], js)
    assert not jax_verify(mine.vk, [pub[0] + 1], js)
    tampered = dict(js, pi_a=[str(int(js["pi_a"][0]) + 1), *js["pi_a"][1:]])
    assert not verify_groth16(mine.vk, pub, tampered)
    assert not jax_verify(mine.vk, pub, tampered)
