"""The port's key setup path against the JAX package's, on the chain circuit
a == b^m at domain 2^5 (the circuit chip_smoke.py sets up at 2^21):

- the port's ConstraintSystem gives the JAX one's constraints and witness;
- the port's `groth16_setup` on the CPU with `device_threshold=0`, so that
  every table runs the batched fixed-base ladder through K3's plain
  versions, equals the JAX `groth16_setup` (its host path) array by array,
  and its vk dict is equal;
- a port proof under that key verifies under the port's pairing and the JAX
  package's, and a tampered one fails both."""

import dataclasses

import numpy as np
import pytest
import torch

from keyless_zk_tpu.circuits import ConstraintSystem as JaxCS
from keyless_zk_tpu.circuits import groth16_setup as jax_setup
from keyless_zk_tpu.circuits.r1cs_file import r1cs_from_cs as jax_r1cs_from_cs
from keyless_zk_tpu.groth16 import verify_groth16 as jax_verify
from keyless_zk_tpu_torch.circuits import ConstraintSystem, LinComb, groth16_setup, r1cs_from_cs
from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.groth16 import Groth16Prover, verify_groth16

torch.set_num_threads(1)

DOMAIN_POW = 5
TOXIC = {"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6}


def chain(cs_cls, domain_pow: int):
    """a == b^m, m = 2^domain_pow - 4, built as __graft_entry__._chain_setup
    builds it: (cs, witness, public wire)."""
    m = (1 << domain_pow) - 4
    cs = cs_cls()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    x = b
    for _ in range(m - 1):
        x = cs.mul(cs.lc(x), cs.lc(b))
    cs.constrain_eq(cs.lc(x), cs.lc(a))
    w = cs.compute_witness(a=pow(3, m, bn254.R_SCALAR), b=3)
    return cs, w, a


@pytest.fixture(scope="module")
def setups():
    cs, w, a = chain(ConstraintSystem, DOMAIN_POW)
    jcs, _, _ = chain(JaxCS, DOMAIN_POW)
    mine = groth16_setup(r1cs_from_cs(cs), toxic=TOXIC, device_threshold=0, device="cpu")
    theirs = jax_setup(jax_r1cs_from_cs(jcs), toxic=TOXIC)
    return cs, w, a, mine, theirs


def test_constraint_system_matches_jax():
    cs, w, a = chain(ConstraintSystem, DOMAIN_POW)
    jcs, jw, ja = chain(JaxCS, DOMAIN_POW)
    assert (cs.n_wires, cs.n_public, a) == (jcs.n_wires, jcs.n_public, ja)
    assert w == jw
    assert cs.check_witness(w) is None and jcs.check_witness(jw) is None
    assert [tuple(map(dict, m)) for m in zip(*cs.matrices())] == [tuple(map(dict, m)) for m in zip(*jcs.matrices())]
    assert np.array_equal(cs.witness_np(w), jcs.witness_np(jw))
    bad = list(w)
    bad[5] = (bad[5] + 1) % bn254.R_SCALAR
    assert cs.check_witness(bad) == jcs.check_witness(bad) is not None
    r, jr = r1cs_from_cs(cs), jax_r1cs_from_cs(jcs)
    assert (r.n_wires, r.n_public, r.n_constraints, r.A, r.B, r.C) == (
        jr.n_wires, jr.n_public, jr.n_constraints, jr.A, jr.B, jr.C)
    lc = cs.lc((2, 5), (3, 7)) - cs.lc((2, 5))
    assert isinstance(lc, LinComb) and dict(lc) == {3: 7}


def test_setup_matches_jax_array_by_array(setups):
    _, _, _, mine, theirs = setups
    for f in dataclasses.fields(mine.pk):
        got, want = getattr(mine.pk, f.name), getattr(theirs.pk, f.name)
        if f.name.startswith("points_"):
            for part in ("x", "y", "inf"):
                g, w_ = getattr(got, part), getattr(want, part)
                assert g.shape == np.asarray(w_).shape, (f.name, part)
                assert np.array_equal(g, np.asarray(w_)), (f.name, part)
        elif isinstance(got, np.ndarray):
            assert np.array_equal(got, np.asarray(want)), f.name
        elif f.name != "vk_ic":
            assert got == want, f.name
    assert mine.vk == theirs.vk
    assert mine.toxic == theirs.toxic
    assert set(mine.seconds) == {"host", "device"}


def test_proof_verifies_under_both_verifiers(setups):
    cs, w, a, mine, _ = setups
    proof = Groth16Prover(mine.pk, device="cpu").prove(cs.witness_np(w), r=7, s=8).to_json_dict()
    pub = [w[a]]
    assert verify_groth16(mine.vk, pub, proof)
    assert jax_verify(mine.vk, pub, proof)
    bad_pub = [pub[0] + 1]
    assert not verify_groth16(mine.vk, bad_pub, proof)
    assert not jax_verify(mine.vk, bad_pub, proof)
    tampered = dict(proof, pi_c=[str(int(proof["pi_c"][0]) + 1), *proof["pi_c"][1:]])
    assert not verify_groth16(mine.vk, pub, tampered)
    assert not jax_verify(mine.vk, pub, tampered)
