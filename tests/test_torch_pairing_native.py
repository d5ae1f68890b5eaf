"""The port's native pairing (keyless_zk_tpu_torch/native/bn254_pairing.c,
built with gcc into build/pairing/<hash>/) against the port's pure-Python
tower and the JAX package's verifier:

- the product check agrees with the tower on bilinearity products, and a
  full pairing value equals the tower's after the basis change;
- on a valid and a tampered Groth16 statement, native, tower and the JAX
  package's `verify_groth16` give the same verdicts;
- the port's `verify_groth16` takes the native check whenever it is
  available, and the tower otherwise, with the same verdict."""

import random
from pathlib import Path

import pytest

from keyless_zk_tpu.groth16.pairing import verify_groth16 as jax_verify
from keyless_zk_tpu_torch.curves import ref_curve
from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.groth16 import pairing as pp
from keyless_zk_tpu_torch.groth16 import pairing_native as pn
from torch_io_fixtures import scalar_proof

ROOT = Path(__file__).resolve().parent.parent


def test_native_library_builds_into_the_build_directory():
    assert pn.available(), pn.build_error()
    lib = pn._build_lib()
    assert lib.parent.parent == ROOT / "build" / "pairing"
    assert len(lib.parent.name) == 16 and lib.exists()


def test_fq_product_and_pairing_value_match_the_tower():
    rng = random.Random(3)
    for _ in range(50):
        a, b = rng.randrange(bn254.Q), rng.randrange(bn254.Q)
        assert pn.fq_mul_test(a, b) == a * b % bn254.Q
    g1, g2 = ref_curve.G1.mul(ref_curve.G1_GEN, 5), ref_curve.G2.mul(ref_curve.G2_GEN, 7)
    mine = pn.pairing(g1, g2)
    ref = pp.pairing(g2, g1, final_exp=True)
    co = [0] * 12
    for i in range(6):  # w^6 = 9 + u in both towers; the tower stores u = w^6 - 9
        a, b = mine[i]
        co[i] = (a - 9 * b) % bn254.Q
        co[i + 6] = b % bn254.Q
    assert tuple(co) == ref.c


@pytest.mark.parametrize("offset", [0, 1])
def test_bilinearity_products_match_the_tower(offset):
    G1, G2 = ref_curve.G1, ref_curve.G2
    rng = random.Random(7 + offset)
    a, b = rng.randrange(1, 1 << 60), rng.randrange(1, 1 << 60)
    pairs = [(G1.mul(ref_curve.G1_GEN, a), G2.mul(ref_curve.G2_GEN, b)),
             (G1.neg(G1.mul(ref_curve.G1_GEN, a * b + offset)), ref_curve.G2_GEN)]
    want = offset == 0
    assert pn.pairing_check(pairs) is want
    assert pp.pairing_product_is_one(pairs) is want
    assert pn.pairing_check([(None, ref_curve.G2_GEN), (ref_curve.G1_GEN, None)])  # e(O, Q) = 1


@pytest.mark.parametrize("tamper", ["none", "public", "pi_c"])
def test_groth16_verdicts_agree(tamper, monkeypatch):
    vk, proof = scalar_proof(public=123456789)
    public = 123456789 + (tamper == "public")
    if tamper == "pi_c":
        proof = dict(proof, pi_c=proof["pi_a"])
    want = tamper == "none"
    calls = []
    real = pn.pairing_check
    monkeypatch.setattr(pn, "pairing_check", lambda pairs: calls.append(1) or real(pairs))
    assert pp.verify_groth16(vk, [public], proof) is want
    assert calls, "verify_groth16 did not take the native pairing"
    assert jax_verify(vk, [public], proof) is want
    monkeypatch.setattr(pn, "available", lambda: False)
    assert pp.verify_groth16(vk, [public], proof) is want
    assert len(calls) == 1, "verify_groth16 took the native pairing while it was unavailable"
