"""The proof's blinding in native code (groth16/prover.py `blind`, through
native/bn254_pairing.c `bn254_groth16_blind`) against its host-int body
`blind_plain` and the JAX package's proof:

- G1 and G2 scalar multiplication of seeded random points
  (testgen.random_points) by 0, 1, 2, R - 1 and a random k, and of the
  point at infinity, equal to curves/ref_curve.py's;
- `blind` on seeded points and on planted cases (C or H at infinity,
  A == -alpha1 so that their sum is infinity, s pi_a == C + H so that an
  add doubles, r or s or both 0) equal to `blind_plain`;
- the port's proof under the JAX package's setup, blinded natively at fixed
  r and s, equal to the JAX package's proof;
- a keyless-shaped proof (testgen.synthetic_key) through BatchProver, r and
  s drawn from a fixed sequence, equal to `blind_plain` on the same points
  and to the key's discrete-log oracle;
- without the native library (a failed build) `blind` and the prover's
  construction raise, and the service's WARN line says that no proof can
  be blinded."""

import random
import subprocess
import types

import pytest
import torch

from keyless_zk_tpu.groth16.prover import Groth16Prover as JaxProver
from keyless_zk_tpu_torch.curves import ref_curve
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE
from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key
from keyless_zk_tpu_torch.groth16 import pairing_native as pn
from keyless_zk_tpu_torch.groth16 import prover
from keyless_zk_tpu_torch.ops import testgen
from keyless_zk_tpu_torch.parallel import batch_prover
from keyless_zk_tpu_torch.service import metrics
from keyless_zk_tpu_torch.service.prover_state import ProverServiceState
from test_torch_prover import native_setup
from torch_keyless_fixtures import SMALL

torch.set_num_threads(1)

R = bn254.R_SCALAR
G1, G2 = ref_curve.G1, ref_curve.G2


def _host_points(n: int, seed: int, curve) -> list:
    x, y, inf = testgen.random_points(n, seed=seed, curve=curve, device="cpu")
    return curve.decode_jacobian(curve.from_affine(x, y, inf))


@pytest.fixture(scope="module")
def points():
    assert pn.available(), pn.build_error()
    return {"g1": _host_points(10, 3, G1_CURVE), "g2": _host_points(4, 4, G2_CURVE)}


@pytest.mark.parametrize("k", [0, 1, 2, R - 1, "random"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_equals_the_host_law(points, group, k):
    law, native = (G1, pn.g1_mul) if group == "g1" else (G2, pn.g2_mul)
    rng = random.Random(11)
    for p in points[group][:3]:
        kk = rng.randrange(R) if k == "random" else k
        assert native(p, kk) == law.mul(p, kk)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_mul_of_infinity_is_infinity(group):
    native = pn.g1_mul if group == "g1" else pn.g2_mul
    assert native(None, 0) is None and native(None, 5) is None and native(None, R - 1) is None


def _key(g1, g2):
    return types.SimpleNamespace(vk_alpha1=g1[4], vk_beta1=g1[5], vk_delta1=g1[6], vk_beta2=g2[1], vk_delta2=g2[2])


def _planted(case, g1, g2, r, s):
    """(A, B1, B2, C, H, r, s) of a planted case on the seeded points."""
    pk = _key(g1, g2)
    a, b1, c, h, b2 = g1[0], g1[1], g1[2], g1[3], g2[0]
    if case == "c_at_infinity":
        c = None
    elif case == "h_at_infinity":
        h = None
    elif case == "c_and_h_at_infinity":
        c = h = None
    elif case == "a_is_minus_alpha1":
        a = G1.neg(pk.vk_alpha1)
    elif case == "s_pi_a_is_c_plus_h":
        pi_a = G1.add(G1.add(a, pk.vk_alpha1), G1.mul(pk.vk_delta1, r))
        c = G1.add(G1.mul(pi_a, s), G1.neg(h))
    elif case == "r_zero":
        r = 0
    elif case == "s_zero":
        s = 0
    elif case == "r_and_s_zero":
        r = s = 0
    elif case == "r_and_s_are_r_minus_1":
        r = s = R - 1
    return a, b1, b2, c, h, r, s


@pytest.mark.parametrize("case", ["seeded", "c_at_infinity", "h_at_infinity", "c_and_h_at_infinity",
                                  "a_is_minus_alpha1", "s_pi_a_is_c_plus_h", "r_zero", "s_zero", "r_and_s_zero",
                                  "r_and_s_are_r_minus_1"])
def test_blind_equals_blind_plain(points, case):
    rng = random.Random(case)
    a, b1, b2, c, h, r, s = _planted(case, points["g1"], points["g2"], rng.randrange(R), rng.randrange(R))
    pk = _key(points["g1"], points["g2"])
    got = prover.blind(pk, a, b1, b2, c, h, r, s)
    want = prover.blind_plain(pk, a, b1, b2, c, h, r, s)
    assert got == want
    if case == "a_is_minus_alpha1":
        assert got.pi_a == G1.mul(pk.vk_delta1, r)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's prover and the port's decoded points (A, B1, B2,
    C, H) of one witness under the JAX package's setup."""
    res, wit, _ = native_setup()
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prover, "blind", lambda pk, *pts: seen.append(pts[:5]) or prover.Proof(None, None, None))
        port = Groth16Prover(from_jax_proving_key(res.pk), device="cpu")
        port.prove(wit)
    return JaxProver(res.pk), port.pk, wit, seen[0]


@pytest.mark.parametrize("r, s", [(7, 8), (0, 8), (7, 0), (0, 0), (R - 1, R - 2)])
def test_native_blinding_equals_the_jax_proof(jax_case, r, s):
    jax_prover, pk, wit, pts = jax_case
    want = jax_prover.prove(wit, r=r, s=s)
    got = prover.blind(pk, *pts, r, s)
    assert (got.pi_a, got.pi_b, got.pi_c) == (want.pi_a, want.pi_b, want.pi_c)


def test_keyless_shaped_batch_proof_equals_blind_plain_and_the_oracle(monkeypatch):
    key = testgen.synthetic_key(2, n_vars=48, n_public=1, domain_pow=5, n_distinct_a=40, n_distinct_b=20,
                                n_coefs=100, device="cpu")
    drawn = [R - 1, 5, 0, 123456789]  # r then s, per proof
    it = iter(drawn)
    monkeypatch.setattr(prover, "_sample_fr", lambda: next(it))
    seen = []
    real = prover.blind
    monkeypatch.setattr(prover, "blind", lambda *a: seen.append(a) or real(*a))
    bp = batch_prover.BatchProver(Groth16Prover(key.pk, device="cpu"), max_batch=2)
    try:
        got = bp.prove_batch([key.witness, key.witness])
    finally:
        bp.shutdown()
    assert len(seen) == 2 and bp.phase_ms["blind"] > 0
    for i, proof in enumerate(got):
        r, s = drawn[2 * i : 2 * i + 2]
        assert seen[i][-2:] == (r, s)
        assert proof == prover.blind_plain(*seen[i])
        want = testgen.expected_proof(key, tf.decode_ints(bp.last_h[i], tf.FR), r, s)
        assert (proof.pi_a, proof.pi_b, proof.pi_c) == want


def _fail_build(monkeypatch):
    """The native library as on a host whose gcc fails."""

    def fail():
        raise subprocess.CalledProcessError(1, ["gcc"], stderr="gcc: not found")

    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_lib_error", None)
    monkeypatch.setattr(pn, "_build_lib", fail)


def test_without_the_library_blind_raises(points, monkeypatch):
    rng = random.Random(5)
    pk = _key(points["g1"], points["g2"])
    args = (points["g1"][0], points["g1"][1], points["g2"][0], points["g1"][2], points["g1"][3],
            rng.randrange(R), rng.randrange(R))
    _fail_build(monkeypatch)
    with pytest.raises(RuntimeError, match="native pairing unavailable"):
        prover.blind(pk, *args)
    assert not pn.available() and "gcc: not found" in pn.build_error()


def test_without_the_library_the_prover_does_not_build(monkeypatch):
    _fail_build(monkeypatch)
    with pytest.raises(RuntimeError, match="native pairing unavailable.*gcc: not found"):
        Groth16Prover(types.SimpleNamespace(q=bn254.Q, r=R), device="cpu")  # refused before the key is read


def test_service_warns_that_no_proof_can_be_blinded(monkeypatch, capsys):
    state = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    assert state.check_pairing_backend() == "native"
    _fail_build(monkeypatch)
    assert state.check_pairing_backend() == "python_fallback"
    err = capsys.readouterr().err
    assert "WARN" in err and "no proof can be blinded" in err and "gcc: not found" in err
    assert metrics.PAIRING_BACKEND._values.get(("python_fallback",), 0) >= 1
