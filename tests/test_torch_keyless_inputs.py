"""The port's JWT input processing, Poseidon and test-JWT generator:

- `derive_circuit_input_signals` gives the JAX package's signals and
  public-inputs hash, exactly, on JWTs from the port's generator (sub and
  email uids, an extra field, an aud override, the aud checks skipped)
  and on the reference's golden JWT of tests/test_input_processing.py under
  the default circuit configuration (whose pinned hash it also gives);
- Poseidon gives circomlib's published vectors (tests/test_poseidon.py);
- the generator's RS256 signature verifies under the `cryptography`
  package, a seed always gives the same key and JWT, and two seeds differ."""

import dataclasses

import pytest

from keyless_zk_tpu.hashes.poseidon import poseidon_hash as jax_poseidon_hash
from keyless_zk_tpu.input_processing.circuit_config import default_circuit_config as jax_default_config
from keyless_zk_tpu.input_processing.input_signals import derive_circuit_input_signals as jax_derive
from keyless_zk_tpu_torch.hashes import poseidon_hash
from keyless_zk_tpu_torch.input_processing.circuit_config import default_circuit_config
from keyless_zk_tpu_torch.input_processing.input_signals import derive_circuit_input_signals
from keyless_zk_tpu_torch.input_processing.jwt import b64url_decode
from keyless_zk_tpu_torch.input_processing.public_inputs_hash import compute_public_inputs_hash
from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt, rsa_key
from test_input_processing import _test_verified_input
from torch_keyless_fixtures import jax_verified_input

JWTS = {
    "sub": {},
    "email": {"uid_key": "email", "uid_val": "a@b.io"},
    "extra field": {"extra_field": "family_name", "payload_extras": {"family_name": "Doe"}},
    "aud override": {"idc_aud": "recovery-aud"},
    "skip aud": {"skip_aud_checks": True},
}

# circomlib's poseidon test vectors (tests/test_poseidon.py)
POSEIDON = [
    ([1], 18586133768512220936620570745912940619677854269274689475585506675881198879027),
    ([1, 2], 7853200120776062878684798364095072458815029376092732009249414926327459813530),
    ([1, 2, 3, 4], 18821383157269793795438455681495246036402687001665670618754263018637548127333),
    ([1, 2, 3, 4, 5, 6], 20400040500897583745843009878988256314335038853985262692600694741116813247201),
]
GOLDEN_HASH = 18884813797014402005012488165063359209340898803829594097564044767682806702965


def _port_vi(jax_vi):
    """The JAX package's VerifiedInput as the port's (the same fields)."""
    from keyless_zk_tpu_torch.input_processing.jwt import DecodedJWT, JwtParts
    from keyless_zk_tpu_torch.input_processing.types import VerifiedInput

    fields = {f.name: getattr(jax_vi, f.name) for f in dataclasses.fields(jax_vi)}
    p = jax_vi.jwt_parts
    jwt_str = f"{p.header}.{p.payload}.{p.signature}"
    return VerifiedInput(**dict(fields, jwt=DecodedJWT.from_b64(jwt_str), jwt_parts=JwtParts.from_b64(jwt_str)))


def _assert_same_signals(vi, jvi):
    signals, pub = derive_circuit_input_signals(default_circuit_config(), vi)
    jsignals, jpub = jax_derive(jax_default_config(), jvi)
    assert pub == jpub
    assert signals.to_json_dict() == jsignals.to_json_dict()
    return pub


@pytest.mark.parametrize("case", sorted(JWTS))
def test_signals_match_jax(case):
    tj = make_test_jwt(seed=2, **JWTS[case])
    _assert_same_signals(tj.vi, jax_verified_input(tj.vi))


def test_golden_jwt_signals_match_jax():
    jvi = _test_verified_input()
    vi = _port_vi(jvi)
    assert compute_public_inputs_hash(default_circuit_config(), vi) == GOLDEN_HASH
    assert _assert_same_signals(vi, jvi) == GOLDEN_HASH


@pytest.mark.parametrize("inputs,digest", POSEIDON)
def test_poseidon_circomlib_vectors(inputs, digest):
    assert poseidon_hash(inputs) == digest == jax_poseidon_hash(inputs)


def test_generator_signature_verifies_under_cryptography():
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    tj = make_test_jwt(seed=3, uid_key="email", uid_val="a@b.io")
    key = tj.rsa_key
    assert key.n.bit_length() == 2048 and key.e == 65537
    assert tj.vi.pubkey_modulus == key.n
    unsigned, _, sig = tj.jwt_str.rpartition(".")
    public = rsa.RSAPublicNumbers(key.e, key.n).public_key()
    public.verify(b64url_decode(sig), unsigned.encode(), padding.PKCS1v15(), hashes.SHA256())
    with pytest.raises(InvalidSignature):
        public.verify(b64url_decode(sig), unsigned.encode() + b"x", padding.PKCS1v15(), hashes.SHA256())


def test_generator_is_seeded():
    rsa_key.cache_clear()
    first = make_test_jwt(seed=4)
    rsa_key.cache_clear()
    again = make_test_jwt(seed=4)
    assert (first.rsa_key, first.jwt_str) == (again.rsa_key, again.jwt_str)
    other = make_test_jwt(seed=5)
    assert other.rsa_key.n != first.rsa_key.n
    assert other.jwt_str.rpartition(".")[0] == first.jwt_str.rpartition(".")[0]
