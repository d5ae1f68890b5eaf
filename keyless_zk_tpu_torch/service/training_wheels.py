"""Training-wheels validation and signing.

Mirror of prover-service/src/request_handler/training_wheels.rs: before
proving, the service re-checks the whole public statement itself — JWT
RS256 signature (:171-178), expiry-horizon and iat-not-in-future
(:98-113), nonce recomputation via Poseidon (:30-49, :115-123), uid
extraction (:125-149) — then Ed25519-signs the (proof, statement) pair
(:155-222) so the chain can reject proofs from a compromised prover.

A jax-free copy of keyless_zk_tpu/service/training_wheels.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass

from ..input_processing.hashing import compute_nonce
from ..input_processing.jwt import DecodedJWT, JwtParts, b64url_decode
from ..input_processing.types import VerifiedInput
from ..utils import ed25519
from .jwk import JwkCache, RsaJwk
from .types import BadRequest, RequestInput

# PKCS#1 v1.5 SHA-256 DigestInfo DER prefix
_DER_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


def verify_rs256(jwk: RsaJwk, signing_input: bytes, signature: int) -> bool:
    """RS256 verification against the issuer JWK (training_wheels.rs:171-178)."""
    em = pow(signature, jwk.e, jwk.n).to_bytes(256, "big")
    digest = hashlib.sha256(signing_input).digest()
    expected = b"\x00\x01" + b"\xff" * (256 - 3 - len(_DER_PREFIX) - 32) + b"\x00" + _DER_PREFIX + digest
    return em == expected


@dataclass
class TrainingWheelsKeyPair:
    """Ed25519 keypair (prover_state.rs:116-149)."""

    sk: bytes
    pk: bytes

    @classmethod
    def from_sk_hex(cls, sk_hex: str) -> "TrainingWheelsKeyPair":
        sk = bytes.fromhex(sk_hex.removeprefix("0x"))
        return cls(sk=sk, pk=ed25519.public_key(sk))

    def sign(self, message: bytes) -> bytes:
        return ed25519.sign(self.sk, message)

    def verify(self, message: bytes, sig: bytes) -> bool:
        return ed25519.verify(self.pk, message, sig)


def proof_and_statement_bytes(proof_json: dict, public_inputs_hash: int) -> bytes:
    """The exact Ed25519 message the reference's TW key signs: the
    aptos-crypto domain-separation seed followed by
    bcs(Groth16ProofAndStatement) (training_wheels.rs:155-169; see
    service/bcs.py for the byte layout)."""
    from .bcs import proof_and_statement_signing_message

    return proof_and_statement_signing_message(proof_json, public_inputs_hash)


def preprocess_and_validate_request(
    req: RequestInput,
    jwk_cache: JwkCache,
    get_federated_jwk=None,
    max_exp_horizon_secs: int = 100_255_944,  # aptos-types default
    now_secs: int | None = None,
) -> VerifiedInput:
    """Full request validation -> VerifiedInput (training_wheels.rs:80-153)."""
    now = int(time.time()) if now_secs is None else now_secs

    try:
        jwt = DecodedJWT.from_b64(req.jwt_b64)
        parts = JwtParts.from_b64(req.jwt_b64)
    except Exception as e:
        raise BadRequest(f"JWT did not parse: {e}") from e

    # JWK lookup: cache first, then federated on-demand (tw.rs:52-75)
    jwk = jwk_cache.get(jwt.payload.iss, jwt.header.kid)
    if jwk is None and get_federated_jwk is not None:
        jwk = get_federated_jwk(jwt.payload.iss, jwt.header.kid)
    if jwk is None:
        raise BadRequest(f"unknown JWK for issuer {jwt.payload.iss} kid {jwt.header.kid}")

    if not verify_rs256(jwk, parts.unsigned_undecoded().encode(), jwt.signature):
        raise BadRequest("JWT signature verification failed")

    # freshness checks (training_wheels.rs:98-113)
    if req.exp_horizon_secs <= 0 or req.exp_horizon_secs > max_exp_horizon_secs:
        raise BadRequest("exp_horizon_secs out of range")
    if jwt.payload.iat > now + 60:
        raise BadRequest("JWT iat is in the future")
    if req.exp_date_secs >= jwt.payload.iat + req.exp_horizon_secs:
        raise BadRequest("exp_date_secs exceeds the expiration horizon")

    epk_bytes = bytes.fromhex(req.epk.removeprefix("0x"))
    epk_blinder = int.from_bytes(bytes.fromhex(req.epk_blinder.removeprefix("0x")), "little")
    pepper = int.from_bytes(bytes.fromhex(req.pepper.removeprefix("0x")), "little")

    # nonce recomputation (training_wheels.rs:115-123)
    expected_nonce = compute_nonce(req.exp_date_secs, epk_bytes, epk_blinder)
    if str(expected_nonce) != jwt.payload.nonce:
        raise BadRequest("nonce doesn't match")

    # uid extraction (training_wheels.rs:125-149)
    payload = json.loads(b64url_decode(parts.payload))
    if req.uid_key not in ("sub", "email"):
        raise BadRequest(f"unsupported uid key {req.uid_key}")
    uid_val = payload.get(req.uid_key)
    if uid_val is None:
        raise BadRequest(f"JWT has no {req.uid_key} claim")
    if req.uid_key == "email" and payload.get("email_verified") not in (True, "true"):
        raise BadRequest("email_verified is not true")

    return VerifiedInput(
        jwt=jwt,
        jwt_parts=parts,
        pubkey_modulus=jwk.n,
        epk_bytes=epk_bytes,
        epk_blinder_fr=epk_blinder,
        exp_date_secs=req.exp_date_secs,
        exp_horizon_secs=req.exp_horizon_secs,
        pepper_fr=pepper,
        uid_key=req.uid_key,
        uid_val=str(uid_val),
        extra_field=req.extra_field,
        idc_aud=req.aud_override,
        skip_aud_checks=req.skip_aud_checks,
    )
