"""Verified prove-request input.

Mirror of prover-service/src/request_handler/types.rs:64-109 (`VerifiedInput`):
everything the signal-derivation layer needs after validation.

A jax-free copy of keyless_zk_tpu/input_processing/types.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

from .jwt import DecodedJWT, JwtParts


@dataclass
class VerifiedInput:
    jwt: DecodedJWT
    jwt_parts: JwtParts
    pubkey_modulus: int  # RSA-2048 modulus of the issuer JWK
    epk_bytes: bytes  # BCS-serialized EphemeralPublicKey
    epk_blinder_fr: int
    exp_date_secs: int
    exp_horizon_secs: int
    pepper_fr: int
    uid_key: str
    uid_val: str
    extra_field: str | None = None
    idc_aud: str | None = None
    skip_aud_checks: bool = False

    def use_extra_field(self) -> bool:
        return self.extra_field is not None
