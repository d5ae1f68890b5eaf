"""Prover-service API types.

Mirror of prover-service/src/request_handler/types.rs: `RequestInput`
(:24-40), `ProverServiceResponse` success/error (:43-57), and the proof
JSON encoding contract.

A jax-free copy of keyless_zk_tpu/service/types.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RequestInput:
    """POST /v0/prove body (types.rs:24-40)."""

    jwt_b64: str
    epk: str  # hex BCS-serialized EphemeralPublicKey
    epk_blinder: str  # hex
    exp_date_secs: int
    exp_horizon_secs: int
    pepper: str  # hex
    uid_key: str
    extra_field: str | None = None
    aud_override: str | None = None  # named idc_aud in newer reference versions
    skip_aud_checks: bool = False

    @classmethod
    def from_json_dict(cls, d: dict) -> "RequestInput":
        try:
            return cls(
                jwt_b64=d["jwt_b64"],
                epk=d["epk"],
                epk_blinder=d["epk_blinder"],
                exp_date_secs=int(d["exp_date_secs"]),
                exp_horizon_secs=int(d["exp_horizon_secs"]),
                pepper=d["pepper"],
                uid_key=d["uid_key"],
                extra_field=d.get("extra_field"),
                aud_override=d.get("idc_aud") or d.get("aud_override"),
                skip_aud_checks=bool(d.get("skip_aud_checks", False)),
            )
        except KeyError as e:
            raise BadRequest(f"missing field {e}") from e


class BadRequest(Exception):
    """-> 400 (error.rs:8-22)."""


class InternalError(Exception):
    """-> 500."""


def success_response(
    proof_json: dict, public_inputs_hash: int, training_wheels_signature_hex: str
) -> dict:
    """ProverServiceResponse::Success (types.rs:43-57), reference wire shape:
    `proof` is the aptos-types Groth16Proof (ark-compressed point byte
    arrays, serde's JSON form), `public_inputs_hash` is the hex of the Fr
    value's 32 little-endian bytes (PoseidonHash with #[serde(with="hex")]),
    `training_wheels_signature` is hex of bcs(EphemeralSignature)."""
    from .bcs import groth16_proof_bcs

    blob = groth16_proof_bcs(proof_json)
    return {
        "proof": {
            "a": list(blob[:32]),
            "b": list(blob[32:96]),
            "c": list(blob[96:128]),
        },
        "public_inputs_hash": (public_inputs_hash % (1 << 256)).to_bytes(32, "little").hex(),
        "training_wheels_signature": training_wheels_signature_hex,
    }


def error_response(message: str) -> dict:
    return {"error": message}
