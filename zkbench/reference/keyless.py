"""The keyless statement of a prove request, worked out from the request
itself: its public-inputs hash and its nonce.

Written from the Aptos Keyless definitions (aptos-crypto
poseidon_bn254::keyless, prover-service public_inputs_hash.rs and
training_wheels.rs): strings are packed 31 bytes to a scalar,
little-endian, zero-padded to the circuit's maximum length, with the
length appended, and hashed with circomlib's Poseidon; the RSA modulus is
packed 24 bytes to a scalar with its byte length. It reads the JWT with
the standard library's base64 and json, and imports nothing of the
program.
"""

from __future__ import annotations

import base64
import json

from .poseidon import poseidon_hash

BYTES_PER_SCALAR = 31
EPK_SCALARS = 3
MAX_AUD_VAL_BYTES = 115  # aptos-types IdCommitment::MAX_AUD_VAL_BYTES
RSA_MODULUS_BYTES = 256


def _b64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def pack(data: bytes, max_bytes: int) -> list[int]:
    """Zero-pad to max_bytes, 31 bytes per scalar little-endian, then the
    length."""
    if len(data) > max_bytes:
        raise ValueError(f"{len(data)} bytes exceed the maximum {max_bytes}")
    padded = data + bytes(max_bytes - len(data))
    return [int.from_bytes(padded[i:i + BYTES_PER_SCALAR], "little")
            for i in range(0, max_bytes, BYTES_PER_SCALAR)] + [len(data)]


def hash_string(s: str, max_bytes: int) -> int:
    return poseidon_hash(pack(s.encode(), max_bytes))


def modulus_scalar(n: int) -> int:
    le = n.to_bytes(RSA_MODULUS_BYTES, "little")
    return poseidon_hash([int.from_bytes(le[i:i + 24], "little") for i in range(0, RSA_MODULUS_BYTES, 24)]
                         + [RSA_MODULUS_BYTES])


def nonce(exp_date_secs: int, epk: bytes, epk_blinder: int) -> int:
    """The nonce a JWT commits to: Poseidon(epk scalars, epk length,
    expiry, blinder)."""
    return poseidon_hash(pack(epk, EPK_SCALARS * BYTES_PER_SCALAR) + [exp_date_secs, epk_blinder])


def public_inputs_hash(request: dict, modulus: int, max_lengths: dict, max_committed_epk_bytes: int) -> int:
    """The one public input of the keyless circuit for a POST /v0/prove
    body, under the issuer key `modulus` and the circuit's maximum
    lengths. Requests with an `extra_field` are not handled (the
    benchmark's traffic sends none)."""
    if request.get("extra_field") is not None:
        raise NotImplementedError("the reference does not parse an extra field")
    header_b64, payload_b64, _ = request["jwt_b64"].split(".")
    payload = json.loads(_b64url(payload_b64))
    epk = bytes.fromhex(request["epk"].removeprefix("0x"))
    pepper = int.from_bytes(bytes.fromhex(request["pepper"].removeprefix("0x")), "little")
    idc_aud = request.get("idc_aud")
    uid_key = request["uid_key"]
    if request.get("skip_aud_checks"):
        if idc_aud is not None:
            raise ValueError("aud-less mode has no aud override")
        private_aud = ""
    else:
        private_aud = idc_aud if idc_aud is not None else payload["aud"]
    override_aud = payload["aud"] if idc_aud is not None else ""

    epk_frs = pack(epk, max_committed_epk_bytes)
    idc = poseidon_hash([
        pepper,
        hash_string(private_aud, max_lengths["private_aud_value"]),
        hash_string(str(payload[uid_key]), max_lengths["uid_value"]),
        hash_string(uid_key, max_lengths["uid_name"]),
    ])
    return poseidon_hash([
        *epk_frs[:EPK_SCALARS], epk_frs[-1],
        idc,
        int(request["exp_date_secs"]),
        int(request["exp_horizon_secs"]),
        hash_string(payload["iss"], max_lengths["iss_value"]),
        0,  # no extra field
        hash_string(" ", max_lengths["extra_field"]),
        hash_string(header_b64 + ".", max_lengths["b64u_jwt_header_w_dot"]),
        modulus_scalar(modulus),
        hash_string(override_aud, MAX_AUD_VAL_BYTES),
        int(idc_aud is not None),
    ])
