"""JWT decomposition (header/payload/signature, base64url segments).

Mirror of keyless-common/src/input_processing/jwt.rs: `JwtParts` keeps the
raw b64u segments (the circuit consumes the *undecoded* bytes), `DecodedJWT`
holds the parsed claims the validation path needs.

A jax-free copy of keyless_zk_tpu/input_processing/jwt.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass


def b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def b64url_encode(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


@dataclass
class JwtParts:
    header: str
    payload: str
    signature: str

    @classmethod
    def from_b64(cls, s: str) -> "JwtParts":
        parts = s.split(".")
        if len(parts) != 3:
            raise ValueError("JWT did not parse correctly")
        return cls(header=parts[0], payload=parts[1], signature=parts[2])

    def unsigned_undecoded(self) -> str:
        return self.header + "." + self.payload

    def header_undecoded_with_dot(self) -> str:
        return self.header + "."

    def payload_undecoded(self) -> str:
        return self.payload

    def header_decoded(self) -> str:
        return b64url_decode(self.header).decode()

    def payload_decoded(self) -> str:
        return b64url_decode(self.payload).decode()

    def signature_int(self) -> int:
        # JWT signatures are big-endian byte strings (jwt.rs:12-19)
        return int.from_bytes(b64url_decode(self.signature), "big")


@dataclass
class JwtHeader:
    kid: str


@dataclass
class JwtPayload:
    iss: str
    iat: int
    nonce: str
    aud: str
    sub: str | None = None
    email: str | None = None
    email_verified: bool | None = None
    exp: int | None = None


@dataclass
class DecodedJWT:
    header: JwtHeader
    payload: JwtPayload
    signature: int

    @classmethod
    def from_b64(cls, s: str) -> "DecodedJWT":
        parts = JwtParts.from_b64(s)
        hdr = json.loads(b64url_decode(parts.header))
        pl = json.loads(b64url_decode(parts.payload))
        return cls(
            header=JwtHeader(kid=hdr["kid"]),
            payload=JwtPayload(
                iss=pl["iss"],
                iat=int(pl["iat"]),
                nonce=str(pl["nonce"]),
                aud=pl["aud"],
                sub=pl.get("sub"),
                email=pl.get("email"),
                email_verified=pl.get("email_verified"),
                exp=pl.get("exp"),
            ),
            signature=parts.signature_int(),
        )


def payload_with_padding(unsigned_jwt_with_padding: bytes) -> bytes:
    """Bytes after the first '.' of the SHA-padded unsigned JWT (jwt.rs:163-182)."""
    dot = unsigned_jwt_with_padding.index(b".")
    return unsigned_jwt_with_padding[dot + 1 :]
