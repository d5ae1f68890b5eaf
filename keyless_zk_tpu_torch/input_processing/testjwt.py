"""Seeded test JWTs for the keyless circuit, signed without a crypto package.

The counterpart of the JAX package's test fixture (tests/jwt_fixture.py,
`make_test_jwt`), which signs with the `cryptography` package. Here the
RSA-2048 key comes from a seeded `random.Random`: two 1024-bit Miller-Rabin
primes and e = 65537. The JWT is signed with PKCS#1 v1.5 over SHA-256: the
DigestInfo prefix and the digest, padded, then pow(m, d, n). The same seed
gives the same key, and the same arguments the same JWT; the nonce commits
to a fixed test ephemeral key, as in the fixture.
"""

from __future__ import annotations

import functools
import hashlib
import json
import random
from dataclasses import dataclass

from .hashing import compute_nonce
from .jwt import DecodedJWT, JwtParts, b64url_encode
from .types import VerifiedInput

EPK_BYTES = bytes([0x00, 0x20]) + bytes(range(32))  # fake BCS ed25519 epk
EPK_BLINDER = 42
PEPPER = 76
EXP_DATE = 1700005000
EXP_HORIZON = 10_000_000
IAT = 1700000000

E = 65537
MODULUS_BITS = 2048
# DER prefix of DigestInfo{sha256, digest} (RFC 8017 section 9.2, note 1)
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_SMALL_PRIMES = [p for p in range(3, 2000, 2) if all(p % d for d in range(3, int(p**0.5) + 1, 2))]


@dataclass(frozen=True)
class RsaKey:
    n: int
    e: int
    d: int


@dataclass
class TestJwt:
    vi: VerifiedInput
    rsa_key: RsaKey
    jwt_str: str


def _probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    """Miller-Rabin with `rounds` random bases, after trial division."""
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(rng: random.Random, bits: int) -> int:
    """A random `bits`-bit prime p with its top two bits set (so a product
    of two has 2 * bits bits) and gcd(p - 1, E) == 1."""
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (c - 1) % E and _probable_prime(c, rng):
            return c


@functools.lru_cache(maxsize=8)
def rsa_key(seed: int) -> RsaKey:
    """The RSA-2048 key of `seed` (e = 65537)."""
    rng = random.Random(seed)
    while True:
        p, q = _prime(rng, MODULUS_BITS // 2), _prime(rng, MODULUS_BITS // 2)
        if p != q:
            break
    return RsaKey(n=p * q, e=E, d=pow(E, -1, (p - 1) * (q - 1)))


def sign_pkcs1_sha256(key: RsaKey, message: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 signature of `message` with SHA-256."""
    k = (key.n.bit_length() + 7) // 8
    t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), key.d, key.n).to_bytes(k, "big")


def make_test_jwt(
    seed: int = 0,
    iss: str = "test.oidc.provider",
    aud: str = "test-aud",
    uid_key: str = "sub",
    uid_val: str = "user-1",
    extra_field: str | None = None,
    kid: str = "test-kid-01",
    payload_extras: dict | None = None,
    idc_aud: str | None = None,
    skip_aud_checks: bool = False,
) -> TestJwt:
    """An RS256 JWT signed by `rsa_key(seed)`, with the fixture's payload:
    iss, aud, the uid, iat and a nonce over the test ephemeral key (and
    email_verified for an email uid), plus `payload_extras`."""
    nonce = compute_nonce(EXP_DATE, EPK_BYTES, EPK_BLINDER)
    payload = {
        "iss": iss,
        "aud": aud,
        uid_key: uid_val,
        "iat": IAT,
        "nonce": str(nonce),
    }
    if uid_key == "email":
        payload["email_verified"] = True
    if payload_extras:
        payload.update(payload_extras)

    header_json = json.dumps({"alg": "RS256", "typ": "JWT", "kid": kid}, separators=(",", ":"))
    payload_json = json.dumps(payload, separators=(",", ":"))
    unsigned = b64url_encode(header_json.encode()) + "." + b64url_encode(payload_json.encode())

    key = rsa_key(seed)
    jwt_str = unsigned + "." + b64url_encode(sign_pkcs1_sha256(key, unsigned.encode()))

    vi = VerifiedInput(
        jwt=DecodedJWT.from_b64(jwt_str),
        jwt_parts=JwtParts.from_b64(jwt_str),
        pubkey_modulus=key.n,
        epk_bytes=EPK_BYTES,
        epk_blinder_fr=EPK_BLINDER,
        exp_date_secs=EXP_DATE,
        exp_horizon_secs=EXP_HORIZON,
        pepper_fr=PEPPER,
        uid_key=uid_key,
        uid_val=uid_val,
        extra_field=extra_field,
        idc_aud=idc_aud,
        skip_aud_checks=skip_aud_checks,
    )
    return TestJwt(vi=vi, rsa_key=key, jwt_str=jwt_str)


def prove_request(tj: TestJwt) -> dict:
    """The POST /v0/prove body (the service's RequestInput JSON) that asks
    for a proof of `tj` under the fixture's ephemeral key, pepper and
    expiry."""
    vi = tj.vi
    body = {
        "jwt_b64": tj.jwt_str,
        "epk": vi.epk_bytes.hex(),
        "epk_blinder": vi.epk_blinder_fr.to_bytes(31, "little").hex(),
        "exp_date_secs": vi.exp_date_secs,
        "exp_horizon_secs": vi.exp_horizon_secs,
        "pepper": vi.pepper_fr.to_bytes(31, "little").hex(),
        "uid_key": vi.uid_key,
        "skip_aud_checks": vi.skip_aud_checks,
    }
    if vi.extra_field is not None:
        body["extra_field"] = vi.extra_field
    if vi.idc_aud is not None:
        body["idc_aud"] = vi.idc_aud
    return body
