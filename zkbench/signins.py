"""The one traffic generator: seeded Aptos Keyless sign-ins and their
arrival times, from a traffic file's parameters.

Each sign-in is a POST /v0/prove body for a distinct RS256 JWT from one
test OIDC provider: its own `sub`, ephemeral public key, blinder, pepper,
iat and expiry, and a nonce that commits to them, signed by the
provider's RSA-2048 key. The key comes from the traffic file's
`key_seed` (the same key in every run, so set-up does the same work);
everything else comes from the run's seed. The sizes (the lengths of the
uids and the gaps between arrivals) are one fixed set drawn from the
traffic file's `shape_seed`, which each run's seed only reorders: two
seeds send the same work in another order.

Written for the benchmark after keyless_zk_tpu_torch/input_processing/
testjwt.py (PKCS#1 v1.5 over SHA-256, Miller-Rabin primes); it imports
nothing of the program.
"""

from __future__ import annotations

import base64
import hashlib
import json
import random
import string
from dataclasses import dataclass

from .reference.keyless import nonce

E = 65537
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_SMALL_PRIMES = [p for p in range(3, 2000, 2) if all(p % d for d in range(3, int(p**0.5) + 1, 2))]
FR_BYTES = 31  # blinder and pepper: 31 little-endian bytes, below the field's order


@dataclass(frozen=True)
class RsaKey:
    n: int
    p: int
    q: int
    d: int

    def sign(self, message: bytes) -> bytes:
        """RSASSA-PKCS1-v1_5 with SHA-256, by the Chinese remainder theorem."""
        k = (self.n.bit_length() + 7) // 8
        t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
        m = int.from_bytes(b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t, "big")
        sp = pow(m, self.d % (self.p - 1), self.p)
        sq = pow(m, self.d % (self.q - 1), self.q)
        s = sq + self.q * ((sp - sq) * pow(self.q, -1, self.p) % self.p)
        return s.to_bytes(k, "big")


def _probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
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


def rsa_key(seed: int, bits: int = 2048) -> RsaKey:
    """The provider's RSA key of `seed` (e = 65537)."""
    rng = random.Random(seed)

    def prime():
        while True:
            c = rng.getrandbits(bits // 2) | (3 << (bits // 2 - 2)) | 1
            if (c - 1) % E and _probable_prime(c, rng):
                return c

    p, q = prime(), prime()
    while q == p:
        q = prime()
    return RsaKey(n=p * q, p=p, q=q, d=pow(E, -1, (p - 1) * (q - 1)))


def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


class SignIns:
    """Sign-in requests of one run: `key` is the provider's, `jwk` what the
    service preloads, `make(rng, uid_len)` one request body."""

    def __init__(self, traffic: dict):
        jwt = traffic["jwt"]
        self.iss, self.kid, self.auds = jwt["iss"], jwt["kid"], jwt["auds"]
        self.uid_lens = tuple(jwt["uid_len"])
        self.iat, self.horizon = jwt["iat"], jwt["exp_horizon_secs"]
        self.key = rsa_key(traffic["key_seed"])
        self.jwk = {"iss": self.iss, "kid": self.kid, "n": self.key.n}

    def make(self, rng: random.Random, uid_len: int) -> dict:
        uid = "".join(rng.choices(string.ascii_letters + string.digits, k=uid_len))
        epk = bytes([0x00, 0x20]) + rng.randbytes(32)  # BCS of an Ed25519 public key
        blinder = int.from_bytes(rng.randbytes(FR_BYTES), "little")
        pepper = int.from_bytes(rng.randbytes(FR_BYTES), "little")
        iat = self.iat + rng.randrange(86_400)
        exp_date = iat + rng.randrange(3_600, self.horizon)
        header = {"alg": "RS256", "typ": "JWT", "kid": self.kid}
        payload = {"iss": self.iss, "aud": rng.choice(self.auds), "sub": uid, "iat": iat,
                   "nonce": str(nonce(exp_date, epk, blinder))}
        unsigned = _b64url(json.dumps(header, separators=(",", ":")).encode()) + "." + \
            _b64url(json.dumps(payload, separators=(",", ":")).encode())
        return {
            "jwt_b64": unsigned + "." + _b64url(self.key.sign(unsigned.encode())),
            "epk": epk.hex(),
            "epk_blinder": blinder.to_bytes(FR_BYTES, "little").hex(),
            "exp_date_secs": exp_date,
            "exp_horizon_secs": self.horizon,
            "pepper": pepper.to_bytes(FR_BYTES, "little").hex(),
            "uid_key": "sub",
            "skip_aud_checks": False,
        }

    def batch(self, seed: int, count: int, shape_seed: int, salt: str) -> list[dict]:
        """`count` requests: uid lengths from the fixed set of `shape_seed`,
        in the order and with the contents of `seed`. `salt` keeps the
        warm-up's requests apart from the window's."""
        lens = random.Random(shape_seed).choices(range(self.uid_lens[0], self.uid_lens[1] + 1), k=count)
        rng = random.Random(f"{salt}:{seed}")
        rng.shuffle(lens)
        return [self.make(rng, n) for n in lens]


def tampered(request: dict) -> dict:
    """The request with its JWT signature altered: the service must refuse it."""
    head, body, sig = request["jwt_b64"].split(".")
    flipped = ("B" if sig[10] == "A" else "A")
    return {**request, "jwt_b64": f"{head}.{body}.{sig[:10]}{flipped}{sig[11:]}"}


def arrivals(traffic: dict, seed: int, seconds: float) -> list[float]:
    """Due times in [0, seconds) of an open loop at the traffic's
    `rate_per_s`: round(rate x seconds) unit-rate exponential gaps from the
    fixed set of `shape_seed`, in the order of `seed`, scaled so that
    they fill the window exactly."""
    rate = traffic["rate_per_s"]
    count = max(1, int(round(rate * seconds)))
    shape = random.Random(traffic["shape_seed"])
    gaps = [shape.expovariate(1.0) for _ in range(count)]
    random.Random(f"arrivals:{seed}").shuffle(gaps)
    scale = seconds / sum(gaps)
    out, u = [], 0.0
    for g in gaps:
        out.append(u)
        u += g * scale
    return out
