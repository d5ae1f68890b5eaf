"""JWK cache and refresh loops.

Mirror of prover-service/src/external_resources/jwk_fetcher.rs /
jwk_types.rs: per-issuer background refresh threads populating a shared
cache (:174-270), plus federated-issuer resolution (Auth0/Cognito URL
patterns, :103-137).  The HTTP fetch function is injectable so tests (and
the zero-egress environment) use static key sets — the reference's
MockFederatedJWKIssuer plays the same role (tests/federated_jwk.rs:17-55).

A jax-free copy of keyless_zk_tpu/service/jwk.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import base64
import json
import re
import threading
import time
from dataclasses import dataclass

from .metrics import JWK_FETCH_SECONDS


@dataclass
class RsaJwk:
    kid: str
    n: int  # modulus
    e: int = 65537
    alg: str = "RS256"

    @classmethod
    def from_json_dict(cls, d: dict) -> "RsaJwk":
        def b64u_int(s: str) -> int:
            pad = "=" * (-len(s) % 4)
            return int.from_bytes(base64.urlsafe_b64decode(s + pad), "big")

        return cls(
            kid=d["kid"],
            n=b64u_int(d["n"]),
            e=b64u_int(d.get("e", "AQAB")),
            alg=d.get("alg", "RS256"),
        )


class JwkCache:
    """issuer -> kid -> RsaJwk, thread-safe (jwk_fetcher.rs JWKCache)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._keys: dict[str, dict[str, RsaJwk]] = {}

    def get(self, issuer: str, kid: str) -> RsaJwk | None:
        with self._lock:
            return self._keys.get(issuer, {}).get(kid)

    def put_issuer(self, issuer: str, jwks: dict[str, RsaJwk]) -> None:
        with self._lock:
            self._keys[issuer] = dict(jwks)

    def insert(self, issuer: str, jwk: RsaJwk) -> None:
        with self._lock:
            self._keys.setdefault(issuer, {})[jwk.kid] = jwk

    def snapshot(self) -> dict:
        with self._lock:
            return {
                iss: {kid: {"kid": k.kid, "alg": k.alg} for kid, k in kids.items()}
                for iss, kids in self._keys.items()
            }


def parse_jwks_json(body: str) -> dict[str, RsaJwk]:
    keys = json.loads(body).get("keys", [])
    out = {}
    for k in keys:
        if k.get("kty") == "RSA" or "n" in k:
            jwk = RsaJwk.from_json_dict(k)
            out[jwk.kid] = jwk
    return out


def default_http_fetch(url: str) -> str:
    """Plain urllib fetch; swapped out in tests / airgapped deployments."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:  # noqa: S310
        return r.read().decode()


# federated issuer patterns (jwk_fetcher.rs:103-137)
_FEDERATED_PATTERNS = [
    (re.compile(r"^https://[a-zA-Z0-9-]+\.us\.auth0\.com/?$"), "{iss}.well-known/jwks.json"),
    (
        re.compile(r"^https://cognito-idp\.[a-zA-Z0-9-]+\.amazonaws\.com/[^/]+/?$"),
        "{iss}/.well-known/jwks.json",
    ),
]


def federated_jwks_url(issuer: str) -> str | None:
    for pattern, template in _FEDERATED_PATTERNS:
        if pattern.match(issuer):
            iss = issuer if issuer.endswith("/") else issuer + "/"
            return template.format(iss=iss)
    return None


class JwkFetcher:
    """Background refresh loops (jwk_fetcher.rs:174-270)."""

    def __init__(self, cache: JwkCache, fetch=default_http_fetch, refresh_secs: int = 10):
        self.cache = cache
        self.fetch = fetch
        self.refresh_secs = refresh_secs
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self, providers: list[dict]) -> None:
        for p in providers:
            t = threading.Thread(
                target=self._loop, args=(p["iss"], p["endpoint_url"]), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _loop(self, issuer: str, url: str) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                jwks = parse_jwks_json(self.fetch(url))
                self.cache.put_issuer(issuer, jwks)
                JWK_FETCH_SECONDS.observe(
                    time.monotonic() - t0, issuer=issuer, succeeded="true"
                )
            except Exception:
                JWK_FETCH_SECONDS.observe(
                    time.monotonic() - t0, issuer=issuer, succeeded="false"
                )
            self._stop.wait(self.refresh_secs)

    def get_federated_jwk(self, issuer: str, kid: str) -> RsaJwk | None:
        """On-demand fetch for federated issuers (jwk_fetcher.rs:103-137)."""
        url = federated_jwks_url(issuer)
        if url is None:
            return None
        try:
            jwks = parse_jwks_json(self.fetch(url))
        except Exception:
            return None
        for k in jwks.values():
            self.cache.insert(issuer, k)
        return jwks.get(kid)

    def stop(self) -> None:
        self._stop.set()
