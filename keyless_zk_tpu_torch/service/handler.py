"""HTTP request routing.

Mirror of prover-service/src/request_handler/handler.rs:19-32, 209-264:
CORS/OPTIONS handling and the five endpoints
  POST /v0/prove   GET /about   GET /config   GET /healthcheck
  GET /cached/jwk
with 400/500 mapping per error.rs:8-22 and per-request latency metrics.
Every POST /v0/prove gets a request id, unique in the process and rising,
that goes to the state's handle_prove and into the log context; a 500
logs one ERROR line with the id and the traceback.

A jax-free copy of keyless_zk_tpu/service/handler.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time
import traceback

from ..utils.logging import log_event, with_context
from .metrics import JWT_ATTRIBUTE_SIZES, REQUEST_HANDLING_SECONDS
from .types import BadRequest, InternalError, error_response

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type",
}

_BUILD_INFO_CACHE: dict | None = None
# per process, so that the ids of every state's requests in one log differ
_REQUEST_IDS = itertools.count(1)


def _build_info() -> dict:
    """Build metadata for /about (aptos-build-info analog)."""
    global _BUILD_INFO_CACHE
    if _BUILD_INFO_CACHE is None:
        import subprocess

        info = {"build_package": "keyless-zk-tpu-torch", "build_version": "0.1.0"}
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=5,
                cwd=__file__.rsplit("/", 3)[0],
            ).stdout.strip()
            if commit:
                info["build_commit_hash"] = commit
        except Exception:
            pass
        _BUILD_INFO_CACHE = info
    return _BUILD_INFO_CACHE


def handle_request(state, method: str, path: str, body: bytes) -> tuple[int, dict, dict]:
    """Returns (status, headers, json_payload)."""
    t0 = time.monotonic()
    endpoint = path if path in ("/v0/prove", "/about", "/config", "/healthcheck", "/cached/jwk") else "invalid"
    request_id = next(_REQUEST_IDS) if method == "POST" and path == "/v0/prove" else None
    with with_context(request_id=request_id) if request_id is not None else contextlib.nullcontext():
        try:
            status, payload = _route(state, method, path, body, request_id)
        except BadRequest as e:
            status, payload = 400, error_response(str(e))
        except Exception as e:  # noqa: BLE001 — never crash the server loop
            status = 500
            payload = error_response(str(e) if isinstance(e, InternalError) else f"unexpected error: {e}")
            _log_failure(method, path, e)
    REQUEST_HANDLING_SECONDS.observe(
        time.monotonic() - t0, endpoint=endpoint, method=method, code=str(status)
    )
    return status, dict(CORS_HEADERS), payload


def _log_failure(method: str, path: str, e: Exception) -> None:
    """The ERROR line of a request answered 500 (inside the request's log
    context, so it carries the request id)."""
    log_event("request failed", level="ERROR", method=method, path=path, error_type=type(e).__name__,
              error=str(e), traceback=traceback.format_exc())


def _route(state, method: str, path: str, body: bytes, request_id: int | None = None) -> tuple[int, dict]:
    if method == "OPTIONS":
        return 200, {}
    if method == "POST" and path == "/v0/prove":
        if body:
            try:
                jwt_len = len(json.loads(body).get("jwt_b64", ""))
                JWT_ATTRIBUTE_SIZES.observe(jwt_len, attribute="jwt_b64")
            except Exception:
                pass
        return 200, state.handle_prove(body, request_id)
    if method == "GET" and path == "/healthcheck":
        ok, why = state.healthy() if hasattr(state, "healthy") else (True, "ok")
        return (200, {"status": "ok"}) if ok else (503, {"status": "unhealthy", "reason": why})
    if method == "GET" and path == "/about":
        # deployment_information.rs:12-60: build info + TW pubkey
        return 200, {
            **_build_info(),
            **state.deployment_info,
            "training_wheels_public_key": state.tw_keypair.pk.hex(),
        }
    if method == "GET" and path == "/config":
        cfg = state.config
        return 200, {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    if method == "GET" and path == "/cached/jwk":
        return 200, state.jwk_cache.snapshot()
    return 404, error_response(f"no handler for {method} {path}")
