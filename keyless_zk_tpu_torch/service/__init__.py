"""Prover service: the HTTP API layer of the stack.

A jax-free copy of keyless_zk_tpu.service, the native replacement for the
reference's Rust prover-service (prover-service/src/): the same five
endpoints (`/v0/prove`, `/about`, `/config`, `/healthcheck`,
`/cached/jwk` — request_handler/handler.rs:19-32), the same request and
response JSON (types.rs:24-57), training-wheels validation and Ed25519
signing (training_wheels.rs), JWK refresh loops (jwk_fetcher.rs), and
Prometheus metrics on a dedicated port (metrics.rs).

The proving backend is this package's Groth16 prover on the card and its
compiled witness engine.
"""
