"""Witness generation: evaluate the keyless relation's dataflow.

Replaces the reference's circom-generated witness binaries (`main_c` /
wasm witness calculator, invoked as a subprocess per request:
prover-service/src/request_handler/prover_handler.rs:541-572) with native
evaluation of the circuit's semantics (SHA-256, base64url, RSA bigint,
Poseidon, field parsing) — see SURVEY §2.2 "External native artifacts".

A jax-free copy of keyless_zk_tpu/witness/__init__.py: the port imports
nothing of the JAX package.
"""
