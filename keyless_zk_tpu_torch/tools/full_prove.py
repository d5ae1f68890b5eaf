"""Drive the service's prove pipeline at a keyless configuration on the card.

The port's counterpart of scripts/full_prove_tpu.py: procure (or reload) a
setup for the configuration through the content-addressed store under
build/bench/setups, start a test ProverServiceState from it, and answer
`POST /v0/prove` requests for a seeded test JWT through the service's
handler, with the nine phases the reference exports
(`prove_breakdown_seconds`, metrics.rs:31-39). Every request must answer
200 with a proof that verifies under the setup's vk against the JWT's
public-inputs hash.

    python -m keyless_zk_tpu_torch.tools.full_prove [--config small|full] [--repeat N]

The reference's toy circuit (the JAX script's third configuration) is not
in this repository, so only `small` and `full` run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..bench import SETUP_ROOT, WrongResult, check_proof
from ..circuits.keyless_circuit import KeylessConfig

# The JAX package's scaled-down configuration (tests/test_keyless_circuit.py
# SMALL): structurally the full circuit with 4 SHA blocks; the aud value's
# maximum stays in [94, 124] so the circuit's chunk count matches the
# host's fixed MAX_AUD_VAL_BYTES = 115 packing (public_inputs_hash.rs).
SMALL = KeylessConfig(
    max_b64u_jwt_no_sig_len=384,
    max_b64u_jwt_header_w_dot_len=64,
    max_b64u_jwt_payload_sha2_padded_len=320,
    max_aud_kv_pair_len=128,
    max_aud_name_len=8,
    max_aud_value_len=116,
    max_iss_kv_pair_len=32,
    max_iss_name_len=8,
    max_iss_value_len=24,
    max_iat_kv_pair_len=32,
    max_iat_name_len=8,
    max_iat_value_len=24,
    max_nonce_kv_pair_len=96,
    max_nonce_name_len=8,
    max_nonce_value_len=80,
    max_ev_kv_pair_len=30,
    max_ev_name_len=20,
    max_ev_value_len=10,
    max_uid_kv_pair_len=32,
    max_uid_name_len=12,
    max_uid_value_len=24,
    max_extra_kv_pair_len=24,
)
CONFIGS = {"small": SMALL, "full": KeylessConfig()}


def started_state(config: str, root=SETUP_ROOT):
    """A test ProverServiceState for `config` whose setup store is `root`,
    started from the store (the setup procured first when it is not
    there); its `startup_s` holds each start-up step's seconds."""
    from ..service.prover_state import ProverServiceState

    state = ProverServiceState.new_for_testing(keyless_config=CONFIGS[config])
    state.config.resources_dir = str(root)
    state.init_prover_from_native_setup(persist=True)
    return state


def response_proof_json(payload: dict) -> dict:
    """A POST /v0/prove response's compressed points -> snarkjs proof JSON."""
    from ..tooling.onchain_vk import decompress_g1, decompress_g2

    a = decompress_g1(bytes(payload["proof"]["a"]))
    b = decompress_g2(bytes(payload["proof"]["b"]))
    c = decompress_g1(bytes(payload["proof"]["c"]))
    return {
        "pi_a": [str(a[0]), str(a[1]), "1"],
        "pi_b": [[str(b[0][0]), str(b[0][1])], [str(b[1][0]), str(b[1][1])], ["1", "0"]],
        "pi_c": [str(c[0]), str(c[1]), "1"],
        "protocol": "groth16",
    }


def check_response(vk: dict, status: int, payload: dict, public_inputs_hash: int, label: str) -> None:
    """A 200 whose public-inputs hash is the JWT's and whose proof verifies
    under `vk` against it."""
    if status != 200:
        raise WrongResult(f"{label}: POST /v0/prove answered {status}: {str(payload)[:200]}")
    pih = int.from_bytes(bytes.fromhex(payload["public_inputs_hash"]), "little")
    if pih != public_inputs_hash:
        raise WrongResult(f"{label}: the response's public-inputs hash is not the JWT's")
    try:
        proof = response_proof_json(payload)
    except ValueError as e:
        raise WrongResult(f"{label}: the response's proof does not decode: {e}") from e
    check_proof(vk, [pih], proof, label)


def run_full_prove(config: str = "small", repeat: int = 2, root=SETUP_ROOT) -> dict:
    """Procure/load the setup, serve `repeat` prove requests, check each,
    return timings: {"status", "config", "prove_ms" (warm: the least of
    the requests after the first), "cold_ms", "samples_ms", "phases"
    {name: ms} (the last request's), "n_vars", "domain_size", "setup_ms",
    "startup_s", "zkey_bytes"}."""
    from ..input_processing.public_inputs_hash import compute_public_inputs_hash
    from ..input_processing.testjwt import make_test_jwt, prove_request
    from ..service.handler import handle_request
    from ..service.jwk import RsaJwk
    from ..service.metrics import PROVE_BREAKDOWN_SECONDS

    t0 = time.monotonic()
    state = started_state(config, root)
    t1 = time.monotonic()
    print(f"setup: {t1 - t0:.1f}s (n_vars={state.prover.pk.n_vars}, domain={state.prover.pk.domain_size}), "
          f"steps {state.startup_s}", file=sys.stderr)

    tj = make_test_jwt()
    state.jwk_cache.insert(tj.vi.jwt.payload.iss, RsaJwk(kid=tj.vi.jwt.header.kid, n=tj.rsa_key.n))
    pih = compute_public_inputs_hash(state.circuit_config, tj.vi, state.config.max_committed_epk_bytes)
    body = json.dumps(prove_request(tj)).encode()

    times = []
    phases = {}
    for i in range(max(repeat, 1)):
        before = PROVE_BREAKDOWN_SECONDS.sums()
        t2 = time.monotonic()
        code, _, payload = handle_request(state, "POST", "/v0/prove", body)
        t3 = time.monotonic()
        check_response(state.vk, code, payload, pih, f"prove request {i}")
        times.append(t3 - t2)
        after = PROVE_BREAKDOWN_SECONDS.sums()
        phases = {k[0]: round((v - before.get(k, 0.0)) * 1e3, 1) for k, v in after.items()}
        print(f"prove request {i}: {t3 - t2:.1f}s  OK, verifies  {phases}", file=sys.stderr)

    zkey_path = os.path.join(state.config.resources_dir, "default", "prover_key.zkey")
    return {
        "status": "ok",
        "config": config,
        "cold_ms": round(times[0] * 1e3, 1),
        "prove_ms": round(min(times[1:] or times) * 1e3, 1),
        "samples_ms": [round(t * 1e3, 1) for t in times],
        "phases": phases,
        "n_vars": state.prover.pk.n_vars,
        "domain_size": state.prover.pk.domain_size,
        "setup_ms": round((t1 - t0) * 1e3, 1),
        "startup_s": {k: (round(v, 2) if isinstance(v, float) else v) for k, v in state.startup_s.items()},
        "zkey_bytes": os.path.getsize(zkey_path) if os.path.exists(zkey_path) else None,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="small", choices=sorted(CONFIGS))
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    res = run_full_prove(config=args.config, repeat=args.repeat)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
