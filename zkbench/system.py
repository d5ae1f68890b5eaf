"""The system under test: keyless_zk_tpu_torch's prover service, started
from a configuration file. The only module of the benchmark that imports
the program; it takes from it the service, its spans and its counters.

The setup store is the service's own (`init_prover_from_native_setup(
persist=True)`), rooted at `zkbench/cache/setups` in the checkout: a
cell's first run builds the circuit, compiles the witness program and
procures the key there; every later run starts warm from it.
"""

from __future__ import annotations

import collections
import functools
import importlib
import json
import threading
import time
from pathlib import Path

PACKAGE = "keyless_zk_tpu_torch"


def import_program(root: Path):
    """The program's package, refused unless it is the checkout's own."""
    pkg = importlib.import_module(PACKAGE)
    where = Path(pkg.__file__).resolve()
    if not where.is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{PACKAGE} was imported from {where}, outside the checkout {root}")
    return pkg


class System:
    """One prover service on `device`, configured by the configuration
    file's `service` and `circuit` entries."""

    def __init__(self, config: dict, cache_dir: Path, tw_sk: bytes, device: str = "cuda"):
        from keyless_zk_tpu_torch.circuits.keyless_circuit import KeylessConfig, to_circuit_config
        from keyless_zk_tpu_torch.service.config import ProverServiceConfig
        from keyless_zk_tpu_torch.service.jwk import JwkCache
        from keyless_zk_tpu_torch.service.prover_state import ProverServiceState
        from keyless_zk_tpu_torch.service.training_wheels import TrainingWheelsKeyPair

        kc = KeylessConfig(**config["circuit"]["keyless_config"])
        svc = ProverServiceConfig(**config["service"])
        svc.resources_dir = str(Path(cache_dir) / "setups")
        svc.check_supported()
        self.state = ProverServiceState(
            config=svc,
            circuit_config=to_circuit_config(kc),
            keyless_config=kc,
            tw_keypair=TrainingWheelsKeyPair.from_sk_hex(tw_sk.hex()),
            jwk_cache=JwkCache(),
            device=device,
        )
        self.server = None
        self._serve_thread = None

    # ---- set-up ------------------------------------------------------------

    def start(self) -> None:
        """The service's start from its setup store (cold on the first run
        in a checkout); every request's breakdown is kept from here on."""
        self.state.init_prover_from_native_setup(persist=True)
        self.state.breakdowns = collections.deque()

    @property
    def startup_s(self) -> dict:
        return dict(self.state.startup_s)

    @property
    def setup_dir(self) -> Path:
        """The setup the service loaded (the store's `default` slot)."""
        return Path(self.state.config.resources_dir) / "default"

    def verification_key(self) -> dict:
        return json.loads((self.setup_dir / "verification_key.json").read_text())

    def add_jwk(self, jwk: dict) -> None:
        from keyless_zk_tpu_torch.service.jwk import RsaJwk

        self.state.jwk_cache.insert(jwk["iss"], RsaJwk(kid=jwk["kid"], n=jwk["n"]))

    def serve(self) -> int:
        """Serve POST /v0/prove on 127.0.0.1 at a port the OS picks."""
        from keyless_zk_tpu_torch.service.server import start_prover_service

        self.server = start_prover_service(self.state, 0, host="127.0.0.1")
        self._serve_thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._serve_thread.start()
        return self.server.server_address[1]

    def witness(self, request: dict):
        """The witness limbs of a prove request, by the service's own path
        from a request to its witness (validation, input signals, the
        compiled witness program)."""
        from keyless_zk_tpu_torch.circuits.keyless_circuit import witness_kwargs
        from keyless_zk_tpu_torch.input_processing.input_signals import derive_circuit_input_signals
        from keyless_zk_tpu_torch.service.training_wheels import preprocess_and_validate_request
        from keyless_zk_tpu_torch.service.types import RequestInput

        st = self.state
        vi = preprocess_and_validate_request(RequestInput.from_json_dict(request), st.jwk_cache)
        signals, _ = derive_circuit_input_signals(st.circuit_config, vi, st.config.max_committed_epk_bytes)
        return st.witness_prog.witness_limbs(st.witness_prog.compute_witness(**witness_kwargs(signals)))

    def prove_batched(self, witness, timeout: float) -> tuple:
        """One proof through the service's BatchProver: ((a, b, c) affine
        points as plain ints, the batch's info {batch_size, phase_ms})."""
        info: dict = {}
        proof = self.state.batch_prover.prove(witness, timeout=timeout, info=info)
        return (proof.pi_a, proof.pi_b, proof.pi_c), info

    # ---- what the window leaves ---------------------------------------------

    def breakdowns(self) -> list[dict]:
        return list(self.state.breakdowns)

    def clear_breakdowns(self) -> None:
        self.state.breakdowns.clear()

    def zkey_path(self) -> Path:
        return self.setup_dir / "prover_key.zkey"

    def close(self) -> None:
        """Stop serving, stop the batch worker, and drop the prover."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._serve_thread.join(timeout=30)
            self.server = None
        if self.state.batch_prover is not None:
            self.state.batch_prover.shutdown()
        self.state.batch_prover = None
        self.state.prover = None
        self.state.witness_prog = None

    # ---- spans for a traced run ------------------------------------------------

    def instrument(self, record) -> None:
        """Wrap the calls into each layer with `record(name, t0, t1)` host
        spans: the witness, its limbs, input signals, upload, decode,
        blinding and the verify. A call the program no longer has is
        skipped."""
        st = self.state

        def wrap(owner, attr, name):
            fn = getattr(owner, attr, None)
            if fn is None:
                return

            @functools.wraps(fn)
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    record(name, t0, time.perf_counter())

            setattr(owner, attr, timed)

        wrap(st.witness_prog, "compute_witness", "witness")
        wrap(st.witness_prog, "witness_limbs", "witness_limbs")
        mods = {m: importlib.import_module(f"{PACKAGE}.{m}") for m in
                ("service.prover_state", "groth16.prover", "parallel.batch_prover", "curves.jacobian")}
        wrap(mods["service.prover_state"], "derive_circuit_input_signals", "input_signals")
        wrap(mods["service.prover_state"], "verify_groth16", "verify")
        for m in ("groth16.prover", "parallel.batch_prover"):
            wrap(mods[m], "_limbs", "upload")
            wrap(mods[m], "blind", "blind")
        for curve in ("G1_CURVE", "G2_CURVE"):
            wrap(getattr(mods["curves.jacobian"], curve, None), "decode_jacobian", "decode")
        wrap(st.tw_keypair, "sign", "tw_sign")
