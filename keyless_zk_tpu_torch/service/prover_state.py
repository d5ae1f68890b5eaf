"""Shared prover service state + the prove pipeline.

Mirror of prover-service/src/request_handler/prover_state.rs (state init)
and prover_handler.rs (the prove pipeline with its 9 instrumented phases).
Differences from the reference are deliberate:

- witness generation is in-process (the compiled witness engine,
  circuits/witness_engine.py), not a forked circom binary
  (prover_handler.rs:516-527);
- the prover is this package's Groth16 prover, its key resident on the
  card (or on `device`); requests queue through a lock the same way the
  reference's `Mutex<Option<FullProver>>` does (prover_state.rs:21), or,
  with `batch_proving`, through a BatchProver (parallel/batch_prover.py),
  where requests that arrive together are proven as one batch and no
  lock is taken.

A jax-free copy of keyless_zk_tpu/service/prover_state.py, with one
difference: a failed witness-engine build is an error (no Python witness
path is taken instead). As there, a proof that fails its verification is
proven once more before the request answers 500.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import threading
import time
from dataclasses import dataclass, field

from .. import device as devices
from ..circuits.keyless_circuit import (
    KeylessConfig,
    build_keyless_circuit,
    to_circuit_config,
    witness_kwargs,
)
from ..circuits.r1cs_file import r1cs_from_cs
from ..circuits.setup import groth16_setup
from ..circuits.witness_engine import CompiledWitnessProgram
from ..groth16 import pairing_native
from ..groth16.pairing import verify_groth16
from ..groth16.prover import Groth16Prover
from ..groth16.zkey import load_zkey
from ..input_processing.input_signals import derive_circuit_input_signals
from ..parallel.batch_prover import BatchProver
from ..tooling.setup_tool import circuit_checksum, procure
from ..utils.logging import Span, log_event
from .bcs import ephemeral_signature_bcs
from .config import ProverServiceConfig
from .jwk import JwkCache, JwkFetcher
from .metrics import (
    PAIRING_BACKEND,
    PROOFS_TOTAL,
    PROVE_BREAKDOWN_SECONDS,
    PROVE_PHASES,
    PROVE_QUEUE_WAIT_SECONDS,
)
from .training_wheels import (
    TrainingWheelsKeyPair,
    preprocess_and_validate_request,
    proof_and_statement_bytes,
)
from .types import BadRequest, InternalError, RequestInput, success_response

@dataclass
class ProverServiceState:
    config: ProverServiceConfig
    circuit_config: object
    keyless_config: KeylessConfig | None
    tw_keypair: TrainingWheelsKeyPair
    jwk_cache: JwkCache
    jwk_fetcher: JwkFetcher | None = None
    # proving backend (None for endpoint-only testing,
    # prover_state.rs:53-78 `new_for_testing`)
    witness_prog: CompiledWitnessProgram | None = None
    prover: Groth16Prover | None = None
    batch_prover: BatchProver | None = None  # with config.batch_proving
    vk: dict | None = None
    device: object = devices.DEFAULT
    prove_lock: threading.Lock = field(default_factory=threading.Lock)
    deployment_info: dict = field(default_factory=dict)
    pairing_backend: str | None = None
    # seconds of each start-up step of init_prover_from_native_setup
    startup_s: dict = field(default_factory=dict)
    # per answered request: its id, the nine phases' ms, its spans and the
    # prover's own phase ms
    breakdowns: collections.deque = field(default_factory=lambda: collections.deque(maxlen=64))

    @classmethod
    def new_for_testing(
        cls,
        keyless_config: KeylessConfig | None = None,
        tw_sk_hex: str = "11" * 32,
        with_prover: bool = False,
        jwk_fetch=None,
        device=devices.DEFAULT,
    ) -> "ProverServiceState":
        cfg = ProverServiceConfig()
        kc = keyless_config or KeylessConfig()
        state = cls(
            config=cfg,
            circuit_config=to_circuit_config(kc),
            keyless_config=kc,
            tw_keypair=TrainingWheelsKeyPair.from_sk_hex(tw_sk_hex),
            jwk_cache=JwkCache(),
            device=device,
        )
        if jwk_fetch is not None:
            state.jwk_fetcher = JwkFetcher(state.jwk_cache, fetch=jwk_fetch)
        if with_prover:
            state.init_prover_from_native_setup()
        return state

    def init_prover_from_native_setup(self, rng=None, persist: bool = False) -> None:
        """Build the keyless circuit and run the native 1-party setup
        (replaces zkey procurement, scripts/python/setups/testing_setup.py).

        With persist=True the setup goes through the content-addressed
        store (tooling/setup_tool.py, under config.resources_dir) and is
        reloaded from its zkey on later starts. A warm start (the setup is
        complete and its `witness_program.npz` is there) reloads the
        compiled witness program (the analog of circom's prebuilt main_c,
        testing_setup.py:72-79) and skips circuit construction; debug-check
        mode still builds the circuit, since the R1CS re-check needs the
        constraints. Each step's seconds go into `startup_s`."""
        self.config.check_supported()
        t = time.perf_counter()

        def step(name):
            nonlocal t
            now = time.perf_counter()
            self.startup_s[name] = now - t
            t = now

        if persist:
            root = self.config.resources_dir
            setup_dir = os.path.join(root, circuit_checksum(self.keyless_config))
            prog_path = os.path.join(setup_dir, "witness_program.npz")
            warm = (
                os.path.exists(os.path.join(setup_dir, ".complete"))
                and os.path.exists(prog_path)
                and not self.config.enable_debug_checks
            )
            self.startup_s["warm"] = warm
            if warm:
                self.witness_prog = CompiledWitnessProgram.load(prog_path)
                step("witness_program_load")
                procure(self.keyless_config, root=root, device=self.device)  # refresh the default slot
            else:
                cs = build_keyless_circuit(self.keyless_config)
                step("circuit_build")
                self.witness_prog = CompiledWitnessProgram(cs)
                step("witness_program_compile")
                setup_dir = procure(self.keyless_config, root=root, cs=cs, device=self.device)
                step("procure")
                self.witness_prog.save(prog_path)
                step("witness_program_save")
            zkey = os.path.join(setup_dir, "prover_key.zkey")
            pk = load_zkey(zkey)
            step("zkey_load")
            with open(os.path.join(setup_dir, "verification_key.json")) as f:
                self.vk = json.load(f)
        else:
            cs = build_keyless_circuit(self.keyless_config)
            step("circuit_build")
            self.witness_prog = CompiledWitnessProgram(cs)
            step("witness_program_compile")
            res = groth16_setup(r1cs_from_cs(cs), rng=rng, device=self.device)
            step("setup")
            pk, self.vk = res.pk, res.vk
        self.prover = Groth16Prover(pk, self.device)
        step("prover_construction")
        if self.config.batch_proving:
            self.batch_prover = BatchProver(self.prover, max_batch=self.config.max_batch)
        self.check_pairing_backend()

    def check_pairing_backend(self) -> str:
        """Probe which pairing implementation verify_proof will use and make
        degradation loud: a gcc-less host falls back to the pure-Python
        verifier (about half a second per proof) — log it, count it, and
        (with config.require_native_pairing) fail the healthcheck. The
        proof's blinding (groth16/prover.py `blind`) takes the same library
        and has no fallback: `Groth16Prover` raises without it."""
        backend = "native" if pairing_native.available() else "python_fallback"
        self.pairing_backend = backend
        PAIRING_BACKEND.inc(backend=backend)
        if backend != "native":
            log_event(
                "native pairing library unavailable; Groth16 verification "
                "falls back to the pure-Python tower (~10x slower), and no "
                "proof can be blinded",
                level="WARN",
                backend=backend,
                reason=pairing_native.build_error(),
            )
        return backend

    def healthy(self) -> tuple[bool, str]:
        """Liveness verdict for /healthcheck (handler.rs:107-111), extended
        with the native-pairing production guard."""
        if self.config.require_native_pairing and self.pairing_backend != "native":
            return False, f"native pairing required but backend is {self.pairing_backend}"
        return True, "ok"

    # ---- the prove pipeline (prover_handler.rs:48-152) --------------------

    def _prove_device(self, w_np, spans: list) -> tuple:
        """One proof of the witness limbs: (proof, the prover's phase ms,
        the size of the batch it rode in). Appends to `spans` the wait for
        the prover, `prove_lock_wait` (or with `batch_proving` the
        BatchProver's `batch_queue_wait`), and in the serial service the
        proof with the lock held, `prove`."""
        if self.batch_prover is not None:
            # requests that arrive together coalesce into one batch; no
            # global mutex (the limit of prover_state.rs:21 lifts here)
            info: dict = {}
            proof = self.batch_prover.prove(w_np, info=info)
            spans += info["spans"]
            _, t_put, t_drained, _ = info["spans"][0]
            PROVE_QUEUE_WAIT_SECONDS.observe(t_drained - t_put, queue="batch")
            return proof, info["phase_ms"], info["batch_size"]
        wait = Span("prove_lock_wait", log=False, into=spans,
                    observe=functools.partial(PROVE_QUEUE_WAIT_SECONDS.observe, queue="lock"))
        wait.__enter__()
        with self.prove_lock:  # prover_handler.rs:266-268
            wait.__exit__(None, None, None)  # inside the block, so the lock is released whatever this raises
            with Span("prove", log=False, into=spans):
                proof = self.prover.prove(w_np)
            return proof, dict(self.prover.phase_ms), 1

    def handle_prove(self, body: bytes, request_id: int | None = None) -> dict:
        if self.prover is None or self.witness_prog is None:
            raise InternalError("prover not initialized")

        spans: list = []  # [name, t0, t1, cpu_ms]: the nine phases and the waits and proofs inside them

        def phase(name):
            return Span(name, log=False, into=spans,
                        observe=functools.partial(PROVE_BREAKDOWN_SECONDS.observe, phase=name))

        with phase("deserialize_request"):
            try:
                req = RequestInput.from_json_dict(json.loads(body))
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                raise BadRequest(f"bad request body: {e}") from e

        with phase("validate_request"):
            vi = preprocess_and_validate_request(
                req,
                self.jwk_cache,
                self.jwk_fetcher.get_federated_jwk if self.jwk_fetcher else None,
            )

        with phase("derive_circuit_input_signals"):
            signals, public_inputs_hash = derive_circuit_input_signals(
                self.circuit_config, vi, self.config.max_committed_epk_bytes
            )

        with phase("generate_witness"):
            w64 = self.witness_prog.compute_witness(**witness_kwargs(signals))
            if self.config.enable_debug_checks:
                bad = self.witness_prog.check_witness(w64)
                if bad is not None:
                    raise InternalError(f"witness violates constraint {bad}")
            w_np = self.witness_prog.witness_limbs(w64)

        with phase("generate_proof"):
            proof, prover_phase_ms, batch_size = self._prove_device(w_np, spans)

        with phase("deserialize_proof"):
            proof_json = proof.to_json_dict()

        with phase("verify_proof"):  # defense in depth (prover_handler.rs:329-336)
            if not verify_groth16(self.vk, [public_inputs_hash], proof_json):
                # the re-verify is there to catch a transient device fault:
                # run the device work once more before failing the request
                PROOFS_TOTAL.inc(outcome="verify_failed")
                proof, prover_phase_ms, batch_size = self._prove_device(w_np, spans)
                proof_json = proof.to_json_dict()
                if not verify_groth16(self.vk, [public_inputs_hash], proof_json):
                    PROOFS_TOTAL.inc(outcome="verify_failed")
                    raise InternalError("generated proof failed verification")

        with phase("training_wheels_sign"):
            msg = proof_and_statement_bytes(proof_json, public_inputs_hash)
            tw_sig = self.tw_keypair.sign(msg)
            # verify our own signature before responding (prover_handler.rs:216-221)
            if not self.tw_keypair.verify(msg, tw_sig):
                raise InternalError("training-wheels signature self-check failed")

        with phase("build_response"):
            PROOFS_TOTAL.inc(outcome="success")
            resp = success_response(proof_json, public_inputs_hash, ephemeral_signature_bcs(tw_sig).hex())
        self.breakdowns.append({
            "request_id": request_id,
            "phases_ms": {name: (t1 - t0) * 1e3 for name, t0, t1, _ in spans if name in PROVE_PHASES},
            "spans": spans,
            "prover_phase_ms": prover_phase_ms,
            "batch_size": batch_size,
        })
        return resp
