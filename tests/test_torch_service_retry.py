"""The service's re-verify retry (service/prover_state.py `handle_prove`)
against the JAX service's (keyless_zk_tpu/service/prover_state.py): a
proof that fails its pairing check counts `verify_failed` and is proven
once more, through the BatchProver with `batch_proving` and under the
prover's lock otherwise; the request answers 200 if the second proof
verifies and 500 if it fails too.

The device work is a stand-in whose k-th proof has the points k * G, and
the pairing check is patched to fail a given number of times, so each case
runs in well under a second; the pipeline around them (request validation,
input signals, response, training-wheels signature) is the real one, on a
test JWT from the port's seeded generator, in both packages."""

import json
import re

import numpy as np
import pytest

from keyless_zk_tpu.groth16 import pairing as jax_pairing
from keyless_zk_tpu.groth16.prover import Proof as JaxProof
from keyless_zk_tpu.parallel.batch_prover import BatchProver as JaxBatchProver
from keyless_zk_tpu.service import handler as jax_handler
from keyless_zk_tpu.service import metrics as jax_metrics
from keyless_zk_tpu_torch.curves import ref_curve
from keyless_zk_tpu_torch.groth16.prover import Proof
from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt, prove_request
from keyless_zk_tpu_torch.parallel.batch_prover import BatchProver
from keyless_zk_tpu_torch.service import handler, metrics, prover_state
from keyless_zk_tpu_torch.tooling import onchain_vk
from test_torch_service import states


class StandInProver:
    """Counts its proofs; the k-th has the points k * G1, k * G2, k * G1."""

    def __init__(self, proof_cls):
        self.proof_cls, self.calls, self.phase_ms = proof_cls, 0, {}

    def prove(self, witness_limbs):
        self.calls += 1
        g1 = ref_curve.G1.mul(ref_curve.G1_GEN, self.calls)
        return self.proof_cls(g1, ref_curve.G2.mul(ref_curve.G2_GEN, self.calls), g1)


class StandInProgram:
    """A witness program that skips the circuit."""

    def compute_witness(self, **kw):
        return np.zeros(4, dtype=np.uint64)

    def check_witness(self, w):
        return None

    def witness_limbs(self, w):
        return np.zeros((4, 16), dtype=np.uint16)


def failing_verify(fails: int):
    """A pairing check that answers False `fails` times, then True."""
    seen = []

    def verify(vk, public, proof_json):
        seen.append(proof_json)
        return len(seen) > fails

    return verify, seen


def outcomes(metrics_module) -> dict:
    """PROOFS_TOTAL per outcome, read from the exposition text."""
    text = metrics_module.PROOFS_TOTAL.expose()
    return {k: int(v) for k, v in re.findall(r'outcome="([a-z_]+)"\} (\d+)', text)}


def _run(state, handler_module, metrics_module, prover, batch_cls):
    state.prover, state.witness_prog, state.vk = prover, StandInProgram(), {}
    if batch_cls is not None:
        bp = batch_cls(prover, max_batch=1)  # the JAX one pads a batch to max_batch
        bp.prove_batch = lambda ws: [prover.prove(w) for w in ws]
        state.batch_prover, state.prove_lock = bp, None  # the batched path takes no lock
    before = outcomes(metrics_module)
    try:
        status, _, payload = handler_module.handle_request(state, "POST", "/v0/prove", state.request_body)
    finally:
        if batch_cls is not None:
            state.batch_prover.shutdown()
    after = outcomes(metrics_module)
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in ("verify_failed", "success")}
    return status, payload, delta


@pytest.mark.parametrize("fails", [1, 2], ids=["fails_once", "fails_twice"])
@pytest.mark.parametrize("batched", [False, True], ids=["lock", "batch_proving"])
def test_verify_failure_retried_once_as_jax(monkeypatch, fails, batched):
    tj = make_test_jwt(seed=8, kid="k8")
    mine, theirs = states(tj)
    mine.request_body = theirs.request_body = json.dumps(prove_request(tj)).encode()
    verify, seen = failing_verify(fails)
    monkeypatch.setattr(prover_state, "verify_groth16", verify)
    jax_verify, jax_seen = failing_verify(fails)
    monkeypatch.setattr(jax_pairing, "verify_groth16", jax_verify)

    prover, jax_prover = StandInProver(Proof), StandInProver(JaxProof)
    status, payload, delta = _run(mine, handler, metrics, prover, BatchProver if batched else None)
    j_status, j_payload, j_delta = _run(theirs, jax_handler, jax_metrics, jax_prover,
                                        JaxBatchProver if batched else None)

    assert (status, delta, prover.calls) == (j_status, j_delta, jax_prover.calls)
    assert prover.calls == 2 and len(seen) == 2
    assert seen[0] != seen[1]  # the second check is of the second proof
    if fails == 1:
        assert status == 200 and delta == {"verify_failed": 1, "success": 1}
        assert payload == j_payload
        a = onchain_vk.decompress_g1(bytes(payload["proof"]["a"]))
        assert a == ref_curve.G1.mul(ref_curve.G1_GEN, 2)  # the answer is the second proof
        assert mine.breakdowns[-1]["batch_size"] == 1
    else:
        assert status == 500 and delta == {"verify_failed": 2, "success": 0}
        assert payload == j_payload and payload == {"error": "generated proof failed verification"}
