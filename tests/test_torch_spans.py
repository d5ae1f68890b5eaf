"""The prove pipeline's spans (utils/logging.py `Span`, service/
prover_state.py `handle_prove`, parallel/batch_prover.py, groth16/
prover.py `prove_batch`) and request ids
(service/handler.py):

- the wait for the prover's lock is a span apart from the proof, and the
  two add up to the request's `generate_proof` phase;
- every POST /v0/prove gets a rising request id, in its breakdown and in
  the ERROR line a 500 logs with its traceback;
- span times are time.perf_counter readings, and `cpu_ms` is the thread's
  CPU time (near the wall time when it computes, near 0 when it sleeps);
- the BatchProver hands a batch's proofs one shared `phase_ms` that holds
  the host's `blind` time, and each proof its own queue wait;
- the queue-wait histogram carries both queues.

The device work is the stand-ins of test_torch_service_retry.py and
test_torch_batch_prover.py (a counting prover, a witness program that
skips the circuit, a queue gate); the pipeline around them is the real one,
on test JWTs from the port's seeded generator. No case sleeps over 0.2 s."""

import functools
import json
import threading
import time
import types

import pytest
import torch

from keyless_zk_tpu_torch.curves.jacobian import JacPoint
from keyless_zk_tpu_torch.groth16 import prover as prover_mod
from keyless_zk_tpu_torch.groth16.prover import Groth16Prover, Proof
from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt, prove_request
from keyless_zk_tpu_torch.parallel.batch_prover import BatchProver
from keyless_zk_tpu_torch.service import handler, metrics, prover_state
from keyless_zk_tpu_torch.service.jwk import RsaJwk
from keyless_zk_tpu_torch.service.prover_state import ProverServiceState
from keyless_zk_tpu_torch.utils.logging import Span
from test_torch_batch_prover import _Gate
from test_torch_service_retry import StandInProgram, StandInProver
from torch_keyless_fixtures import SMALL

PROOF_S = 0.2
NINE = list(metrics.PROVE_PHASES)


class SlowProver(StandInProver):
    """The counting stand-in, taking PROOF_S a proof; `started` is set once
    a proof is under way."""

    def __init__(self):
        super().__init__(Proof)
        self.started = threading.Event()

    def prove(self, witness_limbs):
        self.started.set()
        time.sleep(PROOF_S)
        return super().prove(witness_limbs)


@pytest.fixture(scope="module")
def signin():
    """One test JWT (its RSA key takes a second to make) and its request
    body; the service proves the same body as often as it is sent."""
    tj = make_test_jwt(seed=20, kid="k20")
    return tj, json.dumps(prove_request(tj)).encode()


def served_state(monkeypatch, signin, prover, batched=False):
    """A port state at SMALL with the stand-in prover and witness program,
    the key of the sign-in's JWT and a pairing check that passes."""
    monkeypatch.setattr(prover_state, "verify_groth16", lambda vk, public, proof: True)
    state = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    state.prover, state.witness_prog, state.vk = prover, StandInProgram(), {}
    tj = signin[0]
    state.jwk_cache.insert(tj.vi.jwt.payload.iss, RsaJwk(kid=tj.vi.jwt.header.kid, n=tj.rsa_key.n))
    if batched:
        bp = BatchProver(prover, max_batch=1)
        bp.prove_batch = lambda ws: [prover.prove(w) for w in ws]
        state.batch_prover, state.prove_lock = bp, None  # the batched path takes no lock
    return state, signin[1]


def post(state, body):
    return handler.handle_request(state, "POST", "/v0/prove", body)


def span_s(breakdown, name):
    """Seconds of every span `name` of a request, summed."""
    return sum(t1 - t0 for n, t0, t1, _ in breakdown["spans"] if n == name)


def test_lock_wait_is_apart_from_the_proof(monkeypatch, signin):
    prover = SlowProver()
    state, body = served_state(monkeypatch, signin, prover)
    statuses = []
    first = threading.Thread(target=lambda: statuses.append(post(state, body)[0]))
    first.start()
    assert prover.started.wait(10)  # the second request arrives while the first holds the lock
    statuses.append(post(state, body)[0])
    first.join(10)
    assert not first.is_alive() and statuses == [200, 200]

    done = list(state.breakdowns)
    assert len(done) == 2
    first_b, second_b = sorted(done, key=lambda b: span_s(b, "prove_lock_wait"))
    assert span_s(second_b, "prove_lock_wait") >= 0.75 * PROOF_S
    assert span_s(first_b, "prove_lock_wait") < 0.5 * PROOF_S
    for b in done:
        assert list(b["phases_ms"]) == NINE  # the reference's nine phases, in order, and no more
        assert [n for n, *_ in b["spans"] if n not in NINE] == ["prove_lock_wait", "prove"]
        assert span_s(b, "prove") >= PROOF_S
        wait_and_proof_ms = (span_s(b, "prove_lock_wait") + span_s(b, "prove")) * 1e3
        assert abs(wait_and_proof_ms - b["phases_ms"]["generate_proof"]) < 2.0


def test_the_lock_is_released_when_the_wait_span_fails_at_its_end(monkeypatch, signin):
    state, body = served_state(monkeypatch, signin, StandInProver(Proof))

    def observe(seconds, **labels):
        raise RuntimeError("histogram fault")

    monkeypatch.setattr(prover_state, "PROVE_QUEUE_WAIT_SECONDS", types.SimpleNamespace(observe=observe))
    assert post(state, body)[:3:2] == (500, {"error": "unexpected error: histogram fault"})
    assert not state.prove_lock.locked()  # the next request is not stuck behind it


def test_request_ids_rise_and_spans_lie_inside_the_call(monkeypatch, signin):
    state, body = served_state(monkeypatch, signin, StandInProver(Proof))
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        assert post(state, body)[0] == 200
        windows.append((t0, time.perf_counter()))
    ids = [b["request_id"] for b in state.breakdowns]
    assert len(set(ids)) == 3 and ids == sorted(ids) and ids[-1] - ids[0] == 2  # one id a request, none skipped
    for b, (t0, t1) in zip(state.breakdowns, windows):
        assert all(t0 <= s0 <= s1 <= t1 and cpu >= 0 for _, s0, s1, cpu in b["spans"])
        outer = {n: (s0, s1) for n, s0, s1, _ in b["spans"]}["generate_proof"]
        inner = [s for s in b["spans"] if s[0] in ("prove_lock_wait", "prove")]
        assert len(inner) == 2 and all(outer[0] <= s0 <= s1 <= outer[1] for _, s0, s1, _ in inner)


def test_cpu_ms_counts_the_threads_work_not_its_sleep():
    spans: list = []
    with Span("busy", log=False, into=spans) as busy:
        x, end = 0, time.perf_counter() + 0.1
        while time.perf_counter() < end:
            x += 1
    with Span("asleep", log=False, into=spans) as asleep:
        time.sleep(0.1)
    assert [s[0] for s in spans] == ["busy", "asleep"]
    assert spans[0] == ["busy", busy.t0, busy.t1, busy.cpu_ms]
    busy_ms, asleep_ms = (busy.t1 - busy.t0) * 1e3, (asleep.t1 - asleep.t0) * 1e3
    assert busy_ms >= 100 and asleep_ms >= 100
    assert 0.5 * busy_ms <= busy.cpu_ms <= busy_ms + 1.0
    assert asleep.cpu_ms < 5.0


def device_stand_ins(monkeypatch):
    """A prover whose device steps are stand-ins and whose `prove_batch` is
    the real pipeline (Groth16Prover.prove_batch), so that the pipeline's
    own control flow and its host blinding tail run in milliseconds; each
    blinding takes 10 ms and returns the r and s it was given."""
    monkeypatch.setattr(prover_mod, "check_witness_limbs", lambda pk, w: torch.zeros(4, dtype=torch.int32))
    monkeypatch.setattr(prover_mod, "_limbs", lambda wl, device: wl)
    monkeypatch.setattr(prover_mod, "msm_batch",
                        lambda *a, **k: JacPoint(*(torch.zeros(a[-1].shape[0]) for _ in range(3))))
    decode = types.SimpleNamespace(decode_jacobian=lambda p: [None] * p.x.shape[0])
    monkeypatch.setattr(prover_mod, "G1_CURVE", decode)
    monkeypatch.setattr(prover_mod, "G2_CURVE", decode)
    monkeypatch.setattr(prover_mod, "blind", lambda pk, a, b1, b2, c, h, r, s: time.sleep(0.01) or (r, s))
    stand_in = types.SimpleNamespace(pk=None, device=torch.device("cpu"), _h_scalars=lambda w: w,
                                     _merge_scalars=lambda w, m: w,
                                     **{f"_merge_{t}": None for t in ("a", "b1", "b2", "c", "h")},
                                     **{f"points_{t}": () for t in ("a", "b1", "b2", "c", "h")})
    stand_in._msm = functools.partial(Groth16Prover._msm, stand_in)
    stand_in.prove_batch = functools.partial(Groth16Prover.prove_batch, stand_in)
    return stand_in


def test_batch_shares_phase_ms_with_blind_and_each_proof_has_its_queue_wait(monkeypatch):
    bp = BatchProver(device_stand_ins(monkeypatch), max_batch=8)
    gate, real = _Gate(bp, queued=2), bp.prove_batch

    def gated(ws):  # the first batch waits until two more requests sit in the queue
        gate(ws)
        return real(ws)

    bp.prove_batch = gated
    infos: dict = {i: {} for i in range(3)}
    threads = [threading.Thread(target=bp.prove, args=(f"w{i}",), kwargs={"timeout": 10, "info": infos[i]})
               for i in range(3)]
    try:
        threads[0].start()
        while not bp.batch_sizes:  # the first request is in flight
            time.sleep(0.005)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        bp.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert list(bp.batch_sizes) == [1, 2]

    alone, a, b = infos[0], infos[1], infos[2]
    assert a is not b and a["phase_ms"] is b["phase_ms"]  # one dict for the batch's proofs
    assert alone["phase_ms"] is not a["phase_ms"]
    assert a["batch_size"] == b["batch_size"] == 2
    assert a["phase_ms"]["blind"] >= 2 * 10.0  # both blindings of the batch, on the host clock
    for info in (alone, a, b):
        [(wait, w0, w1, cpu_ms)] = info["spans"]
        assert wait == "batch_queue_wait" and w0 <= w1 and 0 <= cpu_ms < 5.0  # the caller sleeps as it waits
    assert a["spans"][0][2] == b["spans"][0][2]  # drained together
    assert a["spans"][0][1] != b["spans"][0][1]  # each waited from its own put
    # the pair queued while the first batch was in flight, so they waited through its blinding
    assert min(info["spans"][0][2] - info["spans"][0][1] for info in (a, b)) > 0


def test_queue_wait_histogram_has_both_queues(monkeypatch, signin):
    for batched in (False, True):
        state, body = served_state(monkeypatch, signin, StandInProver(Proof), batched=batched)
        try:
            assert post(state, body)[0] == 200
        finally:
            if batched:
                state.batch_prover.shutdown()
        names = [n for n, *_ in state.breakdowns[-1]["spans"] if n not in NINE]
        assert names == (["batch_queue_wait"] if batched else ["prove_lock_wait", "prove"])
    text = metrics.REGISTRY.expose()
    assert "# TYPE keyless_prover_service_prove_queue_wait_seconds histogram" in text
    for queue in ("lock", "batch"):
        assert f'keyless_prover_service_prove_queue_wait_seconds_count{{queue="{queue}"}}' in text


class Boom(StandInProgram):
    def compute_witness(self, **kw):
        raise RuntimeError("witness engine fault")


FAULTS = {  # how the pipeline fails: (break the state, the answer as it always was, the exception, a frame)
    "unexpected": (lambda st: setattr(st, "witness_prog", Boom()),
                   {"error": "unexpected error: witness engine fault"}, "RuntimeError", "compute_witness"),
    "internal": (lambda st: setattr(st, "prover", None),
                 {"error": "prover not initialized"}, "InternalError", "handle_prove"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_500_logs_one_error_line_with_the_request_id_and_traceback(monkeypatch, capsys, signin, fault):
    state, body = served_state(monkeypatch, signin, StandInProver(Proof))
    prover = state.prover
    breaks, answer, error_type, frame = FAULTS[fault]
    breaks(state)
    capsys.readouterr()
    status, _, payload = post(state, body)
    assert (status, payload) == (500, answer)
    errors = [json.loads(line) for line in capsys.readouterr().err.splitlines()
              if line.startswith("{") and json.loads(line).get("level") == "ERROR"]
    assert len(errors) == 1
    line = errors[0]
    assert (line["error_type"], line["error"], line["path"]) == (error_type, answer["error"].split(": ")[-1],
                                                                 "/v0/prove")
    assert line["traceback"].startswith("Traceback") and frame in line["traceback"]
    assert int(line["request_id"]) >= 1
    assert not state.breakdowns  # only answered requests leave a breakdown

    state.prover, state.witness_prog = prover, StandInProgram()
    assert post(state, body)[0] == 200
    assert state.breakdowns[-1]["request_id"] == int(line["request_id"]) + 1
    assert "ERROR" not in capsys.readouterr().err
