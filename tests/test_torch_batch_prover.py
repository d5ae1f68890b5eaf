"""The port's BatchProver (parallel/batch_prover.py) and the pipeline it
hands each batch (groth16/prover.py `Groth16Prover.prove_batch`) against
the JAX package's, on an in-repo setup: the chain circuit a == b^101
(domain 128) with pinned toxic values, as tests/test_parallel.py builds
it.

- `prove_batch` of three witnesses equals the JAX BatchProver's proofs
  with r and s drawn from the same sequence in both packages, and equals
  the port's single prove of the same witness, r and s, and its
  `prove_batch` of that one witness; every proof verifies, and a proof
  checked against another element's public input does not.
- `prove` and a batch of two upload each witness through the prover
  module's `_limbs` and blind each proof through its `blind`, the names
  the benchmark's host spans wrap.
- The queue: three threads through `prove()` that arrive while a batch is
  in flight coalesce into one batch of three (no padding to `max_batch`),
  each waiter gets its own witness's result, and an error reaches every
  waiter of its batch. These run a stand-in `prove_batch`: the queue is
  what they test."""

import threading
import types

import pytest
import torch

from keyless_zk_tpu.circuits import ConstraintSystem, groth16_setup
from keyless_zk_tpu.circuits.r1cs_file import r1cs_from_cs
from keyless_zk_tpu.fields import bn254
from keyless_zk_tpu.groth16 import Groth16Prover as JaxProver
from keyless_zk_tpu.parallel import batch_prover as jax_batch_prover
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key, prover, verify_groth16
from keyless_zk_tpu_torch.parallel import batch_prover

torch.set_num_threads(1)

TOXIC = {"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6}
BASES = (3, 5, 7)


def chain_setup():
    """a == b^101 (101 constraints, domain 128): the JAX setup, and the
    witnesses and public inputs for b in BASES."""
    cs = ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    x = b
    for _ in range(100):
        x = cs.mul(cs.lc(x), cs.lc(b))
    cs.constrain_eq(cs.lc(x), cs.lc(a))
    res = groth16_setup(r1cs_from_cs(cs), toxic=TOXIC)
    wits, publics = [], []
    for bv in BASES:
        w = cs.compute_witness(a=pow(bv, 101, bn254.R_SCALAR), b=bv)
        assert cs.check_witness(w) is None
        wits.append(cs.witness_np(w))
        publics.append([w[a]])
    return res, wits, publics


def _sequence(monkeypatch, module):
    vals = iter(range(7, 7 + 2 * len(BASES)))
    monkeypatch.setattr(module, "_sample_fr", lambda: next(vals))


def test_prove_batch_equals_jax_and_single_prove(monkeypatch):
    res, wits, publics = chain_setup()
    _sequence(monkeypatch, jax_batch_prover)
    jax_bp = jax_batch_prover.BatchProver(JaxProver(res.pk), max_batch=4)
    try:
        want = jax_bp.prove_batch(wits)
    finally:
        jax_bp.shutdown()

    port = Groth16Prover(from_jax_proving_key(res.pk), device="cpu")
    _sequence(monkeypatch, prover)
    bp = batch_prover.BatchProver(port, max_batch=4)
    try:
        got = bp.prove_batch(wits)
    finally:
        bp.shutdown()
    assert [p.to_json_dict() for p in got] == [p.to_json_dict() for p in want]
    assert bp.last_h.shape == (len(BASES), 128, 16)

    # element 1 drew r = 9, s = 10
    single = port.prove(wits[1], r=9, s=10)
    assert single.to_json_dict() == got[1].to_json_dict()
    assert port.prove_batch([wits[1]], [(9, 10)])[0].to_json_dict() == got[1].to_json_dict()
    for proof, pub in zip(got, publics):
        assert verify_groth16(res.vk, pub, proof.to_json_dict())
    assert not verify_groth16(res.vk, publics[1], got[0].to_json_dict())


def test_pipeline_uploads_and_blinds_through_the_module_names(monkeypatch):
    res, wits, _ = chain_setup()
    port = Groth16Prover(from_jax_proving_key(res.pk), device="cpu")
    calls = []
    for name in ("_limbs", "blind"):
        real = getattr(prover, name)
        monkeypatch.setattr(prover, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    port.prove(wits[0])
    bp = batch_prover.BatchProver(port, max_batch=2)
    try:
        proofs = bp.prove_batch(wits[1:])
    finally:
        bp.shutdown()
    assert calls == ["_limbs", "blind"] + ["_limbs"] * 2 + ["blind"] * 2
    assert len(proofs) == 2 and set(bp.phase_ms) >= {"blind"}
    with pytest.raises(ValueError, match="1 \\(r, s\\) pairs for 2 witnesses"):
        port.prove_batch(wits[1:], [(9, 10)])


class _Gate:
    """A stand-in prove_batch: the first batch waits until `queued` more
    requests sit in the queue, then every batch returns ("proof", witness)
    per witness, or raises `error`."""

    def __init__(self, bp, queued, error=None):
        self.bp, self.queued, self.error = bp, queued, error
        self.seen = []

    def __call__(self, witnesses):
        self.seen.append(list(witnesses))
        if len(self.seen) == 1:
            while self.bp._queue.qsize() < self.queued:
                threading.Event().wait(0.01)
        if self.error is not None:
            raise self.error
        return [("proof", w) for w in witnesses]


def _run_threads(bp, items):
    results, errors = {}, {}

    def call(i):
        try:
            results[i] = bp.prove(items[i], timeout=60)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(items))]
    threads[0].start()
    while not bp.batch_sizes:  # the first request is in flight
        threading.Event().wait(0.01)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def test_requests_in_flight_coalesce_into_one_batch():
    bp = batch_prover.BatchProver(types.SimpleNamespace(), max_batch=8)
    gate = _Gate(bp, queued=3)
    bp.prove_batch = gate
    try:
        results, errors = _run_threads(bp, ["w0", "w1", "w2", "w3"])
    finally:
        bp.shutdown()
    assert not errors
    assert list(bp.batch_sizes) == [1, 3]  # one batch of three, not padded to max_batch
    assert [len(ws) for ws in gate.seen] == [1, 3]
    assert results == {i: ("proof", f"w{i}") for i in range(4)}


def test_error_reaches_every_waiter():
    bp = batch_prover.BatchProver(types.SimpleNamespace(), max_batch=8)
    boom = RuntimeError("device fault")
    bp.prove_batch = _Gate(bp, queued=2, error=boom)
    try:
        results, errors = _run_threads(bp, ["w0", "w1", "w2"])
    finally:
        bp.shutdown()
    assert not results and set(errors) == {0, 1, 2}
    assert all(e is boom for e in errors.values())
    with pytest.raises(ValueError, match="max_batch"):
        batch_prover.BatchProver(types.SimpleNamespace(), max_batch=0)
